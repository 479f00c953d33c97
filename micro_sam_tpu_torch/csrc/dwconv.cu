// Depthwise 3x3 convolution, stride 1, zero padding 1, over a channel-last
// (B, H, W, C) map, with a per-channel scale and shift (a folded BatchNorm)
// and an optional exact-erf GELU applied in the same pass:
//
//   y[b, i, j, c] = act(round((sum_{di, dj} x[b, i + di, j + dj, c] w[c, di, dj]) * s[c] + t[c]))
//
// Replaces the depthwise stages inside the TPU kernels
// micro_sam_tpu/ops/fused_mbconv.py::_mbconv_kernel (gelu(bn2(dw3x3(h))) over
// the MBConv's 4C hidden map) and ops/fused_tiny_tail.py::_tiny_tail_kernel
// (the block tail's bn(dw3x3(x))). x and y are in the working type (bf16 or
// f32), w is the (C, 1, 3, 3) f32 conv weight, s / t f32; the sum is f32 and
// y is rounded where the plain composition stores: once after the BN, once
// after the GELU.
//
// Bound on the H100: bytes. 18 flops per output against one element read and
// one written: the MBConv's hidden map at 1024^2 (256 x 256 x 256 bf16) is
// 33.5 MB in and 33.5 MB out, 20 us at 3.35 TB/s against 0.3 GFLOP. One
// thread computes VEC neighbouring channels of one pixel (16 bytes: 8 bf16 or
// 4 f32) from nine 16-byte loads; neighbouring threads hold neighbouring
// channels, then neighbouring pixels, so every load is coalesced and the
// eight re-reads of each input element hit L1 / L2, not device memory.
// Every H, W and C is taken: VEC falls to 1 when C or an address does not
// allow 16-byte vectors.
#include "common.cuh"

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(float out[VEC], const T* p) {
  if constexpr (VEC * sizeof(T) == 16) {
    __align__(16) T buf[VEC];
    *reinterpret_cast<uint4*>(buf) = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = to_f32(buf[e]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = to_f32(p[e]);
  }
}

template <typename T, int VEC, bool GELU>
__global__ void __launch_bounds__(256) dwconv3x3_kernel(
    const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ scale,
    const float* __restrict__ shift, T* __restrict__ y, int H, int W, int C,
    long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int CV = C / VEC;
  const int c0 = (int)(i % CV) * VEC;
  const long long pix = i / CV;
  const int col = (int)(pix % W);
  const long long rowb = pix / W;  // b * H + row
  const int row = (int)(rowb % H);
  const T* img = x + (rowb - row) * W * (long long)C;  // image b

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
  for (int di = 0; di < 3; ++di) {
    const int r = row + di - 1;
    if (r < 0 || r >= H) continue;
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      const int c = col + dj - 1;
      if (c < 0 || c >= W) continue;
      float v[VEC];
      load_vec<T, VEC>(v, img + ((long long)r * W + c) * C + c0);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(v[e], __ldg(w + (c0 + e) * 9 + di * 3 + dj), acc[e]);
    }
  }

  __align__(16) T out[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    float v = round_to<T>(acc[e] * __ldg(scale + c0 + e) + __ldg(shift + c0 + e));
    if constexpr (GELU) v = gelu_erf(v);
    out[e] = from_f32<T>(v);
  }
  T* dst = y + pix * C + c0;
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(out);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[e] = out[e];
  }
}

template <typename T, int VEC>
static void launch(const void* x, const void* w, const void* s, const void* t, void* y, int B,
                   int H, int W, int C, int gelu, cudaStream_t st) {
  const long long total = (long long)B * H * W * (C / VEC);
  const unsigned blocks = (unsigned)((total + 255) / 256);
  if (gelu)
    dwconv3x3_kernel<T, VEC, true><<<blocks, 256, 0, st>>>(
        (const T*)x, (const float*)w, (const float*)s, (const float*)t, (T*)y, H, W, C, total);
  else
    dwconv3x3_kernel<T, VEC, false><<<blocks, 256, 0, st>>>(
        (const T*)x, (const float*)w, (const float*)s, (const float*)t, (T*)y, H, W, C, total);
}

MSAM_EXPORT int msam_dwconv(const void* x, const void* w, const void* scale, const void* shift,
                            void* y, int B, int H, int W, int C, int gelu, int dtype,
                            void* stream) {
  if (B < 0 || H < 0 || W < 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  if (dtype == MSAM_BF16) {
    if (aligned && C % 8 == 0)
      launch<__nv_bfloat16, 8>(x, w, scale, shift, y, B, H, W, C, gelu, st);
    else
      launch<__nv_bfloat16, 1>(x, w, scale, shift, y, B, H, W, C, gelu, st);
  } else if (dtype == MSAM_F32) {
    if (aligned && C % 4 == 0)
      launch<float, 4>(x, w, scale, shift, y, B, H, W, C, gelu, st);
    else
      launch<float, 1>(x, w, scale, shift, y, B, H, W, C, gelu, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

MSAM_ERROR_STRING(msam_dwconv)
