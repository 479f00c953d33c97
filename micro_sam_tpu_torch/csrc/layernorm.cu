// Row LayerNorm with an optional per-row multiply (the window pad mask).
//
// Replaces the LN1 / LN2 stages inside the TPU kernels
// micro_sam_tpu/ops/fused_window_block.py::_fused_block_kernel and
// ::_fused_global_kernel. y = ((x - mean) * rsqrt(var + eps) * gamma + beta),
// statistics in f32, rounded to the working type, then multiplied by valid[row]
// when a mask is given (models/image_encoder.py window_block_masked). In the
// grid mode (the spatial window kernel, _fused_block_kernel(spatial=)) the
// rows are those of padded (B, Hp, Wp) maps and the mask is computed from the
// row's position instead of read: row (b, y, x) is valid when y < H and x < W.
// The mode is a template parameter (GRID), so the other launches carry no
// branch on it.
//
// Bound on the H100: bytes. At vit_b (4900 x 768 bf16) it reads 7.5 MB and
// writes 7.5 MB, about 4.5 us at 3.35 TB/s, against 4 flops per element. The
// design reads each row from device memory once: one warp owns one row and
// keeps it in registers (up to 1536 columns) across the mean, the variance and
// the write, so the only traffic is x in and y out.
#include "common.cuh"

constexpr int kMaxPerLane = 48;  // 48 * 32 = 1536 columns
constexpr int kRowsPerBlock = 8;

template <typename T, bool GRID>
__global__ void __launch_bounds__(256) layernorm_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ valid,
    T* __restrict__ y, int rows, int cols, float eps, int4 map) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * cols;
  float v[kMaxPerLane];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    int c = lane + i * 32;
    v[i] = (c < cols) ? to_f32(xr[c]) : 0.f;
    sum += v[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mean = sum / cols;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    int c = lane + i * 32;
    float d = (c < cols) ? v[i] - mean : 0.f;
    sq += d * d;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rstd = rsqrtf(sq / cols + eps);
  float m;
  if constexpr (GRID) {  // map: (Hp, Wp, H, W)
    const int px = row % map.y, py = (row / map.y) % map.x;
    m = (py < map.z && px < map.w) ? 1.f : 0.f;
  } else {
    m = valid ? valid[row] : 1.f;
  }
  T* yr = y + (size_t)row * cols;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    int c = lane + i * 32;
    if (c < cols) {
      float o = round_to<T>((v[i] - mean) * rstd * gamma[c] + beta[c]);
      yr[c] = from_f32<T>(o * m);
    }
  }
}

// grid_hp > 0: the grid mode over (grid_hp, grid_wp) maps, rows valid below
// (valid_h, valid_w); valid must then be null
MSAM_EXPORT int msam_layernorm(const void* x, const void* gamma, const void* beta,
                               const void* valid, void* y, int rows, int cols,
                               float eps, int grid_hp, int grid_wp, int valid_h, int valid_w,
                               int dtype, void* stream) {
  if (cols > kMaxPerLane * 32 || cols <= 0) return (int)cudaErrorInvalidValue;
  if (grid_hp > 0 && (valid || grid_wp <= 0 || rows % (grid_hp * grid_wp)))
    return (int)cudaErrorInvalidValue;
  const int4 map = make_int4(grid_hp, grid_wp, valid_h, valid_w);
  if (rows <= 0) return 0;
  dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MSAM_BF16) {
    using bf = __nv_bfloat16;
    auto kern = grid_hp > 0 ? layernorm_kernel<bf, true> : layernorm_kernel<bf, false>;
    kern<<<grid, 256, 0, s>>>((const bf*)x, (const float*)gamma, (const float*)beta,
                              (const float*)valid, (bf*)y, rows, cols, eps, map);
  } else if (dtype == MSAM_F32) {
    auto kern = grid_hp > 0 ? layernorm_kernel<float, true> : layernorm_kernel<float, false>;
    kern<<<grid, 256, 0, s>>>((const float*)x, (const float*)gamma, (const float*)beta,
                              (const float*)valid, (float*)y, rows, cols, eps, map);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

MSAM_ERROR_STRING(msam_layernorm)
