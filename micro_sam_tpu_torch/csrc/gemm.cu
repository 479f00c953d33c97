// Y = X W^T + b with a fused epilogue (none, exact-erf GELU, + residual,
// GELU of the sum with the residual).
//
// Replaces the qkv, proj, lin1 and lin2 products computed inside the TPU
// kernels micro_sam_tpu/ops/fused_window_block.py::_fused_block_kernel and
// ::_fused_global_kernel, and the 1 x 1 convolutions (BatchNorm folded) and
// MLP products of the TinyViT kernels ops/fused_mbconv.py::_mbconv_kernel,
// ops/fused_tiny_attention.py::_tiny_attn_kernel and
// ops/fused_tiny_tail.py::_tiny_tail_kernel. X is (M, K) row-major, W is
// (N, K) row-major (the nn.Linear / zoo layout), b is f32 (N), the residual R
// and Y are (M, N) in the working type. The epilogue rounds where the plain
// composition stores in the working type: v = round(acc + b); gelu:
// v = round(gelu(v)); residual: v = round(R + v); residual_gelu (the MBConv's
// last step): v = round(gelu(round(R + v))).
//
// Bound on the H100: operations. At vit_b the lin1 product is
// 4900 x 768 x 3072 (23 GFLOP, 23 us at 989 TFLOP/s) against 14 MB of traffic
// (4 us at 3.35 TB/s); every block product has at least 130 flops per byte.
// The bf16 design feeds the tensor cores with WMMA 16x16x16 fragments
// (mma.sync underneath) from a four-stage cp.async ring in shared memory
// (three K steps in flight while one is multiplied): a 128 x 128 output tile
// per block of 8 warps, each warp 64 x 32, K in steps of 32. M is ragged
// (4900 window rows): rows past M are zero-filled by cp.async and masked in
// the epilogue, so no padding copy is made. The f32
// path is a plain SIMT tile kernel (64 x 64 tile, 4 x 4 per thread), kept for
// holding the kernel path against the plain one at a tight tolerance.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

#define EPI_NONE 0
#define EPI_GELU 1
#define EPI_RESIDUAL 2
#define EPI_RESIDUAL_GELU 3

template <typename T, int EPI>
__device__ __forceinline__ float epilogue(float acc, float b, const T* R, size_t idx) {
  float v = round_to<T>(acc + b);
  if (EPI == EPI_GELU) v = round_to<T>(gelu_erf(v));
  if (EPI == EPI_RESIDUAL || EPI == EPI_RESIDUAL_GELU) v = round_to<T>(to_f32(R[idx]) + v);
  if (EPI == EPI_RESIDUAL_GELU) v = round_to<T>(gelu_erf(v));
  return v;
}

// ---------------------------------------------------------------------------
// bf16: WMMA fed by a cp.async ring
// ---------------------------------------------------------------------------
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDS = BK + 8;  // padded smem row (elements): 80 bytes, breaks bank conflicts
constexpr int kStageElems = (BM + BN) * LDS;
constexpr int STAGES = 4;
constexpr int kGemmSmem = STAGES * kStageElems * 2;  // 80 KB: dynamic shared memory

__device__ __forceinline__ void load_stage(__nv_bfloat16* sA, __nv_bfloat16* sB,
                                           const __nv_bfloat16* X, const __nv_bfloat16* W,
                                           int M, int N, int K, int m0, int n0, int k0) {
  // each tile is 128 rows x 32 cols = 512 chunks of 8 elements; 256 threads x 2
  for (int c = threadIdx.x; c < BM * (BK / 8); c += blockDim.x) {
    int r = c >> 2, kc = (c & 3) * 8;
    int gm = m0 + r, gk = k0 + kc;
    bool ok = gm < M && gk < K;
    cp_async16(sA + r * LDS + kc, ok ? (const void*)(X + (size_t)gm * K + gk) : (const void*)X, ok);
    int gn = n0 + r;
    ok = gn < N && gk < K;
    cp_async16(sB + r * LDS + kc, ok ? (const void*)(W + (size_t)gn * K + gk) : (const void*)W, ok);
  }
}

template <int EPI>
__global__ void __launch_bounds__(256) gemm_bf16_kernel(
    const __nv_bfloat16* __restrict__ X, const __nv_bfloat16* __restrict__ W,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ R,
    __nv_bfloat16* __restrict__ Y, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(gemm_smem);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, each 64 x 32

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) {
      __nv_bfloat16* buf = smem + st * kStageElems;
      load_stage(buf, buf + BM * LDS, X, W, M, N, K, m0, n0, st * BK);
    }
    cp_async_commit();  // empty groups keep the wait count uniform
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // step kt has landed
    __syncthreads();              // ... for every thread; step kt - 1 is consumed
    const int nt = kt + STAGES - 1;
    if (nt < nk) {
      __nv_bfloat16* buf = smem + (nt % STAGES) * kStageElems;
      load_stage(buf, buf + BM * LDS, X, W, M, N, K, m0, n0, nt * BK);
    }
    cp_async_commit();
    const __nv_bfloat16* sA = smem + (kt % STAGES) * kStageElems;
    const __nv_bfloat16* sB = sA + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], sA + (wm * 64 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], sB + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: each warp stages one 16x16 fragment at a time in its own slice
  // of the (now idle) operand ring, then applies bias / GELU / residual
  float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
  const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      int gm = m0 + wm * 64 + i * 16 + er;
      int gnb = n0 + wn * 32 + j * 16 + ec;
      if (gm < M && gnb + 8 <= N && (N & 7) == 0) {
        // 8 consecutive outputs: one 16-byte store (and residual load)
        size_t idx = (size_t)gm * N + gnb;
        __align__(16) __nv_bfloat16 out[8];
        __align__(16) __nv_bfloat16 res[8];
        if (EPI == EPI_RESIDUAL || EPI == EPI_RESIDUAL_GELU)
          *reinterpret_cast<uint4*>(res) = *reinterpret_cast<const uint4*>(R + idx);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          out[e] = __float2bfloat16(epilogue<__nv_bfloat16, EPI>(scratch[er * 16 + ec + e],
                                                                  bias[gnb + e], res, e));
        *reinterpret_cast<uint4*>(Y + idx) = *reinterpret_cast<const uint4*>(out);
      } else if (gm < M) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          int gn = gnb + e;
          if (gn < N) {
            size_t idx = (size_t)gm * N + gn;
            float v = epilogue<__nv_bfloat16, EPI>(scratch[er * 16 + ec + e], bias[gn], R, idx);
            Y[idx] = __float2bfloat16(v);
          }
        }
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// f32: plain SIMT tiles
// ---------------------------------------------------------------------------
constexpr int FT = 64, FK = 16;

template <int EPI>
__global__ void __launch_bounds__(256) gemm_f32_kernel(
    const float* __restrict__ X, const float* __restrict__ W, const float* __restrict__ bias,
    const float* __restrict__ R, float* __restrict__ Y, int M, int N, int K) {
  __shared__ float sA[FK][FT + 4];
  __shared__ float sB[FK][FT + 4];
  const int m0 = blockIdx.y * FT, n0 = blockIdx.x * FT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int c = threadIdx.x; c < FT * FK; c += blockDim.x) {
      int r = c / FK, kk = c % FK;
      int gk = k0 + kk;
      sA[kk][r] = (m0 + r < M && gk < K) ? X[(size_t)(m0 + r) * K + gk] : 0.f;
      sB[kk][r] = (n0 + r < N && gk < K) ? W[(size_t)(n0 + r) * K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gn = n0 + tx * 4 + j;
      if (gn < N) {
        size_t idx = (size_t)gm * N + gn;
        Y[idx] = epilogue<float, EPI>(acc[i][j], bias[gn], R, idx);
      }
    }
  }
}

template <int EPI>
static cudaError_t launch(const void* x, const void* w, const void* b, const void* r, void* y,
                   int M, int N, int K, int dtype, cudaStream_t s) {
  if (dtype == MSAM_BF16) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    cudaError_t e = cudaFuncSetAttribute(gemm_bf16_kernel<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
    if (e != cudaSuccess) return e;
    gemm_bf16_kernel<EPI><<<grid, 256, kGemmSmem, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)b,
        (const __nv_bfloat16*)r, (__nv_bfloat16*)y, M, N, K);
  } else {
    dim3 grid((N + FT - 1) / FT, (M + FT - 1) / FT);
    gemm_f32_kernel<EPI><<<grid, 256, 0, s>>>(
        (const float*)x, (const float*)w, (const float*)b, (const float*)r, (float*)y, M, N, K);
  }
  return cudaSuccess;
}

MSAM_EXPORT int msam_gemm(const void* x, const void* w, const void* b, const void* r,
                          void* y, int M, int N, int K, int epi, int dtype, void* stream) {
  if (dtype != MSAM_BF16 && dtype != MSAM_F32) return (int)cudaErrorInvalidValue;
  if (dtype == MSAM_BF16 && (K % 8) != 0) return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  switch (epi) {
    case EPI_NONE: e = launch<EPI_NONE>(x, w, b, r, y, M, N, K, dtype, s); break;
    case EPI_GELU: e = launch<EPI_GELU>(x, w, b, r, y, M, N, K, dtype, s); break;
    case EPI_RESIDUAL: e = launch<EPI_RESIDUAL>(x, w, b, r, y, M, N, K, dtype, s); break;
    case EPI_RESIDUAL_GELU:
      e = launch<EPI_RESIDUAL_GELU>(x, w, b, r, y, M, N, K, dtype, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

MSAM_ERROR_STRING(msam_gemm)
