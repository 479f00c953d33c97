// Row LayerNorm with an optional per-row multiply (the window pad mask).
//
// Replaces the LN1 / LN2 stages inside the TPU kernels
// micro_sam_tpu/ops/fused_window_block.py::_fused_block_kernel and
// ::_fused_global_kernel. y = ((x - mean) * rsqrt(var + eps) * gamma + beta),
// statistics in f32 (two passes over the row held in registers), rounded to
// the working type, then multiplied by valid[row] when a mask is given
// (models/image_encoder.py window_block_masked). In the grid mode (the
// spatial window kernel, _fused_block_kernel(spatial=)) the rows are those of
// padded (B, Hp, Wp) maps and the mask is computed from the row's position
// instead of read: row (b, y, x) is valid when y < H and x < W. The mode is a
// template parameter (GRID), so the other launches carry no branch on it.
// Every variant ends each element in ln_out (below): the grid mode and the
// read mask share one arithmetic path.
//
// Bound on the H100: bytes. At vit_b (4900 x 768 bf16) it reads 7.5 MB and
// writes 7.5 MB, about 4.5 us at 3.35 TB/s, against 8 flops per element. The
// design before this one (one warp a row, 2-byte loads at a 64-byte stride,
// a 48-slot predicated register array at every width, gamma / beta reloaded
// per row, 8 rows a block) reached 10-21 % of that bound at vit_t's widths
// and 44-68 % at the ViTs'. This one:
//
// * The vector variant (bf16, the widths the four models use: 128, 160, 320,
//   768, 1024, 1280, a template parameter): 16-byte loads and stores, 8
//   columns a lane. A row's V = C / 8 vectors go to a group of L lanes, the
//   largest power of two up to 32 that divides V (16 lanes at 128, 4 at 160,
//   8 at 320, 32 from 768 up), NV = V / L vectors a lane and no idle lane;
//   a warp takes 32 / L rows at once, so the narrow vit_t rows fill it. The
//   statistics reduce over the group by xor shuffles.
// * gamma and beta of a lane's columns are loaded once per launch into
//   registers (16-byte loads): a lane owns the same columns in every row.
// * A persistent grid (a few blocks an SM, ops/layernorm.py::layernorm_plan)
//   walks the rows; a warp issues the loads of its next rows before the
//   reductions of its current ones, so two row groups' bytes are in flight a
//   warp.
// * The general variant (f32, any other C up to 1536, C not a multiple of 8,
//   an address not 16-byte aligned): one warp a row, element loads, the row
//   in up to 48 registers a lane. The plan picks the variant; this file
//   refuses a vector launch the rules do not allow.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps a block, both variants
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerLane = 48;  // the general variant: 48 * 32 = 1536 columns

// The vector variant's layout of a bf16 row of C columns (mirrored by
// ops/layernorm.py::vec_layout and blocks_per_sm).
template <int C>
struct VecShape {
  static constexpr int V = C / 8;  // 16-byte vectors a row
  static constexpr int L = V % 32 == 0 ? 32 : V % 16 == 0 ? 16 : V % 8 == 0 ? 8
                           : V % 4 == 0 ? 4 : V % 2 == 0 ? 2 : 1;  // lanes a row
  static constexpr int NV = V / L;  // vectors a lane
  static constexpr int R = 32 / L;  // rows a warp
  // blocks an SM the registers must allow (gamma / beta and two row groups
  // a lane: 16 + 8 registers a vector)
  static constexpr int MINB = NV == 1 ? 4 : NV == 2 ? 3 : NV == 3 ? 2 : 1;
};

// the row's multiplier: the mask read, or computed from the row's position
// in the padded maps (map: Hp, Wp, H, W)
template <bool GRID>
__device__ __forceinline__ float row_mask(const float* __restrict__ valid, int row, int4 map) {
  if constexpr (GRID) {
    const int px = row % map.y, py = (row / map.y) % map.x;
    return (py < map.z && px < map.w) ? 1.f : 0.f;
  } else {
    return valid ? valid[row] : 1.f;
  }
}

// one output element: normalised, rounded to T, then times the row's mask
template <typename T>
__device__ __forceinline__ float ln_out(float v, float mean, float rstd, float g, float b,
                                        float m) {
  return round_to<T>((v - mean) * rstd * g + b) * m;
}

__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
// element e of 8 bf16 in a 16-byte vector: word e / 2, its high half when e is odd
__device__ __forceinline__ float elem(const uint4& v, int e) {
  const uint32_t w = e < 4 ? (e < 2 ? v.x : v.y) : (e < 6 ? v.z : v.w);
  return e % 2 ? hi_bf16(w) : lo_bf16(w);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

template <int C, bool GRID>
__global__ void __launch_bounds__(kThreads, VecShape<C>::MINB) layernorm_vec_kernel(
    const uint4* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ valid, uint4* __restrict__ y, int rows, float eps, int4 map) {
  using S = VecShape<C>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / S::L, j = lane % S::L;  // the lane's row of the warp's R, its vectors
  float g[S::NV][8], b[S::NV][8];
#pragma unroll
  for (int i = 0; i < S::NV; ++i) {
    const int c = (j + i * S::L) * 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 gv = __ldg(reinterpret_cast<const float4*>(gamma + c) + h);
      const float4 bv = __ldg(reinterpret_cast<const float4*>(beta + c) + h);
      g[i][4 * h] = gv.x; g[i][4 * h + 1] = gv.y; g[i][4 * h + 2] = gv.z; g[i][4 * h + 3] = gv.w;
      b[i][4 * h] = bv.x; b[i][4 * h + 1] = bv.y; b[i][4 * h + 2] = bv.z; b[i][4 * h + 3] = bv.w;
    }
  }
  const int groups = (rows + S::R - 1) / S::R;
  const int stride = gridDim.x * kWarps;
  auto load = [&](uint4 (&d)[S::NV], int grp) {
    const int row = grp * S::R + sub;
    const uint4* p = x + (size_t)row * S::V + j;
#pragma unroll
    for (int i = 0; i < S::NV; ++i) d[i] = row < rows ? __ldg(p + i * S::L) : make_uint4(0, 0, 0, 0);
  };
  int grp = blockIdx.x * kWarps + warp;
  uint4 cur[S::NV], nxt[S::NV];
  if (grp < groups) load(cur, grp);
  for (; grp < groups; grp += stride) {
    if (grp + stride < groups) load(nxt, grp + stride);  // in flight through the reductions
    const int row = grp * S::R + sub;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < S::NV; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += elem(cur[i], e);
#pragma unroll
    for (int o = S::L / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / C;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < S::NV; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = elem(cur[i], e) - mean;
        sq += d * d;
      }
#pragma unroll
    for (int o = S::L / 2; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rstd = rsqrtf(sq / C + eps);
    if (row < rows) {
      const float m = row_mask<GRID>(valid, row, map);
      uint4* q = y + (size_t)row * S::V + j;
#pragma unroll
      for (int i = 0; i < S::NV; ++i) {
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[e] = ln_out<__nv_bfloat16>(elem(cur[i], e), mean, rstd, g[i][e], b[i][e], m);
        q[i * S::L] = make_uint4(pack2(o[0], o[1]), pack2(o[2], o[3]), pack2(o[4], o[5]),
                                 pack2(o[6], o[7]));
      }
    }
#pragma unroll
    for (int i = 0; i < S::NV; ++i) cur[i] = nxt[i];
  }
}

// any width up to 1536, any alignment, f32 or bf16: one warp a row
template <typename T, bool GRID>
__global__ void __launch_bounds__(kThreads) layernorm_general_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ valid, T* __restrict__ y, int rows, int cols, float eps, int4 map) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
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
  const float m = row_mask<GRID>(valid, row, map);
  T* yr = y + (size_t)row * cols;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    int c = lane + i * 32;
    if (c < cols) yr[c] = from_f32<T>(ln_out<T>(v[i], mean, rstd, gamma[c], beta[c], m));
  }
}

template <int C>
int launch_vec(int lanes, int grid, bool grid_mode, const void* x, const void* gamma,
               const void* beta, const void* valid, void* y, int rows, float eps, int4 map,
               cudaStream_t s) {
  using S = VecShape<C>;
  const int groups = (rows + S::R - 1) / S::R;
  if (lanes != S::L || grid < 1 || grid > (groups + kWarps - 1) / kWarps)
    return (int)cudaErrorInvalidValue;
  auto kern = grid_mode ? layernorm_vec_kernel<C, true> : layernorm_vec_kernel<C, false>;
  kern<<<grid, kThreads, 0, s>>>((const uint4*)x, (const float*)gamma, (const float*)beta,
                                 (const float*)valid, (uint4*)y, rows, eps, map);
  return (int)cudaGetLastError();
}

}  // namespace

// variant 1: the vector variant (bf16, cols one of 128, 160, 320, 768, 1024,
// 1280, x / y / gamma / beta 16-byte aligned; lanes the width's lanes a row;
// grid persistent blocks, at most one per 8 row groups); variant 0: the
// general one (cols up to 1536; lanes and grid ignored: a block per 8 rows).
// grid_hp > 0: the grid mode over (grid_hp, grid_wp) maps, rows valid below
// (valid_h, valid_w); valid must then be null. As ops/layernorm.py::
// layernorm_plan picks them; refused where they do not hold.
MSAM_EXPORT int msam_layernorm(const void* x, const void* gamma, const void* beta,
                               const void* valid, void* y, int rows, int cols, float eps,
                               int grid_hp, int grid_wp, int valid_h, int valid_w, int dtype,
                               int variant, int lanes, int grid, void* stream) {
  if (cols > kMaxPerLane * 32 || cols <= 0 || rows < 0) return (int)cudaErrorInvalidValue;
  if (grid_hp > 0 && (valid || grid_wp <= 0 || rows % (grid_hp * grid_wp)))
    return (int)cudaErrorInvalidValue;
  const int4 map = make_int4(grid_hp, grid_wp, valid_h, valid_w);
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool gm = grid_hp > 0;
  if (variant == 1) {
    if (dtype != MSAM_BF16 || ((uintptr_t)x | (uintptr_t)y | (uintptr_t)gamma | (uintptr_t)beta) % 16)
      return (int)cudaErrorInvalidValue;
#define MSAM_VEC(C) \
  case C: return launch_vec<C>(lanes, grid, gm, x, gamma, beta, valid, y, rows, eps, map, s);
    switch (cols) {
      MSAM_VEC(128) MSAM_VEC(160) MSAM_VEC(320) MSAM_VEC(768) MSAM_VEC(1024) MSAM_VEC(1280)
    }
#undef MSAM_VEC
    return (int)cudaErrorInvalidValue;
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  dim3 blocks((rows + kWarps - 1) / kWarps);
  if (dtype == MSAM_BF16) {
    using bf = __nv_bfloat16;
    auto kern = gm ? layernorm_general_kernel<bf, true> : layernorm_general_kernel<bf, false>;
    kern<<<blocks, kThreads, 0, s>>>((const bf*)x, (const float*)gamma, (const float*)beta,
                                     (const float*)valid, (bf*)y, rows, cols, eps, map);
  } else if (dtype == MSAM_F32) {
    auto kern = gm ? layernorm_general_kernel<float, true> : layernorm_general_kernel<float, false>;
    kern<<<blocks, kThreads, 0, s>>>((const float*)x, (const float*)gamma, (const float*)beta,
                                     (const float*)valid, (float*)y, rows, cols, eps, map);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

MSAM_ERROR_STRING(msam_layernorm)
