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
// f32); the weight comes re-laid as (9, C) f32 (tap-major: w9[3 di + dj, c],
// ops/dwconv.py caches it per weight tensor), s / t f32; the sum is f32 in
// tap order (di, then dj) and y is rounded where the plain composition
// stores: once after the BN, once after the GELU.
//
// Bound on the H100: bytes. 18 flops per output against one element read and
// one written: the MBConv's hidden map at 1024^2 (256 x 256 x 256 bf16) is
// 33.5 MB in and 33.5 MB out, 20 us at 3.35 TB/s against 0.3 GFLOP. The
// design before this one (a thread per 16 bytes of channels of one pixel,
// nine 16-byte loads through L1 / L2 and 72 scalar weight loads an output,
// three 64-bit divisions a thread) reached about a tenth of that bound. This
// one moves each input element from device memory about once:
//
// * Halo tiles by TMA. A block takes tiles of TH x TW pixels x CT channels
//   (CT divides C, CT elements a multiple of 16 bytes); one 4-d TMA load (a
//   tensor map over (C, W, H, B)) copies the (TH + 2) x (TW + 2) x CT halo
//   tile into shared memory from (x0 - 1, y0 - 1). The TMA unit zero-fills
//   what lies outside the map, which is the convolution's padding, so the
//   arithmetic has no bounds branches.
// * A persistent grid (as many blocks as fit on the SMs) walks the tiles,
//   channel slab slowest, with a 2-slot mbarrier ring: one thread issues
//   the next tile's load into the other slot before the block computes the
//   current one, and a barrier at the end of each tile frees its slot.
// * A thread owns VEC channels (16 bytes) of one column of the tile and walks
//   down its TH rows with the 3 x 3 window in registers (as f32): each output
//   row reads three new 16-byte vectors from shared memory. Its 9 x VEC
//   weights, scales and shifts are loaded as 16-byte vectors when its slab
//   changes, not per output. All index arithmetic is 32-bit; the tile walk
//   divides once a tile.
// * Shapes TMA cannot take (C elements not a multiple of 16 bytes, or x / y
//   not 16-byte aligned) run the same walk on tiles that the block fills
//   itself with plain vector loads (VEC as wide as C and the addresses
//   allow), zero-filling the padding, one slot. ops/dwconv.py::dwconv_plan
//   picks the body, CT, TH and TW; this file checks them.
// * f32 is the same kernel with T = float (VEC 4), for the parity runs.
//
// ptxas (-Xptxas -v, sm_90a): no spill; the TMA body 188 / 196 registers in
// bf16 (without / with GELU), 105 / 116 in f32; 128-thread tiles (the plan's)
// put two blocks on an SM.
#include "common.cuh"
#include "tma.cuh"

#include <mutex>

namespace {

constexpr int kMaxThreads = 256;

// VEC elements of T as one aligned load / store
template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) Pack {
  T e[VEC];
};

template <int VEC>
__device__ __forceinline__ void load_f32(float (&d)[VEC], const float* p) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
      d[i] = v.x; d[i + 1] = v.y; d[i + 2] = v.z; d[i + 3] = v.w;
    }
  } else if constexpr (VEC == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    d[0] = v.x; d[1] = v.y;
  } else {
    d[0] = __ldg(p);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(float (&d)[VEC], const T* p) {
  const Pack<T, VEC> v = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int e = 0; e < VEC; ++e) d[e] = to_f32(v.e[e]);
}

struct Geometry {
  int B, H, W, C, CT, TH, TW;
  int ntx, nty, per_slab, tiles;  // tiles across, down, of one channel slab, in all
};

struct TileAt {
  int c0, b, y0, x0;
};

__device__ __forceinline__ TileAt tile_at(const Geometry& g, int t) {
  TileAt a;
  const int slab = t / g.per_slab, r = t - slab * g.per_slab;
  const int per_img = g.nty * g.ntx, b = r / per_img, q = r - b * per_img;
  const int ty = q / g.ntx;
  a.c0 = slab * g.CT;
  a.b = b;
  a.y0 = ty * g.TH;
  a.x0 = (q - ty * g.ntx) * g.TW;
  return a;
}

// One tile from its halo in shared memory (TH + 2 rows of TW + 2 pixels of
// CT channels): the thread's column j and channel group cg, down the rows.
template <typename T, int VEC, bool GELU>
__device__ __forceinline__ void compute_tile(const T* tile, const Geometry& g, const TileAt& a,
                                             int j, int cg, const float (&w)[9][VEC],
                                             const float (&sc)[VEC], const float (&sh)[VEC],
                                             T* __restrict__ y) {
  const int x = a.x0 + j;
  if (x >= g.W) return;
  const int rows = min(g.TH, g.H - a.y0);
  const int pitch = (g.TW + 2) * g.CT;  // elements of a tile row
  const T* p = tile + j * g.CT + cg * VEC;
  float win[3][3][VEC];  // rows r, r + 1, r + 2 of the tile; columns j, j + 1, j + 2
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) unpack<T, VEC>(win[r][c], p + r * pitch + c * g.CT);
  T* out = y + ((size_t)(a.b * g.H + a.y0) * g.W + x) * g.C + a.c0 + cg * VEC;
  const size_t row_step = (size_t)g.W * g.C;
  for (int i = 0; i < rows; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) unpack<T, VEC>(win[2][c], p + (i + 2) * pitch + c * g.CT);
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(win[di][dj][e], w[di * 3 + dj][e], acc[e]);
    Pack<T, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float v = round_to<T>(fmaf(acc[e], sc[e], sh[e]));
      if constexpr (GELU) v = gelu_erf(v);
      o.e[e] = from_f32<T>(v);
    }
    *reinterpret_cast<Pack<T, VEC>*>(out) = o;
    out += row_step;
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        win[0][c][e] = win[1][c][e];
        win[1][c][e] = win[2][c][e];
      }
  }
}

// the thread's weights, scale and shift for channels c..c + VEC
template <int VEC>
__device__ __forceinline__ void load_params(float (&w)[9][VEC], float (&sc)[VEC], float (&sh)[VEC],
                                            const float* __restrict__ w9,
                                            const float* __restrict__ scale,
                                            const float* __restrict__ shift, int C, int c) {
#pragma unroll
  for (int k = 0; k < 9; ++k) load_f32<VEC>(w[k], w9 + k * C + c);
  load_f32<VEC>(sc, scale + c);
  load_f32<VEC>(sh, shift + c);
}

// the halo tile's bytes, rounded up to 128 (the TMA destination's alignment)
__host__ __device__ inline int slot_bytes(int CT, int TH, int TW, int esz) {
  return ((TH + 2) * (TW + 2) * CT * esz + 127) & ~127;
}

template <typename T, int VEC, bool GELU>
__global__ void __launch_bounds__(kMaxThreads, 1) dwconv_tma_kernel(
    const __grid_constant__ CUtensorMap map, const float* __restrict__ w9,
    const float* __restrict__ scale, const float* __restrict__ shift, T* __restrict__ y,
    Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int slot = slot_bytes(g.CT, g.TH, g.TW, sizeof(T));
  // the slots 128-byte aligned (the TMA destinations), then two barriers
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t base = (raw + 127u) & ~127u;
  const uint32_t full = base + 2 * slot;
  const unsigned char* slots = smem + (base - raw);
  const int groups = g.CT / VEC, cg = threadIdx.x % groups, j = threadIdx.x / groups;
  const uint32_t bytes = (uint32_t)((g.TH + 2) * (g.TW + 2) * g.CT * sizeof(T));
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int t, int s) {
    const TileAt a = tile_at(g, t);
    mbar_expect_tx(full + 8 * s, bytes);  // the parts outside the map count, zero-filled
    tma_load_4d(base + s * slot, &map, full + 8 * s, a.c0, a.x0 - 1, a.y0 - 1, a.b);
  };
  if (threadIdx.x == 0 && (int)blockIdx.x < g.tiles) issue(blockIdx.x, 0);
  float w[9][VEC], sc[VEC], sh[VEC];
  int slab_c0 = -1;
  int k = 0;
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x, ++k) {
    const int s = k & 1;
    // the other slot was read in the previous tile, which ended in a barrier
    if (threadIdx.x == 0 && t + (int)gridDim.x < g.tiles) issue(t + gridDim.x, s ^ 1);
    const TileAt a = tile_at(g, t);
    if (a.c0 != slab_c0) {
      load_params<VEC>(w, sc, sh, w9, scale, shift, g.C, a.c0 + cg * VEC);
      slab_c0 = a.c0;
    }
    mbar_wait(full + 8 * s, (k >> 1) & 1);
    if (j < g.TW)
      compute_tile<T, VEC, GELU>(reinterpret_cast<const T*>(slots + s * slot), g, a, j, cg, w,
                                 sc, sh, y);
    __syncthreads();  // every thread is done with slot s
  }
}

// the same walk over tiles the block loads itself (plain vector loads,
// padding zero-filled), one slot
template <typename T, int VEC, bool GELU>
__global__ void __launch_bounds__(kMaxThreads, 1) dwconv_plain_kernel(
    const T* __restrict__ x, const float* __restrict__ w9, const float* __restrict__ scale,
    const float* __restrict__ shift, T* __restrict__ y, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const int groups = g.CT / VEC, cg = threadIdx.x % groups, j = threadIdx.x / groups;
  const int halo = (g.TH + 2) * (g.TW + 2);
  float w[9][VEC], sc[VEC], sh[VEC];
  int slab_c0 = -1;
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const TileAt a = tile_at(g, t);
    if (a.c0 != slab_c0) {
      load_params<VEC>(w, sc, sh, w9, scale, shift, g.C, a.c0 + cg * VEC);
      slab_c0 = a.c0;
    }
    for (int idx = threadIdx.x; idx < halo * groups; idx += blockDim.x) {
      const int px = idx / groups, part = idx - px * groups;
      const int r = px / (g.TW + 2), c = px - r * (g.TW + 2);
      const int yy = a.y0 - 1 + r, xx = a.x0 - 1 + c;
      Pack<T, VEC> v;
      if (yy >= 0 && yy < g.H && xx >= 0 && xx < g.W) {
        v = *reinterpret_cast<const Pack<T, VEC>*>(
            x + ((size_t)(a.b * g.H + yy) * g.W + xx) * g.C + a.c0 + part * VEC);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v.e[e] = from_f32<T>(0.f);
      }
      *reinterpret_cast<Pack<T, VEC>*>(tile + px * g.CT + part * VEC) = v;
    }
    __syncthreads();
    if (j < g.TW) compute_tile<T, VEC, GELU>(tile, g, a, j, cg, w, sc, sh, y);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps (cached on their whole key) and launches
// ---------------------------------------------------------------------------

struct CachedMap {
  const void* ptr;
  int B, H, W, C, CT, TH, TW, dtype;
  CUtensorMap map;
};
constexpr int kMapSlots = 1024;
std::mutex g_map_mu;
CachedMap g_maps[kMapSlots];
int g_maps_encoded = 0;

bool cached_map(CUtensorMap* out, const void* x, const Geometry& g, int dtype) {
  std::lock_guard<std::mutex> lock(g_map_mu);
  CachedMap& e = g_maps[(((uintptr_t)x >> 8) ^ (uintptr_t)(g.C * 31 + g.TW * 7 + g.TH)) % kMapSlots];
  if (e.ptr != x || e.B != g.B || e.H != g.H || e.W != g.W || e.C != g.C || e.CT != g.CT ||
      e.TH != g.TH || e.TW != g.TW || e.dtype != dtype) {
    e.ptr = nullptr;
    EncodeTiled enc = encode_tiled();
    if (!enc) return false;
    const cuuint64_t esz = dtype == MSAM_BF16 ? 2 : 4;
    cuuint64_t dims[4] = {(cuuint64_t)g.C, (cuuint64_t)g.W, (cuuint64_t)g.H, (cuuint64_t)g.B};
    cuuint64_t strides[3] = {g.C * esz, (cuuint64_t)g.W * g.C * esz,
                             (cuuint64_t)g.H * g.W * g.C * esz};
    cuuint32_t box[4] = {(cuuint32_t)g.CT, (cuuint32_t)(g.TW + 2), (cuuint32_t)(g.TH + 2), 1};
    cuuint32_t elem[4] = {1, 1, 1, 1};
    if (enc(&e.map,
            dtype == MSAM_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            4, const_cast<void*>(x), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return false;
    e.ptr = x;
    e.B = g.B; e.H = g.H; e.W = g.W; e.C = g.C; e.CT = g.CT; e.TH = g.TH; e.TW = g.TW;
    e.dtype = dtype;
    ++g_maps_encoded;
  }
  *out = e.map;
  return true;
}

int sm_count() {
  static int n = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return v;
  }();
  return n;
}

// A kernel's persistent grid: as many blocks as fit on all SMs at once, at
// most one a tile. Its shared-memory limit is raised and its occupancy asked
// once per (threads, bytes) seen last: repeated launches of one shape cost
// no runtime query.
struct GridCache {
  std::mutex mu;
  int opened = 0, threads = -1, smem = -1, per_sm = 0;
};

template <typename Kernel>
cudaError_t persistent_grid(GridCache& c, Kernel kern, int threads, int smem, int tiles,
                            int* grid) {
  std::lock_guard<std::mutex> lock(c.mu);
  if (smem > c.opened) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    c.opened = smem;
  }
  if (threads != c.threads || smem != c.smem) {
    int per_sm = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
    if (e != cudaSuccess) return e;
    c.threads = threads;
    c.smem = smem;
    c.per_sm = per_sm;
  }
  const int sms = sm_count();
  if (c.per_sm < 1 || sms < 1) return cudaErrorInvalidConfiguration;
  *grid = tiles < c.per_sm * sms ? tiles : c.per_sm * sms;
  return cudaSuccess;
}

template <typename T, int VEC, bool GELU>
cudaError_t launch(bool tma, const void* x, const void* w9, const void* s, const void* t, void* y,
                   const Geometry& g, int dtype, cudaStream_t st) {
  const int threads = g.CT / VEC * g.TW;
  const int slot = slot_bytes(g.CT, g.TH, g.TW, sizeof(T));
  int grid = 0;
  if constexpr (VEC * sizeof(T) == 16) {  // TMA takes 16-byte vectors only
    if (tma) {
      static GridCache cache;
      CUtensorMap map;
      if (!cached_map(&map, x, g, dtype)) return cudaErrorInvalidValue;
      const int smem = 2 * slot + 16 + 128;  // two slots, two barriers, alignment
      cudaError_t e = persistent_grid(cache, dwconv_tma_kernel<T, VEC, GELU>, threads, smem,
                                      g.tiles, &grid);
      if (e != cudaSuccess) return e;
      dwconv_tma_kernel<T, VEC, GELU><<<grid, threads, smem, st>>>(
          map, (const float*)w9, (const float*)s, (const float*)t, (T*)y, g);
      return cudaSuccess;
    }
  }
  if (tma) return cudaErrorInvalidValue;
  static GridCache cache;
  cudaError_t e = persistent_grid(cache, dwconv_plain_kernel<T, VEC, GELU>, threads, slot,
                                  g.tiles, &grid);
  if (e != cudaSuccess) return e;
  dwconv_plain_kernel<T, VEC, GELU><<<grid, threads, slot, st>>>(
      (const T*)x, (const float*)w9, (const float*)s, (const float*)t, (T*)y, g);
  return cudaSuccess;
}

template <typename T, int VEC>
cudaError_t launch_act(int gelu, bool tma, const void* x, const void* w9, const void* s,
                       const void* t, void* y, const Geometry& g, int dtype, cudaStream_t st) {
  return gelu ? launch<T, VEC, true>(tma, x, w9, s, t, y, g, dtype, st)
              : launch<T, VEC, false>(tma, x, w9, s, t, y, g, dtype, st);
}

}  // namespace

// x, y: (B, H, W, C) contiguous, w9: (9, C) f32 (w9[3 di + dj, c] = w[c, 0, di,
// dj]), scale / shift: (C,) f32. body 1: TMA halo tiles (C * elt a multiple
// of 16 bytes, x 16-byte aligned, vec the 16-byte width); body 0: tiles
// loaded by the block, vec dividing C with x / y aligned to vec elements.
// ct, th, tw: the tile (ct divides C and is a multiple of vec; ct / vec * tw
// <= 256 threads; tw + 2 and th + 2 at most 256). As ops/dwconv.py::dwconv_plan
// picks them; refused where they do not hold.
MSAM_EXPORT int msam_dwconv(const void* x, const void* w9, const void* scale, const void* shift,
                            void* y, int B, int H, int W, int C, int gelu, int dtype, int body,
                            int vec, int ct, int th, int tw, void* stream) {
  if (B < 0 || H < 0 || W < 0 || C <= 0 || (dtype != MSAM_BF16 && dtype != MSAM_F32))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W == 0) return 0;
  const int esz = dtype == MSAM_BF16 ? 2 : 4;
  const bool tma = body == 1;
  if (vec <= 0 || (vec & (vec - 1)) || vec * esz > 16 || ct <= 0 || ct % vec || C % ct ||
      th <= 0 || tw <= 0 || th + 2 > 256 || tw + 2 > 256 || ct / vec * tw > kMaxThreads ||
      (long long)B * H * W * C >= (1ll << 31) ||
      (uintptr_t)x % (vec * esz) || (uintptr_t)y % (vec * esz))
    return (int)cudaErrorInvalidValue;
  if (tma && (vec * esz != 16 || (C * esz) % 16 || (uintptr_t)x % 16 || ct > 256))
    return (int)cudaErrorInvalidValue;
  Geometry g{B, H, W, C, ct, th, tw};
  g.ntx = (W + tw - 1) / tw;
  g.nty = (H + th - 1) / th;
  g.per_slab = B * g.nty * g.ntx;
  if ((long long)g.per_slab * (C / ct) >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  g.tiles = g.per_slab * (C / ct);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == MSAM_BF16) {
    switch (vec) {
      case 8: e = launch_act<__nv_bfloat16, 8>(gelu, tma, x, w9, scale, shift, y, g, dtype, st); break;
      case 4: e = launch_act<__nv_bfloat16, 4>(gelu, tma, x, w9, scale, shift, y, g, dtype, st); break;
      case 2: e = launch_act<__nv_bfloat16, 2>(gelu, tma, x, w9, scale, shift, y, g, dtype, st); break;
      case 1: e = launch_act<__nv_bfloat16, 1>(gelu, tma, x, w9, scale, shift, y, g, dtype, st); break;
    }
  } else {
    switch (vec) {
      case 4: e = launch_act<float, 4>(gelu, tma, x, w9, scale, shift, y, g, dtype, st); break;
      case 2: e = launch_act<float, 2>(gelu, tma, x, w9, scale, shift, y, g, dtype, st); break;
      case 1: e = launch_act<float, 1>(gelu, tma, x, w9, scale, shift, y, g, dtype, st); break;
    }
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the tensor maps encoded so far (cache misses)
MSAM_EXPORT int msam_dwconv_maps_encoded() { return g_maps_encoded; }

MSAM_ERROR_STRING(msam_dwconv)
