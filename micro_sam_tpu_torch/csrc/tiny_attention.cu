// TinyViT window attention with a learned per-offset bias, read straight from
// the qkv product's rows of the padded spatial map:
//
//   out = softmax((q k^T) * hd^-0.5 + B[h, |dy| * w + |dx|]) v   per (window, head)
//
// Replaces the attention core of micro_sam_tpu/ops/fused_tiny_attention.py::
// _tiny_attn_kernel (reached through _tiny_fused_forward / fused_tiny_attention).
//
// Layout. The qkv product is (B * Hp * Wp, 3C) over the zero-padded
// (B, Hp, Wp, C) map, in upstream TinyViT's per-head order: head h's q sits
// at columns [96h, 96h + 32), its k at +32 and its v at +64 (hd = 32). Token
// (i, j) of window (wy, wx) of image b is row (b Hp + wy w + i) Wp + wx w + j,
// so the window partition is index arithmetic and no transpose runs; the
// result goes to the same row of the (B * Hp * Wp, C) output at column 32h,
// the order the proj product reads. The bias comes from the learned (nH, w^2)
// f32 table at |dy| w + |dx| (upstream's attention_bias_idxs numbers the
// offsets in exactly that order); no N x N bias is read. Every key of the
// window takes part, the map's zero pad tokens too (as upstream); the softmax
// is exact per row (the row's own maximum subtracted, no fixed offset).
//
// Bound on the H100: bytes (hd 32 gives 4 N hd flops per head and token
// against 4 hd values moved: 49- or 196-token windows are well below the
// card's 295 flops per byte). The design before this one (a block of 4 warps
// per (window, head), cp.async copies of 64-byte segments, no overlap of one
// window's load with another's products, integer divides per logit) reached
// 16 % of that bound; at stage 2 (5 heads, window 14) its 4 warps walked 13
// sixteen-row groups in turn. This one (bf16):
//
// * A persistent grid over units of (window, group of heads). A warp takes
//   a (head, 16-row group) of the unit, so a unit's row groups run side by
//   side: at window 7 a unit is 2 heads (8 warps, three blocks an SM, so
//   three units' loads, products and barriers overlap on an SM); at window
//   14 (13 row groups) a unit is one head, 13 warps, a block an SM. ops/tiny_attention.py::tiny_attention_plan picks the
//   heads, warps and grid; this file checks them.
// * The unit's q, k and v come in by TMA: a 3-d tensor map over the qkv rows
//   (columns, map x, map rows) and a box of 32 columns x w x w tokens per
//   head and part (64-byte rows, 64-byte swizzle, so the ldmatrix fragment
//   loads are free of bank conflicts), through a two-slot mbarrier ring: one
//   thread issues the next unit's loads into the other slot before the block
//   computes the current one (and the first unit's before the block stages
//   its tables).
// * A warp keeps a chunk of its 16 rows' logits in registers (mma.sync
//   m16n8k16 on bf16, f32 accumulators): all 64 keys at window 7; at window
//   14 chunks of 80, 80 and 48 keys, the row maximum and sums rescaled
//   between them (within the 128 registers of 13 warps, no spill). The probabilities are
//   rounded to bf16, summed as rounded and repacked in registers as the A
//   fragments of the product with v. (At hd 32 a 64-row wgmma tile would pad
//   the 49-token windows to 64 rows, and the kernel is bound by bytes.)
// * log2(e) is folded into the scale and into the bias tables, which every
//   block stages once, all heads, as (2w - 1) x (2w - 1) signed-offset tables;
//   a logit's bias is tab[base(query) - koff(key)], two integers precomputed
//   per query row and per key: no divide per logit. exp2 for the
//   exponentials.
// * A warp leaves its outputs over its own q rows in the slot; the block
//   writes them out as whole 16-byte pieces of each token's row, all the
//   unit's heads side by side.
//
// The f32 kernel is a plain SIMT version (one warp per query row, lane = head
// dim), kept for holding the kernel path against the plain one at a tight
// tolerance.
#include "relpos_common.cuh"
#include "tma.cuh"

#include <mutex>

namespace {

constexpr int TA_HD = 32;

template <int WS>
struct Win {
  static constexpr int N = WS * WS;
  static constexpr int NP = (N + 15) / 16 * 16;  // q rows and keys padded for mma
  static constexpr int G = NP / 16;              // 16-row groups
  static constexpr int JT = NP / 8;              // 8-key tiles
  static constexpr int KCH = WS == 7 ? 8 : 10;   // key tiles a chunk (even; logits in registers)
  static constexpr int T = 2 * WS - 1;           // side of the signed-offset bias table
  // warps a block at most and blocks an SM the registers must allow (the
  // launch bounds: 85 registers a thread at window 7, 128 at window 14)
  static constexpr int MAXW = WS == 7 ? 8 : 13;
  static constexpr int MINB = WS == 7 ? 3 : 1;
};

// the bf16 kernel's shared memory (mirrored by ops/tiny_attention.py::smem_bytes):
// two ring slots of 3 x heads parts (NP rows of 64 bytes each, 1024-aligned),
// the bias tables of all nH heads (f32), the key offsets, two barriers; 1024
// bytes of slack to align the base
struct TaLayout {
  int slot, tab, koff, bars, bytes;
};

template <int WS>
__host__ __device__ inline TaLayout ta_layout(int heads, int nH) {
  using W = Win<WS>;
  TaLayout L;
  L.slot = 3 * heads * W::NP * 64;
  L.tab = 2 * L.slot;
  L.koff = (L.tab + nH * W::T * W::T * 4 + 15) & ~15;
  L.bars = (L.koff + W::NP * 4 + 7) & ~7;
  L.bytes = L.bars + 16 + 1024;
  return L;
}

struct TaGeo {
  int B, Hp, Wp, nH;
  int heads, hg;    // heads a unit, head groups a window (nH / heads)
  int nwx, nwy;     // windows across and down a map
  int units;        // windows x head groups
};

// element (row, 8 x chunk) of a part: 64-byte rows, 16-byte chunks swizzled
// by TMA's 64-byte pattern (chunk ^= (row / 2) % 4; the part 512-aligned)
__device__ __forceinline__ bf16* swz(bf16* part, int row, int chunk) {
  return part + row * TA_HD + ((chunk ^ ((row >> 1) & 3)) << 3);
}

// One warp: rows [16 rg, 16 rg + 16) of one head of a window, from its q, k
// and v parts; the outputs (bf16, normalised) go over the warp's own q rows
// (no other warp reads them), from where the block writes them out.
template <int WS>
__device__ __forceinline__ void attend(bf16* Q, bf16* K, bf16* V, const float* __restrict__ tab,
                                       const int* koff, int rg, float scale2, int lane) {
  using W = Win<WS>;
  constexpr int N = W::N, JT = W::JT, KCH = W::KCH, T = W::T;
  const int g = lane >> 2, t = lane & 3;
  uint32_t qa[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    ldsm_x4(qa[kk], swz(Q, rg * 16 + (lane & 15), 2 * kk + (lane >> 4)));
  // rows g and g + 8 of the group (a padded row takes the last token's
  // position: never stored)
  const int r0 = min(rg * 16 + g, N - 1), r1 = min(rg * 16 + g + 8, N - 1);
  const int base0 = (r0 / WS + WS - 1) * T + r0 % WS + WS - 1;
  const int base1 = (r1 / WS + WS - 1) * T + r1 % WS + WS - 1;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  // keys in chunks of KCH tiles (one chunk at window 7): the chunk's logits
  // in registers, the running maximum and sums rescaled between chunks; the
  // chunk loop stays rolled, so one chunk's logits are live at a time
#pragma unroll 1
  for (int c0 = 0; c0 < JT; c0 += KCH) {
    float s[KCH][4];
    float mc0 = -INFINITY, mc1 = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < KCH; ++jj) {
      const int j = c0 + jj;
      if (j < JT) {
        uint32_t kb[4];
        ldsm_x4(kb, swz(K, j * 8 + (lane & 7), lane >> 3));
        s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
        mma16816(s[jj], qa[0], kb[0], kb[1]);
        mma16816(s[jj], qa[1], kb[2], kb[3]);
        // scale and bias in log2 units, keys past N masked
        const int2 ko = *reinterpret_cast<const int2*>(koff + j * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kof = e ? ko.y : ko.x;
          if (j * 8 + 8 <= N || j * 8 + 2 * t + e < N) {
            s[jj][e] = fmaf(s[jj][e], scale2, tab[base0 - kof]);
            s[jj][2 + e] = fmaf(s[jj][2 + e], scale2, tab[base1 - kof]);
          } else {
            s[jj][e] = s[jj][2 + e] = -INFINITY;
          }
          mc0 = fmaxf(mc0, s[jj][e]);
          mc1 = fmaxf(mc1, s[jj][2 + e]);
        }
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mc0 = fmaxf(mc0, __shfl_xor_sync(0xffffffffu, mc0, off));
      mc1 = fmaxf(mc1, __shfl_xor_sync(0xffffffffu, mc1, off));
    }
    // every chunk holds a key < N, so the maxima are finite from the first on
    const float n0 = fmaxf(m0, mc0), n1 = fmaxf(m1, mc1);
    if (c0 > 0) {
      const float a0 = ex2(m0 - n0), a1 = ex2(m1 - n1);
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        o[n][0] *= a0; o[n][1] *= a0;
        o[n][2] *= a1; o[n][3] *= a1;
      }
    }
    m0 = n0;
    m1 = n1;

    // p = 2^(s - max), rounded to bf16, 16 keys at a time into A fragments
    // of p v; v's B fragments come transposed out of shared memory
#pragma unroll
    for (int kk = 0; kk < KCH / 2; ++kk) {
      if (c0 + 2 * kk < JT) {
        uint32_t pa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* sj = s[2 * kk + half];
          pa[half * 2] = pack_bf16(ex2(sj[0] - m0), ex2(sj[1] - m0));
          pa[half * 2 + 1] = pack_bf16(ex2(sj[2] - m1), ex2(sj[3] - m1));
          // the sums of the probabilities as rounded
          l0 += __uint_as_float(pa[half * 2] << 16) + __uint_as_float(pa[half * 2] & 0xffff0000u);
          l1 += __uint_as_float(pa[half * 2 + 1] << 16) +
                __uint_as_float(pa[half * 2 + 1] & 0xffff0000u);
        }
        const int key0 = (c0 + 2 * kk) * 8;
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, swz(V, key0 + (lane & 15), 2 * np + (lane >> 4)));
          mma16816(o[2 * np], pa, vb[0], vb[1]);
          mma16816(o[2 * np + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int q0 = rg * 16 + g, q1 = q0 + 8;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    if (q0 < N)
      *reinterpret_cast<uint32_t*>(swz(Q, q0, n) + t * 2) = pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (q1 < N)
      *reinterpret_cast<uint32_t*>(swz(Q, q1, n) + t * 2) = pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int WS>
__global__ void __launch_bounds__(Win<WS>::MAXW * 32, Win<WS>::MINB) tiny_attention_tma_kernel(
    const __grid_constant__ CUtensorMap map, const float* __restrict__ table,
    bf16* __restrict__ out, TaGeo g, float scale2) {
  using W = Win<WS>;
  constexpr int N = W::N, NP = W::NP, G = W::G, T = W::T;
  constexpr int PART = NP * TA_HD;  // elements of a part
  extern __shared__ __align__(128) unsigned char smem[];
  const TaLayout L = ta_layout<WS>(g.heads, g.nH);
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem + (base - raw);
  float* tab = reinterpret_cast<float*>(sm + L.tab);
  int* koff = reinterpret_cast<int*>(sm + L.koff);
  const uint32_t full = base + L.bars;
  const int parts = 3 * g.heads, tid = threadIdx.x, nthreads = blockDim.x;

  auto issue = [&](int u, int s) {
    const int win = u / g.hg, hgi = u - win * g.hg;
    const int wx = win % g.nwx, r = win / g.nwx, wy = r % g.nwy, b = r / g.nwy;
    const uint32_t bar = full + 8 * s;
    mbar_expect_tx(bar, (uint32_t)(parts * N * 64));
    for (int p = 0; p < parts; ++p) {
      const int h = hgi * g.heads + p / 3;
      tma_load_3d(base + (s * parts + p) * PART * 2, &map, bar, h * 3 * TA_HD + (p % 3) * TA_HD,
                  wx * WS, b * g.Hp + wy * WS);
    }
  };
  // the first unit's loads go out before the block stages its tables
  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if ((int)blockIdx.x < g.units) issue(blockIdx.x, 0);
  }
  // the bias tables of every head, in log2 units, by signed offset
  for (int i = tid; i < g.nH * T * T; i += nthreads) {
    const int h = i / (T * T), r = i - h * T * T;
    const int dy = abs(r / T - (WS - 1)), dx = abs(r % T - (WS - 1));
    tab[i] = table[h * N + dy * WS + dx] * LOG2E;
  }
  for (int k = tid; k < NP; k += nthreads) koff[k] = k < N ? (k / WS) * T + k % WS : 0;
  // rows N..NP of every part of both slots are zero (TMA writes rows < N)
  constexpr int PADV = (NP - N) * 4;  // 16-byte vectors of a part's pad rows
  for (int i = tid; i < 2 * parts * PADV; i += nthreads) {
    const int p = i / PADV;
    reinterpret_cast<uint4*>(sm + p * PART * 2 + N * 64)[i - p * PADV] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const long long ldo = (long long)g.nH * TA_HD;
  const int per_tok = g.heads * 4;  // 16-byte pieces of a token's output row
  int k = 0;
  for (int u = blockIdx.x; u < g.units; u += gridDim.x, ++k) {
    const int s = k & 1;
    // the other slot was read in the previous unit, which ended in a barrier
    if (tid == 0 && u + (int)gridDim.x < g.units) issue(u + gridDim.x, s ^ 1);
    const int win = u / g.hg, hgi = u - win * g.hg;
    mbar_wait(full + 8 * s, (k >> 1) & 1);
    bf16* slot = reinterpret_cast<bf16*>(sm + s * L.slot);
    for (int task = warp; task < g.heads * G; task += nwarps) {
      const int hl = task / G, rg = task - hl * G;
      bf16* P = slot + hl * 3 * PART;
      attend<WS>(P, P + PART, P + 2 * PART, tab + (hgi * g.heads + hl) * T * T, koff, rg, scale2,
                 lane);
    }
    __syncthreads();  // every output is in the slot's q rows
    const int wx = win % g.nwx, r = win / g.nwx, wy = r % g.nwy, b = r / g.nwy;
    bf16* dst = out + (long long)hgi * g.heads * TA_HD;
    for (int i = tid; i < N * per_tok; i += nthreads) {
      const int tok = i / per_tok, c = i - tok * per_tok;
      const int ty = tok / WS, tx = tok - ty * WS;
      const long long row = ((long long)b * g.Hp + wy * WS + ty) * g.Wp + wx * WS + tx;
      *reinterpret_cast<uint4*>(dst + row * ldo + c * 8) =
          *reinterpret_cast<const uint4*>(swz(slot + (c >> 2) * 3 * PART, tok, c & 3));
    }
    __syncthreads();  // slot s is free
  }
}

// ---------------------------------------------------------------------------
// f32: one warp per query row, SIMT
// ---------------------------------------------------------------------------
constexpr int F32_WARPS = 8;

// first row of window `win` (windows numbered b, wy, wx row-major) of the map
__device__ __forceinline__ long long window_row0(long long win, int Hp, int Wp, int WS) {
  const int nWx = Wp / WS, nWy = Hp / WS;
  const int wx = (int)(win % nWx);
  const long long r = win / nWx;
  const int wy = (int)(r % nWy);
  const long long b = r / nWy;
  return (b * Hp + (long long)wy * WS) * Wp + (long long)wx * WS;
}

template <int WS>
__host__ __device__ constexpr size_t f32_smem() {
  return sizeof(float) * (3 * Win<WS>::N * (TA_HD + 1) + F32_WARPS * Win<WS>::N + Win<WS>::N);
}

template <int WS>
__global__ void __launch_bounds__(F32_WARPS * 32) tiny_attention_f32_kernel(
    const float* __restrict__ qkv, const float* __restrict__ table, float* __restrict__ out,
    int Hp, int Wp, int nH, float scale) {
  constexpr int N = WS * WS, HD = TA_HD, LD = HD + 1;  // odd pitch: lanes on 32 banks
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + N * LD;
  float* Vs = Ks + N * LD;
  float* P = Vs + N * LD;  // one row of probabilities per warp
  float* tab = P + F32_WARPS * N;

  const int h = blockIdx.y;
  const long long row0 = window_row0(blockIdx.x, Hp, Wp, WS);
  const long long ld_in = 3LL * nH * HD, ld_out = (long long)nH * HD;
  const float* src = qkv + (long long)h * 3 * HD;
  for (int c = threadIdx.x; c < N * 3 * HD; c += blockDim.x) {
    const int tok = c / (3 * HD), part = c % (3 * HD), which = part / HD, d = part % HD;
    const float v = src[(row0 + (long long)(tok / WS) * Wp + tok % WS) * ld_in + part];
    (which == 0 ? Qs : which == 1 ? Ks : Vs)[tok * LD + d] = v;
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x) tab[i] = table[(long long)h * N + i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Pw = P + warp * N;
  for (int r = warp; r < N; r += F32_WARPS) {
    const int ry = r / WS, rx = r % WS;
    const float* q = Qs + r * LD;
    float mx = -INFINITY;
    for (int key = lane; key < N; key += 32) {
      const float* k = Ks + key * LD;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc = fmaf(q[d], k[d], acc);
      const float sv = acc * scale + tab[abs(ry - key / WS) * WS + abs(rx - key % WS)];
      Pw[key] = sv;
      mx = fmaxf(mx, sv);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int key = lane; key < N; key += 32) {
      const float p = expf(Pw[key] - mx);
      Pw[key] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    __syncwarp();
    float acc = 0.f;
    for (int key = 0; key < N; ++key) acc = fmaf(Pw[key], Vs[key * LD + lane], acc);
    out[(row0 + (long long)ry * Wp + rx) * ld_out + (long long)h * HD + lane] = acc / sum;
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps (cached on their whole key) and launches
// ---------------------------------------------------------------------------

struct CachedMap {
  const void* ptr;
  int B, Hp, Wp, C, WS;
  CUtensorMap map;
};
constexpr int kMapSlots = 256;
std::mutex g_map_mu;
CachedMap g_maps[kMapSlots];
int g_maps_encoded = 0;

// the qkv rows as (3C columns, Wp, B Hp map rows), a box of 32 columns x WS x WS
bool cached_map(CUtensorMap* out, const void* qkv, int B, int Hp, int Wp, int C, int WS) {
  std::lock_guard<std::mutex> lock(g_map_mu);
  CachedMap& e = g_maps[(((uintptr_t)qkv >> 8) ^ (uintptr_t)(Hp * 131 + C * 7 + WS)) % kMapSlots];
  if (e.ptr != qkv || e.B != B || e.Hp != Hp || e.Wp != Wp || e.C != C || e.WS != WS) {
    e.ptr = nullptr;
    EncodeTiled enc = encode_tiled();
    if (!enc) return false;
    const cuuint64_t pitch = (cuuint64_t)3 * C * 2;
    cuuint64_t dims[3] = {(cuuint64_t)3 * C, (cuuint64_t)Wp, (cuuint64_t)B * Hp};
    cuuint64_t strides[2] = {pitch, pitch * Wp};
    cuuint32_t box[3] = {(cuuint32_t)TA_HD, (cuuint32_t)WS, (cuuint32_t)WS};
    cuuint32_t elem[3] = {1, 1, 1};
    if (enc(&e.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(qkv), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return false;
    e.ptr = qkv;
    e.B = B; e.Hp = Hp; e.Wp = Wp; e.C = C; e.WS = WS;
    ++g_maps_encoded;
  }
  *out = e.map;
  return true;
}

// raises a kernel's dynamic shared-memory limit once per larger size seen
// (opened: the caller's record of that kernel's limit)
template <typename Kernel>
cudaError_t open_smem(Kernel kern, int bytes, std::mutex& mu, int& opened) {
  std::lock_guard<std::mutex> lock(mu);
  if (bytes <= opened) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) opened = bytes;
  return e;
}

template <int WS>
int launch_bf16(const void* qkv, const void* table, void* out, int B, int Hp, int Wp, int nH,
                float scale, int heads, int warps, int grid, cudaStream_t st) {
  using W = Win<WS>;
  if (heads < 1 || nH % heads || warps < 1 || warps > W::MAXW || grid < 1 ||
      ((uintptr_t)qkv | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  TaGeo g{B, Hp, Wp, nH, heads, nH / heads, Wp / WS, Hp / WS, 0};
  const long long units = (long long)B * g.nwy * g.nwx * g.hg;
  if (units >= (1ll << 31) || (long long)B * Hp >= (1ll << 31) || grid > units)
    return (int)cudaErrorInvalidValue;
  g.units = (int)units;
  const TaLayout L = ta_layout<WS>(heads, nH);
  if (L.bytes > (int)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (!cached_map(&map, qkv, B, Hp, Wp, nH * TA_HD, WS)) return (int)cudaErrorInvalidValue;
  static std::mutex mu;
  static int opened = 0;
  cudaError_t e = open_smem(tiny_attention_tma_kernel<WS>, L.bytes, mu, opened);
  if (e != cudaSuccess) return (int)e;
  tiny_attention_tma_kernel<WS><<<grid, warps * 32, L.bytes, st>>>(
      map, (const float*)table, (bf16*)out, g, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int WS>
int launch_f32(const void* qkv, const void* table, void* out, long long windows, int nH, int Hp,
               int Wp, float scale, cudaStream_t s) {
  constexpr size_t smem = f32_smem<WS>();
  static std::mutex mu;
  static int opened = 0;
  cudaError_t e = open_smem(tiny_attention_f32_kernel<WS>, (int)smem, mu, opened);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)windows, nH);
  tiny_attention_f32_kernel<WS><<<grid, F32_WARPS * 32, smem, s>>>(
      (const float*)qkv, (const float*)table, (float*)out, Hp, Wp, nH, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv (B * Hp * Wp, 3 nH hd) per-head [q | k | v]; table (nH, window^2) f32;
// out (B * Hp * Wp, nH hd). bf16: heads a unit (divides nH), warps a block
// (at most 8 at window 7, 13 at window 14), grid persistent blocks (at most
// one a unit), qkv and out 16-byte aligned, as ops/tiny_attention.py::
// tiny_attention_plan picks them; f32 ignores the three.
MSAM_EXPORT int msam_tiny_attention(const void* qkv, const void* table, void* out, int B, int Hp,
                                    int Wp, int nH, int window, int hd, float scale, int dtype,
                                    int heads, int warps, int grid, void* stream) {
  if (hd != TA_HD || B <= 0 || nH <= 0 || nH > 65535 || window <= 0 || Hp % window ||
      Wp % window)
    return (int)cudaErrorInvalidValue;
  const long long windows = (long long)B * (Hp / window) * (Wp / window);
  if (windows == 0) return 0;
  if (windows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MSAM_BF16) {
    switch (window) {
      case 7: return launch_bf16<7>(qkv, table, out, B, Hp, Wp, nH, scale, heads, warps, grid, s);
      case 14: return launch_bf16<14>(qkv, table, out, B, Hp, Wp, nH, scale, heads, warps, grid, s);
    }
  } else if (dtype == MSAM_F32) {
    switch (window) {
      case 7: return launch_f32<7>(qkv, table, out, windows, nH, Hp, Wp, scale, s);
      case 14: return launch_f32<14>(qkv, table, out, windows, nH, Hp, Wp, scale, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// the tensor maps encoded so far (cache misses)
MSAM_EXPORT int msam_tiny_attention_maps_encoded() { return g_maps_encoded; }

MSAM_ERROR_STRING(msam_tiny_attention)
