// Pieces shared by the rel-pos attention kernels: the forward
// (relpos_attention.cu) and its backward (relpos_attention_bwd.cu).
#pragma once

#include "common.cuh"

constexpr int KT = 64;  // keys per tile

__host__ __device__ constexpr size_t align128(size_t v) { return (v + 127) & ~size_t(127); }

// Where a (batch, token) pair of an operand lies. Plain (SP false): batch b
// at b * sb, token t at t * sn. Spatial (SP true, the forward's window
// mode): the operand is the row space of a padded (img, Hp, Wp) map of
// nwy x nwx windows of w x w tokens, batch b is window (img, wy, wx) in that
// order, and token t = (ty, tx) of it is map row
// ((img * nwy + wy) * w + ty) * (nwx * w) + wx * w + tx, at row * sn. The
// mode is a template parameter, so the plain instantiations carry none of
// the spatial arithmetic and no branch on it.
struct Geo {
  int w, nwy, nwx;
};

template <bool SP>
__device__ __forceinline__ long long batch_off(const Geo& g, int b, long long sb, long long sn) {
  if constexpr (!SP) {
    return b * sb;
  } else {
    const int per = g.nwy * g.nwx, img = b / per, r = b - img * per;
    const int wy = r / g.nwx, wx = r - wy * g.nwx;
    return (((long long)img * g.nwy + wy) * g.w * g.nwx * g.w + (long long)wx * g.w) * sn;
  }
}

template <bool SP>
__device__ __forceinline__ long long tok_off(const Geo& g, int t, long long sn) {
  if constexpr (!SP) {
    return (long long)t * sn;
  } else {
    const int ty = t / g.w;
    return ((long long)ty * g.nwx * g.w + (t - ty * g.w)) * sn;
  }
}

// rows [t0, t0 + ROWS) of a strided (token, HD) source into a padded smem
// tile, as 16-byte cp.async copies that are all in flight at once; rows past
// N are zero-filled. SP: tokens addressed as in tok_off's spatial mode.
template <typename T, int HD, int ROWS = 64, bool SP = false>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long sn, int t0, int N,
                                          Geo geo = Geo{0, 0, 0}) {
  constexpr int LDT = HD + 8;
  constexpr int CH = HD * sizeof(T) / 16;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CH; c += blockDim.x) {
    int r = c / CH, part = c % CH;
    int t = t0 + r;
    const char* g = t < N ? reinterpret_cast<const char*>(src + tok_off<SP>(geo, t, sn)) + part * 16
                          : reinterpret_cast<const char*>(src);
    cp_async16(reinterpret_cast<char*>(dst + r * LDT) + part * 16, g, t < N);
  }
}

// keys [k0, k0 + ROWS) of a key rectangle kw columns wide (key t at map
// row t / kw, column t % kw, token (t / kw) * pitch + t % kw of the
// rectangle's first token) into a padded smem tile; keys past nk
// zero-filled. With kw == pitch (whole rows) the keys are tokens k0...
template <typename T, int HD, int ROWS = 64, bool SP = false>
__device__ __forceinline__ void load_key_tile(T* dst, const T* src, long long sn, int k0, int nk,
                                              int kw, int pitch, Geo geo = Geo{0, 0, 0}) {
  constexpr int LDT = HD + 8;
  constexpr int CH = HD * sizeof(T) / 16;
  for (int c = threadIdx.x; c < ROWS * CH; c += blockDim.x) {
    const int r = c / CH, part = c % CH, t = k0 + r;
    const int ky = t / kw, tok = ky * pitch + (t - ky * kw);
    const char* g = t < nk ? reinterpret_cast<const char*>(src + tok_off<SP>(geo, tok, sn)) + part * 16
                           : reinterpret_cast<const char*>(src);
    cp_async16(reinterpret_cast<char*>(dst + r * LDT) + part * 16, g, t < nk);
  }
}

// 4-byte asynchronous global -> shared copy; src-size 0 zero-fills
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  int sz = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(sz));
}

// dot product of two HD-long rows (shared or device memory), 16 bytes at a
// time, in element order; bf16 pairs are taken from the 32-bit words by
// shifts (a local copy to index would put the words on the stack)
template <typename T, int HD>
__device__ __forceinline__ float dot_row(const T* qrow, const T* tab) {
  constexpr int E = 16 / sizeof(T);
  float acc = 0.f;
#pragma unroll 4
  for (int d0 = 0; d0 < HD; d0 += E) {
    uint4 a = *reinterpret_cast<const uint4*>(qrow + d0);
    uint4 b = __ldg(reinterpret_cast<const uint4*>(tab + d0));
    if constexpr (sizeof(T) == 2) {
      const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc = fmaf(__uint_as_float(aw[e] << 16), __uint_as_float(bw[e] << 16), acc);
        acc = fmaf(__uint_as_float(aw[e] & 0xffff0000u), __uint_as_float(bw[e] & 0xffff0000u), acc);
      }
    } else {
      const T* av = reinterpret_cast<const T*>(&a);
      const T* bv = reinterpret_cast<const T*>(&b);
#pragma unroll
      for (int e = 0; e < E; ++e) acc = fmaf(to_f32(av[e]), to_f32(bv[e]), acc);
    }
  }
  return acc;
}

// ---------------------------------------------------------------------------
// bf16 tensor-core pieces (PTX mma.sync m16n8k16; fragment coordinates
// g = lane / 4 is the row within 8, t = lane % 4 the column pair)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// B fragments (k16 x n8) of a row-major (k, n) smem tile, rows k0.., columns
// n0..: the transposed 8 x 8 loads a product with the k rows as its inner
// dimension needs
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* p) {
  unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1) : "r"(addr));
}

// A fragments (16 rows x HD) of a row-major smem tile with row pitch LDT
template <int HD, int LDT>
__device__ __forceinline__ void load_a_frags(uint32_t a[HD / 16][4], const __nv_bfloat16* rows,
                                             int g, int t) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    a[kk][0] = lds32(rows + g * LDT + kk * 16 + t * 2);
    a[kk][1] = lds32(rows + (g + 8) * LDT + kk * 16 + t * 2);
    a[kk][2] = lds32(rows + g * LDT + kk * 16 + t * 2 + 8);
    a[kk][3] = lds32(rows + (g + 8) * LDT + kk * 16 + t * 2 + 8);
  }
}

// ---------------------------------------------------------------------------
// row-aligned key tiles and u tables as tensor-core products, shared by the
// forward and the backward's bf16 kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// kernel variants (ops/relpos_attention.py: forward_plan, backward_plan)
enum { VAR_ROWS = 0, VAR_GENERAL = 1, VAR_WINDOW = 2 };

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory a block may take (227 KB)

// output columns a block computes: above head dim 128, a 128-column slice
// (a grid dimension), with the products over the full head dim recomputed
// per slice
template <int HD> __host__ __device__ constexpr int out_cols() { return HD > 128 ? 128 : HD; }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// ---------------------------------------------------------------------------
// key tiling (the same arithmetic as ops/relpos_attention.py::forward_plan)
// ---------------------------------------------------------------------------

struct Tiling {
  int wp;      // padded row: W rounded up to 8 slots
  int twp;     // slots of one row within a tile: min(wp, 64)
  int rows;    // map rows a tile holds: 64 / twp
  int segs;    // tiles across one row: 1 unless W > 64
  int ntiles;  // key tiles
  int uwo;     // offset of u_w in a u row: after the H u_h entries
  int uwl;     // u_w entries a row keeps: W, then -inf up to segs * twp
  int up;      // u row pitch (odd: the 8 rows of a fragment hit 8 banks)
};

__host__ __device__ inline Tiling tiling_of(int H, int W) {
  Tiling T;
  T.wp = (W + 7) & ~7;
  T.twp = T.wp < 64 ? T.wp : 64;
  T.rows = 64 / T.twp;
  T.segs = (T.wp + 63) / 64;
  T.ntiles = (H + T.rows - 1) / T.rows * T.segs;
  T.uwo = H;
  T.uwl = T.segs * T.twp;
  T.up = (T.uwo + T.uwl) | 1;
  return T;
}

struct TileAt {
  int ky0, kx0, nj;  // first map row, first column, n8 tiles of slots in use
};

__device__ __forceinline__ TileAt tile_at(const Tiling& T, int it, int H) {
  const int rb = it / T.segs, seg = it - rb * T.segs;
  TileAt a;
  a.ky0 = rb * T.rows;
  a.kx0 = seg * 64;
  a.nj = min(T.rows, H - a.ky0) * min(T.twp, T.wp - a.kx0) / 8;
  return a;
}

// nslots key slots (slot = r * twp + cx: key row ky0 + r, column kx0 + cx
// of the key rectangle, H x W, whose rows are pitch tokens apart) of a
// strided (token, COLS) source into smem rows of pitch LD, as 16-byte
// cp.async copies; slots outside the rectangle (r >= nrows, a row past H, a
// column past W) are zero-filled
template <int COLS, int LD, bool SP>
__device__ __forceinline__ void load_slots(bf16* dst, const bf16* src, long long sn, int nslots,
                                           int ky0, int kx0, int twp, int nrows, int H, int W,
                                           int pitch, const Geo& geo, int tid, int nthr) {
  constexpr int CH = COLS * (int)sizeof(bf16) / 16;
  const int rcp = (65536 + twp - 1) / twp;  // slot / twp as a product: exact for slot < 2^10
  for (int c = tid; c < nslots * CH; c += nthr) {
    const int slot = c / CH, part = c - slot * CH;
    const int r = (slot * rcp) >> 16, cx = slot - r * twp;
    const int ky = ky0 + r, kx = kx0 + cx;
    const bool ok = r < nrows && ky < H && kx < W;
    const char* g = ok ? reinterpret_cast<const char*>(src + tok_off<SP>(geo, ky * pitch + kx, sn)) + part * 16
                       : reinterpret_cast<const char*>(src);
    cp_async16(reinterpret_cast<char*>(dst + slot * LD) + part * 16, g, ok);
  }
}

// q rows [t0, t0 + nrows) into smem rows of pitch LD; rows past N zero-filled
template <int COLS, int LD, bool SP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long sn, int t0,
                                          int nrows, int N, const Geo& geo, int tid, int nthr) {
  constexpr int CH = COLS * (int)sizeof(bf16) / 16;
  for (int c = tid; c < nrows * CH; c += nthr) {
    const int r = c / CH, part = c - r * CH, t = t0 + r;
    const char* g = t < N ? reinterpret_cast<const char*>(src + tok_off<SP>(geo, t, sn)) + part * 16
                          : reinterpret_cast<const char*>(src);
    cp_async16(reinterpret_cast<char*>(dst + r * LD) + part * 16, g, t < N);
  }
}

// the nrows q rows of a patch of the map 8 cells wide (row r = py * 8 + px
// is map cell (qy0 + py, qx0 + px)) into smem rows of pitch LD; cells off
// the map zero-filled
template <int COLS, int LD, bool SP>
__device__ __forceinline__ void load_patch(bf16* dst, const bf16* src, long long sn, int nrows,
                                           int qy0, int qx0, int H, int W, const Geo& geo,
                                           int tid, int nthr) {
  constexpr int CH = COLS * (int)sizeof(bf16) / 16;
  for (int c = tid; c < nrows * CH; c += nthr) {
    const int r = c / CH, part = c - r * CH;
    const int qy = qy0 + (r >> 3), qx = qx0 + (r & 7);
    const bool ok = qy < H && qx < W;
    const char* g = ok ? reinterpret_cast<const char*>(src + tok_off<SP>(geo, qy * W + qx, sn)) + part * 16
                       : reinterpret_cast<const char*>(src);
    cp_async16(reinterpret_cast<char*>(dst + r * LD) + part * 16, g, ok);
  }
}

// ---------------------------------------------------------------------------
// u tables, in log2 units: row r of U belongs to smem q row r; over a key
// rectangle of KH rows and KW columns (the whole map unless the wrapper
// splits the keys): [0, KH) u_h, [uwo, uwo + KW) u_w, [uwo + KW, uwo + uwl)
// -inf (the padding columns of a key row); rows off the map hold 0 where a
// q row holds u. A tile's rows past KH are never read: its n8 tiles in use
// (nj) stop at the rectangle's last row.
// ---------------------------------------------------------------------------

// the -inf pads, and the zeros of the rows off the map: rows r >= nvalid
// (patch false: the window's q rows past N), or the cells of a patch 8 wide
// at (qy0, qx0) off the H x W map (patch true); the products fill the rest.
// kw: the key rectangle's columns
__device__ __forceinline__ void u_pads(float* U, const Tiling& T, int nrows, int nvalid, bool patch,
                                       int qy0, int qx0, int H, int W, int kw, int tid, int nthr) {
  const int len = T.uwo + T.uwl;
  for (int idx = tid; idx < nrows * len; idx += nthr) {
    const int r = idx / len, j = idx - r * len;
    const bool on_map = patch ? qy0 + (r >> 3) < H && qx0 + (r & 7) < W : r < nvalid;
    if (j >= T.uwo + kw) U[r * T.up + j] = -INFINITY;
    else if (!on_map) U[r * T.up + j] = 0.f;
  }
}

// One warp: u entries of up to 16 q rows that share one table, as a
// tensor-core product. Row i < ni of the product is smem q row
// row0 + i * rstride (pitch HD + 8), its u row the same index; its nb entries
// are (q row) . tab[j] (tab: nb rows of HD), written at column off.
template <int HD>
__device__ __forceinline__ void u_product(float* U, int up, int off, const bf16* Qs, int row0,
                                          int rstride, int ni, const bf16* tab, int nb, int lane) {
  constexpr int LDT = HD + 8, KS = HD / 16;
  const int g = lane >> 2, t = lane & 3;
  const int ai = min(lane & 15, ni - 1);  // the row this lane addresses for ldmatrix
  const bf16* arow = Qs + (row0 + ai * rstride) * LDT + (lane >> 4) * 8;
  for (int nb0 = 0; nb0 < nb; nb0 += 64) {
    float d[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
    const int nn = min(8, (nb - nb0 + 7) / 8);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, arow + kk * 16);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n < nn) {
          const int j = min(nb0 + n * 8 + g, nb - 1);
          const uint32_t* b = reinterpret_cast<const uint32_t*>(tab + (size_t)j * HD + kk * 16 + t * 2);
          mma16816(d[n], a, __ldg(b), __ldg(b + 4));
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = nb0 + n * 8 + t * 2 + e;
        if (n < nn && j < nb) {
          if (g < ni) U[(row0 + g * rstride) * up + off + j] = d[n][e] * LOG2E;
          if (g + 8 < ni) U[(row0 + (g + 8) * rstride) * up + off + j] = d[n][2 + e] * LOG2E;
        }
      }
    }
  }
}

// a thread's u_w terms for its key slots (n8 tile j, column 2t + e) of the
// tiles starting at column kx0, rows g (0, 1) and g + 8 (2, 3); -inf past
// the tile's rows. J < 8: the first J n8 tiles, where a tile's rows are
// 8 J slots wide (n8 tile j's terms are those of j % J)
template <int J = 8>
__device__ __forceinline__ void load_uw(float (&uw)[J][4], const float* U0, const float* U1,
                                        const Tiling& T, int kx0, int t) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = j * 8 + t * 2 + e;
      const int cx = c % T.twp;
      const bool ok = c < T.rows * T.twp;
      uw[j][e] = ok ? U0[T.uwo + kx0 + cx] : -INFINITY;
      uw[j][2 + e] = ok ? U1[T.uwo + kx0 + cx] : -INFINITY;
    }
  }
}

// the window variant's key slots: H padded rows of WP, rounded up to 16 with
// room for the last tile's k16 step
__host__ __device__ inline int window_slots(const Tiling& T, int H) {
  return (H * T.wp + 8 + 15) & ~15;
}
