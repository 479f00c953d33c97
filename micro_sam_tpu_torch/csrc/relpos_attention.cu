// Flash-style attention with the decomposed relative-position bias of the SAM
// ViT encoder:
//
//   out = softmax((q * hd^-0.5) k^T + bias) v,
//   bias[q, k] = u_h[q, ky(k)] + u_w[q, kx(k)],
//   u_h[q, j] = q . Rh[qy(q), j],  u_w[q, j] = q . Rw[qx(q), j]   (unscaled q)
//
// Replaces micro_sam_tpu/ops/flash_attention.py::_flash_kernel_qkv (reached
// through flash_attention_qkv) and the attention stage inside
// ops/fused_window_block.py::_fused_block_kernel / ::_fused_global_kernel.
// Built once per head dim (-DMSAM_HD=<hd>: 32, 64, 80, 96, 128 and 256), a
// library each, so that the builds run side by side. The key tiling, the
// loaders and the u products live in relpos_common.cuh, shared with the
// backward.
//
// Every pointer comes with element strides (batch, head, token; the head dim
// is contiguous), so the kernel reads q/k/v straight out of the qkv
// product's token-major rows and writes the rows the proj product reads.
// Spatial mode (Geo, relpos_common.cuh; the counterpart of the spatial window
// kernel fused_window_block.py::_fused_block_kernel(spatial=)): the batch
// index runs over the windows of a padded (img, Hp, Wp) token map and each
// window's tokens are gathered from the map's rows by index arithmetic in the
// loads and the store. Only addresses change, so a spatial launch equals the
// plain launch on the partitioned windows to the bit. The mode is a template
// parameter (SP).
//
// Bound on the H100: operations. A vit_b global launch (N = 4096, 12 heads,
// hd 64) is 4 N^2 hd nH = 52 GFLOP (53 us at 989 TFLOP/s) against 25 MB of
// q/k/v/out (7 us); a vit_b window launch (25 x 12 windows of 196 tokens)
// moves 30 MB for 3 GFLOP, so it is bound by bytes. What held the earlier
// design of this kernel (keys in tiles of 64 tokens, the bias gathered per
// logit) at 5 % of the tensor-core rate was not its products but the scalar
// work around them (measured on the card by taking pieces out: the bias, a
// division and four shared gathers per logit, 36 % of the global launch; the
// per-row u tables built by scalar dot products, 21 % of it and 54 % of the
// window launch). This design removes that work:
//
// * Keys are laid out by map row, each row padded to WP = W rounded up to 8
//   slots, and a key tile holds R = 64 / WP whole padded rows (the JAX
//   kernel's row-aligned block_k). A thread's key slots within an n8 tile of
//   the mma.sync m16n8k16 layout are 2t, 2t + 1, so its key columns kx are
//   the same in every tile: its u_w terms (times log2 e) live in 32
//   registers for the whole key loop, u_h is one shared load per q row per
//   tile when R = 1 (W > 32: every SAM ViT's global blocks) and one per n8
//   tile else, and there is no division in the loop. Padding slots carry -inf
//   in the u tables and a tile's n8 count stops at the map's last row, so
//   masking costs nothing. Each
//   logit is one FFMA (scale * log2 e folded, u_h folded into the row
//   maximum) and one ex2.approx; p is rounded to bf16 once, when packed.
// * The u tables are tensor-core products over q rows that share a table:
//   the q rows of a block are a patch of the map (16 x 8 cells on the
//   global grid), so the 8 cells of a patch row share Rh[qy] and the 16 of
//   a patch column Rw[qx]; a window's rows share them by map row and
//   column. The tables are read once a block from L2 (192 KB for a 16 x 8
//   patch at hd 64, against the 512 KB of Rw alone that a block of 64
//   consecutive q tokens would read); the products, ldmatrix gathering the
//   rows, measured 11 % of the global launch and 20 % of a window's.
// * k fragments come through ldmatrix.x4, v fragments through
//   ldmatrix.x4.trans, and k/v tiles through a cp.async ring of 3 slots (2
//   above head dim 80), one barrier per tile, each thread's slot arithmetic for the tile loads done
//   once (TileChunks, up to hd 80). A full tile (8 n8 tiles of slots) runs a
//   guard-free copy of the loop, so the scheduler interleaves its products;
//   the ragged last tiles of a window take the guarded one.
//
// Variants (chosen in ops/relpos_attention.py::forward_plan, checked here):
// * VAR_ROWS (W <= 64): one block per (patch, head, batch), 8 warps over a
//   16 x 8 patch (4 warps over 8 x 8 above head dim 128 or a map side above
//   64), the key tiles above streamed through the ring. The tile loads are
//   still about a quarter of the global launch (measured by taking them
//   out).
// * VAR_WINDOW (H * WP <= 256, head dim <= 128, and the resident window
//   within the 227 KB of shared memory a block may take: the 14 x 14 windows
//   of every SAM ViT and the tiled path, not a 16 x 16 window at head dim
//   128, which takes VAR_ROWS): one block of 8 warps per (window, head)
//   loads the window's q, then k and v, once (keys padded to 14 x 16 = 224
//   slots, not to the 256 of four 64-key tiles), builds its u tables while k
//   and v are in flight, and its warps walk the window's 13 m16 q tiles
//   against the resident keys. Bound by bytes; what remains is latency (one
//   block an SM: 122 KB of shared memory and 200 registers a thread at hd 64).
// * VAR_GENERAL (W > 64): as VAR_ROWS with tiles of 64-slot segments of
//   one row; u_w is reloaded from shared memory per tile (the per-column
//   path).
// Head dims above 128 (built at 256): the block computes the logits over the
// full head dim with q fragments read from shared memory per k step, and
// accumulates p v for one 128-column slice of the output, the slice a grid
// dimension; each slice's columns are written once.
//
// Row statistics: handed an lse buffer, each variant (and the f32 kernel)
// stores each row's log-sum-exp of the logits once, at the end (natural
// units, from the running maximum and sum; slice 0 only): the backward's
// row statistics, so that it does not walk the keys again. Null stores
// nothing (the serving path).
//
// Key rectangles: a launch attends over the keys of one rectangle of the
// key map (first row ky0, first column kx0, KH x KW; the whole map unless
// the wrapper splits it), and its u tables hold that rectangle's KH + KW
// entries a q row, so the rows / general variants' shared memory does not
// grow with the map: ops/relpos_attention.py::forward_plan splits a map
// whose tables would not fit into rectangles that do (no SAM ViT's 64 x 64
// or 14 x 14 grid needs it; a 336 x 336 grid of img_size 5376 does). Handed
// lse_prev (the log-sum-exps of the rectangles before), a launch merges its
// partial output into the output of those rectangles (out = out_prev w_prev
// + o w, the weights exp(lse_prev - lse) and exp(lse_r - lse)) and stores
// the joint lse: the same softmax, one more rounding of the output a
// rectangle.
//
// ptxas (-Xptxas -v, sm_90a): no instantiation spills or keeps a stack
// frame. Registers, rows / general / window, plain mode (spatial mode):
// hd 32 155 / 150 / 154 (174 / 170 / 165); hd 64 195 / 197 / 187 (219 / 220 /
// 206); hd 80 210 / 212 / 200 (252 / 252 / 222); hd 96 251 / 251 / 220 (250 /
// 250 / 241); hd 128 213 / 211 / 215 (218 / 216 / 246); hd 256 218 / 218
// (222 / 222); the f32 kernel 125-151.
// Shared memory, dynamic, one block an SM in all: rows at the global grid
// 137 KB (hd 64), 153 KB (80), 143 KB (96), 167 KB (128), 165 KB (256, 8 x 8
// patch); window 14 x 14: 122 KB (64), 143 KB (80), 165 KB (96), 208 KB (128).
//
// The f32 kernel is a plain SIMT loop over 64-token key tiles, kept for holding
// the kernel path against the plain one at a tight tolerance; above head dim
// 128 it takes 32 q rows a block and one 128-column output slice.
#include "relpos_common.cuh"

#ifndef MSAM_HD
#error "build with -DMSAM_HD=<head dim>"
#endif

// A thread's 16-byte chunks of the 64-slot k and v tiles (the same columns
// when the head dim is one output slice), with load_slots's slot arithmetic
// done once: the chunk's smem offset and column offset, its slot's row r and
// column cx within the tile (-1: a slot past the tile's rows, zero-filled;
// -2: no chunk). Each tile then costs a few adds and compares a chunk.
template <int HD>
struct TileChunks {
  static constexpr int CH = HD * (int)sizeof(bf16) / 16, NC = (64 * CH + 127) / 128;
  int dst[NC];  // smem element offset | column element offset << 16
  int rc[NC];   // r | cx << 8, or -1 / -2

  __device__ __forceinline__ void init(const Tiling& T, int tid, int nthr) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = tid + i * nthr;
      const int slot = c / CH, part = c - slot * CH;
      const int r = slot / T.twp, cx = slot - r * T.twp;
      dst[i] = (slot * (HD + 8) + part * 8) | (part * 8) << 16;
      rc[i] = c >= 64 * CH ? -2 : r < T.rows ? r | cx << 8 : -1;
    }
  }

  template <bool SP>
  __device__ __forceinline__ void issue(bf16* Ks, bf16* Vs, const bf16* kb, const bf16* vb,
                                        long long ksn, long long vsn, int ky0, int kx0, int H,
                                        int W, int pitch, const Geo& geo) const {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (rc[i] == -2) continue;
      const int ky = ky0 + (rc[i] & 0xff), kx = kx0 + (rc[i] >> 8);
      const bool ok = rc[i] >= 0 && ky < H && kx < W;
      const int d = dst[i] & 0xffff, p = dst[i] >> 16, tok = ky * pitch + kx;
      cp_async16(Ks + d, ok ? kb + tok_off<SP>(geo, tok, ksn) + p : kb, ok);
      cp_async16(Vs + d, ok ? vb + tok_off<SP>(geo, tok, vsn) + p : vb, ok);
    }
  }
};

// ---------------------------------------------------------------------------
// bf16: one warp, 16 q rows against one key tile, everything in registers
// ---------------------------------------------------------------------------

// FULL: all 8 n8 tiles of slots in use (nj == 8), so the loops carry no
// guard and the scheduler may interleave the products freely
template <int HD, int NV, bool QREG, bool FULL>
__device__ __forceinline__ void attend(float (&o)[NV / 8][4], float& m0, float& m1, float& l0,
                                       float& l1, const uint32_t (&qa)[QREG ? HD / 16 : 1][4],
                                       const bf16* Qw, const bf16* Ks, const bf16* Vs, int nj_,
                                       const float (&uw)[8][4], const float* U0, const float* U1,
                                       int ky0, const int (&jy)[8], bool one_row, float c2,
                                       int lane) {
  constexpr int KS = HD / 16, LDK = HD + 8, LDV = NV + 8, NT = NV / 8;
  const int nj = FULL ? 8 : nj_;
  // s = q k^T over the tile's nj n8 tiles of key slots
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4];
    if constexpr (QREG) {
      a[0] = qa[kk][0]; a[1] = qa[kk][1]; a[2] = qa[kk][2]; a[3] = qa[kk][3];
    } else {
      ldsm_x4(a, Qw + (lane & 15) * LDK + kk * 16 + (lane >> 4) * 8);
    }
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      if (j < nj) {
        uint32_t b[4];
        ldsm_x4(b, Ks + ((j + (lane >> 4)) * 8 + (lane & 7)) * LDK + kk * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[j], a, b[0], b[1]);
        mma16816(s[j + 1], a, b[2], b[3]);
      }
    }
  }

  // logits in log2 units, x = s * scale * log2 e + u_w (+ u_h of the slot's
  // row when the tile holds several rows; with one row u_h is folded into
  // the row maximum); masked slots are -inf through u_w / u_h
  float h0 = 0.f, h1 = 0.f;
  if (one_row) {
    h0 = U0[ky0];
    h1 = U1[ky0];
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < nj) {
      float b0 = uw[j][0], b1 = uw[j][1], b2 = uw[j][2], b3 = uw[j][3];
      if (!one_row) {
        const float y0 = U0[ky0 + jy[j]], y1 = U1[ky0 + jy[j]];
        b0 += y0; b1 += y0; b2 += y1; b3 += y1;
      }
      s[j][0] = fmaf(s[j][0], c2, b0);
      s[j][1] = fmaf(s[j][1], c2, b1);
      s[j][2] = fmaf(s[j][2], c2, b2);
      s[j][3] = fmaf(s[j][3], c2, b3);
    } else {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = -INFINITY;
    }
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0 + h0), mn1 = fmaxf(m1, mx1 + h1);
  const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
  const float ng0 = mn0 - h0, ng1 = mn1 - h1;

  // p = 2^(x - m), packed to bf16 straight into A fragments; the row sums
  // stay per thread until the end
  uint32_t pa[4][4];
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p0 = ex2(s[j][0] - ng0), p1 = ex2(s[j][1] - ng0);
    const float p2 = ex2(s[j][2] - ng1), p3 = ex2(s[j][3] - ng1);
    ps0 += p0 + p1;
    ps1 += p2 + p3;
    pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
  }
  l0 = l0 * al0 + ps0;
  l1 = l1 * al1 + ps1;
  m0 = mn0;
  m1 = mn1;

  // o = o * alpha + p v
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    o[n][0] *= al0; o[n][1] *= al0; o[n][2] *= al1; o[n][3] *= al1;
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (2 * kk < nj) {
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, Vs + (kk * 16 + (lane & 15)) * LDV + (n + (lane >> 4)) * 8);
        mma16816(o[n], pa[kk], b[0], b[1]);
        mma16816(o[n + 1], pa[kk], b[2], b[3]);
      }
    }
  }
}

template <int HD, int NV, bool QREG>
__device__ __forceinline__ void attend_tile(float (&o)[NV / 8][4], float& m0, float& m1,
                                            float& l0, float& l1,
                                            const uint32_t (&qa)[QREG ? HD / 16 : 1][4],
                                            const bf16* Qw, const bf16* Ks, const bf16* Vs,
                                            int nj, const float (&uw)[8][4], const float* U0,
                                            const float* U1, int ky0, const int (&jy)[8],
                                            bool one_row, float c2, int lane) {
  if (nj == 8)
    attend<HD, NV, QREG, true>(o, m0, m1, l0, l1, qa, Qw, Ks, Vs, nj, uw, U0, U1, ky0, jy,
                               one_row, c2, lane);
  else
    attend<HD, NV, QREG, false>(o, m0, m1, l0, l1, qa, Qw, Ks, Vs, nj, uw, U0, U1, ky0, jy,
                                one_row, c2, lane);
}

// the weights that merge a row's partial result (log-sum-exp L, log2 units)
// into the result of the key rectangles before it (lse_prev p, natural
// units): out = out * inv + out_prev * keep, L becomes the joint one
__device__ __forceinline__ void merge_weights(float& L, float& inv, float& keep, float p) {
  const float p2 = p * LOG2E, M = fmaxf(L, p2);
  const float wr = ex2(L - M), wp = ex2(p2 - M), s = wr + wp;
  inv *= wr / s;
  keep = wp / s;
  L = M + log2f(s);
}

// tokens tok0 (row g) and tok1 (row g + 8) of the warp's output, normalized;
// a row off the map (ok false) is not written. lse (the (batch, head)'s row
// of log-sum-exps, or null): each row's log-sum-exp, natural units, from the
// running maximum m (log2 units) and sum l. lprev (or null): the rows'
// log-sum-exps of the key rectangles before this one, whose output the rows
// are merged into
template <int NV, bool SP>
__device__ __forceinline__ void store_rows(bf16* ob, long long osn, const Geo& geo,
                                           float (&o)[NV / 8][4], float m0, float m1, float l0,
                                           float l1, int tok0, bool ok0, int tok1, bool ok1,
                                           float* lse, const float* lprev, int t) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  float L0 = m0 + log2f(l0), L1 = m1 + log2f(l1);
  float inv0 = 1.f / l0, inv1 = 1.f / l1, keep0 = 0.f, keep1 = 0.f;
  if (lprev != nullptr) {
    if (ok0) merge_weights(L0, inv0, keep0, lprev[tok0]);
    if (ok1) merge_weights(L1, inv1, keep1, lprev[tok1]);
  }
  if (lse != nullptr && t == 0) {
    if (ok0) lse[tok0] = L0 * LN2;
    if (ok1) lse[tok1] = L1 * LN2;
  }
#pragma unroll
  for (int n = 0; n < NV / 8; ++n) {
    const int d = n * 8 + t * 2;
    if (ok0) {
      uint32_t* p = reinterpret_cast<uint32_t*>(ob + tok_off<SP>(geo, tok0, osn) + d);
      float a = o[n][0] * inv0, b = o[n][1] * inv0;
      if (lprev != nullptr) {
        const uint32_t old = *p;
        a = fmaf(__uint_as_float(old << 16), keep0, a);
        b = fmaf(__uint_as_float(old & 0xffff0000u), keep0, b);
      }
      *p = pack_bf16(a, b);
    }
    if (ok1) {
      uint32_t* p = reinterpret_cast<uint32_t*>(ob + tok_off<SP>(geo, tok1, osn) + d);
      float a = o[n][2] * inv1, b = o[n][3] * inv1;
      if (lprev != nullptr) {
        const uint32_t old = *p;
        a = fmaf(__uint_as_float(old << 16), keep1, a);
        b = fmaf(__uint_as_float(old & 0xffff0000u), keep1, b);
      }
      *p = pack_bf16(a, b);
    }
  }
}

// k/v ring slots: 3 up to head dim 80, 2 above (shared memory). With the
// 16-row patches below, the global launch at hd 80 measured 5-12 % faster
// than with 2 slots and 8-row patches; at hd 64 the two are within 1 %.
template <int HD> __host__ __device__ constexpr int ring() { return HD <= 80 ? 3 : 2; }

// map rows of a tiled block's q patch (8 columns wide): 16 (8 warps, each
// k/v tile read for 128 q rows) where the head dim and the u tables allow,
// else 8 (4 warps)
__host__ __device__ inline int patch_rows(int hd, int H, int W) {
  return hd <= 128 && H <= 64 && W <= 64 ? 16 : 8;
}

// the map is H x W, its key rectangle KH x KW (the window variant: the whole map)
template <int HD>
__host__ __device__ size_t bf16_smem(int var, int N, int H, int W, int KH, int KW) {
  constexpr int LDK = HD + 8, LDV = out_cols<HD>() + 8;
  const Tiling T = tiling_of(KH, KW);
  if (var == VAR_WINDOW) {
    const int NS = window_slots(T, H), NQ = (N + 15) & ~15;
    return align128(sizeof(bf16) * ((size_t)NS * (LDK + LDV) + (size_t)NQ * LDK)) +
           sizeof(float) * (size_t)NQ * T.up;
  }
  const int QR = 8 * patch_rows(HD, H, W);
  return align128(sizeof(bf16) * (QR * LDK + ring<HD>() * 64 * (LDK + LDV))) +
         sizeof(float) * QR * (size_t)T.up;
}

// (256, 1): with the block size alone ptxas held the head-dim-32 window
// kernel to 128 registers and spilled
template <int HD, bool SP, int VAR>
__global__ void __launch_bounds__(256, 1) relpos_attention_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ rh, const bf16* __restrict__ rw, bf16* __restrict__ out,
    float* __restrict__ lse, const float* __restrict__ lse_prev, int N, int H, int W, int KH,
    int KW, long long qsb, long long qsh, long long qsn, long long ksb, long long ksh,
    long long ksn, long long vsb, long long vsh, long long vsn, long long osb, long long osh,
    long long osn, float scale, Geo geo) {
  constexpr int NV = out_cols<HD>(), NSL = HD / NV;
  // q fragments in registers up to head dim 96; above, read from shared
  // memory per k step (at 128 the spatial rows kernel spilled at 255
  // registers with them held)
  constexpr bool QREG = HD <= 96;
  constexpr int LDK = HD + 8, LDV = NV + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiling T = tiling_of(KH, KW);  // the window variant: KH, KW = H, W
  const float c2 = scale * LOG2E;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y / NSL, sl = blockIdx.y - h * NSL, b = blockIdx.z;
  const bf16* qb = q + batch_off<SP>(geo, b, qsb, qsn) + h * qsh;
  const bf16* kb = k + batch_off<SP>(geo, b, ksb, ksn) + h * ksh;
  const bf16* vb = v + batch_off<SP>(geo, b, vsb, vsn) + h * vsh + sl * NV;
  bf16* ob = out + batch_off<SP>(geo, b, osb, osn) + h * osh + sl * NV;
  const size_t bh = (size_t)b * (gridDim.y / NSL) + h;
  float* lb = lse != nullptr && sl == 0 ? lse + bh * N : nullptr;
  const float* lp = lse_prev != nullptr ? lse_prev + bh * N : nullptr;
  int jy[8];  // the padded row (within a tile) of each n8 tile of slots
#pragma unroll
  for (int j = 0; j < 8; ++j) jy[j] = j * 8 / T.twp;
  const bool one_row = T.rows == 1;

  if constexpr (VAR == VAR_WINDOW) {
    // the whole window resident: k, v (slot = ky * WP + kx), q, u
    const int NS = window_slots(T, H), NQ = (N + 15) & ~15;
    bf16* Ks = reinterpret_cast<bf16*>(smem);
    bf16* Vs = Ks + NS * LDK;
    bf16* Qs = Vs + NS * LDV;
    float* U = reinterpret_cast<float*>(
        smem + align128(sizeof(bf16) * ((size_t)NS * (LDK + LDV) + (size_t)NQ * LDK)));
    load_rows<HD, LDK, SP>(Qs, qb, qsn, 0, NQ, N, geo, threadIdx.x, blockDim.x);
    cp_async_commit();
    load_slots<HD, LDK, SP>(Ks, kb, ksn, NS, 0, 0, T.wp, H, H, W, W, geo, threadIdx.x, blockDim.x);
    load_slots<NV, LDV, SP>(Vs, vb, vsn, NS, 0, 0, T.wp, H, H, W, W, geo, threadIdx.x, blockDim.x);
    cp_async_commit();
    // the pads and the rows past N while the copies fly; the products
    // wait for q alone, k and v still in flight
    u_pads(U, T, NQ, N, false, 0, 0, H, W, W, threadIdx.x, blockDim.x);
    cp_async_wait<1>();
    __syncthreads();
    // u by products: per map row y (its W q rows share Rh[y]), per map
    // column x (its H q rows share Rw[x]), in pieces of 16 rows
    const int ph = (W + 15) / 16, pw = (H + 15) / 16;
    for (int item = warp; item < H * ph + W * pw; item += blockDim.x / 32) {
      if (item < H * ph) {
        const int y = item / ph, p = item - y * ph;
        u_product<HD>(U, T.up, 0, Qs, y * W + p * 16, 1, min(16, W - p * 16),
                      rh + (size_t)y * H * HD, H, lane);
      } else {
        const int x = (item - H * ph) / pw, p = item - H * ph - x * pw;
        u_product<HD>(U, T.up, T.uwo, Qs, p * 16 * W + x, W, min(16, H - p * 16),
                      rw + (size_t)x * W * HD, W, lane);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int qt = warp; qt * 16 < N; qt += blockDim.x / 32) {
      const bf16* Qw = Qs + qt * 16 * LDK;
      uint32_t qa[QREG ? HD / 16 : 1][4];
      if constexpr (QREG) load_a_frags<HD, LDK>(qa, Qw, g, t);
      const float* U0 = U + (qt * 16 + g) * T.up;
      const float* U1 = U0 + 8 * T.up;
      float uw[8][4];
      load_uw(uw, U0, U1, T, 0, t);
      float o[NV / 8][4];
#pragma unroll
      for (int n = 0; n < NV / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
      for (int it = 0; it < T.ntiles; ++it) {
        const int ky0 = it * T.rows;
        const int nj = min(T.rows, H - ky0) * T.wp / 8;
        attend_tile<HD, NV, QREG>(o, m0, m1, l0, l1, qa, Qw, Ks + ky0 * T.wp * LDK,
                                  Vs + ky0 * T.wp * LDV, nj, uw, U0, U1, ky0, jy, one_row, c2,
                                  lane);
      }
      const int r0 = qt * 16 + g;
      store_rows<NV, SP>(ob, osn, geo, o, m0, m1, l0, l1, r0, r0 < N, r0 + 8, r0 + 8 < N, lb, lp, t);
    }
  } else {
    constexpr int ST = ring<HD>();
    // the block's q rows: a PY x 8 patch of the map (row r = cell (r / 8,
    // r % 8)), so that its rows share Rh[qy] by map row and Rw[qx] by map
    // column; two patch rows a warp
    const int PY = blockDim.x / 16, QR = 8 * PY;
    bf16* Qs = reinterpret_cast<bf16*>(smem);
    bf16* Kb = Qs + QR * LDK;
    bf16* Vb = Kb + ST * 64 * LDK;
    float* U = reinterpret_cast<float*>(
        smem + align128(sizeof(bf16) * (QR * LDK + ST * 64 * (LDK + LDV))));
    const int pnx = (W + 7) / 8;
    const int qy0 = blockIdx.x / pnx * PY, qx0 = (blockIdx.x % pnx) * 8;
    // head dims up to 80: the tile loads' slot arithmetic once (TileChunks);
    // above, per tile (load_slots), where TileChunks would cost the registers
    constexpr bool CHUNKS = HD <= 80;
    TileChunks<CHUNKS ? HD : 16> chunks;
    if constexpr (CHUNKS) chunks.init(T, threadIdx.x, blockDim.x);
    // key tiles of the rectangle (rows W tokens apart in the map)
    auto issue = [&](int it, int slot) {
      const TileAt a = tile_at(T, it, KH);
      if constexpr (CHUNKS) {
        chunks.template issue<SP>(Kb + slot * 64 * LDK, Vb + slot * 64 * LDV, kb, vb, ksn, vsn,
                                  a.ky0, a.kx0, KH, KW, W, geo);
      } else {
        load_slots<HD, LDK, SP>(Kb + slot * 64 * LDK, kb, ksn, 64, a.ky0, a.kx0, T.twp, T.rows,
                                KH, KW, W, geo, threadIdx.x, blockDim.x);
        load_slots<NV, LDV, SP>(Vb + slot * 64 * LDV, vb, vsn, 64, a.ky0, a.kx0, T.twp, T.rows,
                                KH, KW, W, geo, threadIdx.x, blockDim.x);
      }
    };
    load_patch<HD, LDK, SP>(Qs, qb, qsn, QR, qy0, qx0, H, W, geo, threadIdx.x, blockDim.x);
    cp_async_commit();
#pragma unroll
    for (int s = 0; s < ST - 1; ++s) {
      if (s < T.ntiles) issue(s, s);
      cp_async_commit();
    }
    cp_async_wait<ST - 1>();
    __syncthreads();
    // u by products: patch row py (its 8 cells share Rh[qy0 + py]), patch
    // column px (its PY cells share Rw[qx0 + px]), over the rectangle's KH
    // rows and KW columns (rh, rw start at its first row / column)
    u_pads(U, T, QR, 0, true, qy0, qx0, H, W, KW, threadIdx.x, blockDim.x);
    const int nx = min(8, W - qx0), ny = min(PY, H - qy0);
    for (int item = warp; item < PY + 8; item += blockDim.x / 32) {
      if (item < PY) {
        if (item < ny)
          u_product<HD>(U, T.up, 0, Qs, item * 8, 1, nx, rh + (size_t)(qy0 + item) * H * HD, KH,
                        lane);
      } else if (item - PY < nx) {
        u_product<HD>(U, T.up, T.uwo, Qs, item - PY, 8, ny,
                      rw + (size_t)(qx0 + item - PY) * W * HD, KW, lane);
      }
    }
    __syncthreads();

    const bf16* Qw = Qs + warp * 16 * LDK;
    uint32_t qa[QREG ? HD / 16 : 1][4];
    if constexpr (QREG) load_a_frags<HD, LDK>(qa, Qw, g, t);
    const float* U0 = U + (warp * 16 + g) * T.up;
    const float* U1 = U0 + 8 * T.up;
    float uw[8][4];
    if constexpr (VAR == VAR_ROWS) load_uw(uw, U0, U1, T, 0, t);
    float o[NV / 8][4];
#pragma unroll
    for (int n = 0; n < NV / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    for (int it = 0; it < T.ntiles; ++it) {
      cp_async_wait<ST - 2>();
      __syncthreads();  // tile it is visible; the slot of tile it - 1 is free
      if (it + ST - 1 < T.ntiles) issue(it + ST - 1, (it + ST - 1) % ST);
      cp_async_commit();
      const TileAt a = tile_at(T, it, KH);
      if constexpr (VAR == VAR_GENERAL) load_uw(uw, U0, U1, T, a.kx0, t);
      const int slot = it % ST;
      attend_tile<HD, NV, QREG>(o, m0, m1, l0, l1, qa, Qw, Kb + slot * 64 * LDK,
                                Vb + slot * 64 * LDV, a.nj, uw, U0, U1, a.ky0, jy, one_row, c2,
                                lane);
    }
    // rows g and g + 8 of the warp: patch cells (2 warp, g) and (2 warp + 1, g)
    const int qx = qx0 + g, qy = qy0 + 2 * warp;
    store_rows<NV, SP>(ob, osn, geo, o, m0, m1, l0, l1, qy * W + qx, qx < W && qy < H,
                       (qy + 1) * W + qx, qx < W && qy + 1 < H, lb, lp, t);
  }
}

// ---------------------------------------------------------------------------
// f32: the same loop with SIMT products, logits and output in shared memory
// ---------------------------------------------------------------------------
constexpr int LDSS = KT + 4;

template <int HD> __host__ __device__ constexpr int f32_rows() { return HD > 128 ? 32 : 64; }

template <int HD>
__host__ __device__ constexpr size_t f32_head(void) {
  constexpr int QR = f32_rows<HD>(), NV = out_cols<HD>();
  return align128(sizeof(float) * (QR * (HD + 8) + 64 * (HD + 8) + 64 * (NV + 8) + 2 * QR * LDSS +
                                   QR * (NV + 4)));
}

// u rows over a KH x KW key rectangle
template <int HD>
__host__ __device__ constexpr size_t f32_smem(int KH, int KW) {
  return f32_head<HD>() + sizeof(float) * f32_rows<HD>() * (KH + KW + 1);
}

// U[r * up + j] = q_r . Rh[qy, j] (j < KH), q_r . Rw[qx, j - KH] (j >= KH)
// for nrows q rows of the H x W map, by scalar dot products; rh / rw start
// at the key rectangle's first row / column
template <typename T, int HD>
__device__ __forceinline__ void build_u_rows(float* U, int up, const T* Qs, const T* rh,
                                             const T* rw, int q0, int nrows, int N, int H, int W,
                                             int KH, int KW) {
  constexpr int LDT = HD + 8;
  const int HW = KH + KW;
  for (int idx = threadIdx.x; idx < nrows * HW; idx += blockDim.x) {
    int r = idx / HW, j = idx % HW, qi = q0 + r;
    float acc = 0.f;
    if (qi < N) {
      const T* tab = j < KH ? rh + ((size_t)(qi / W) * H + j) * HD
                            : rw + ((size_t)(qi % W) * W + (j - KH)) * HD;
      acc = dot_row<T, HD>(Qs + r * LDT, tab);
    }
    U[r * up + j] = acc;
  }
}

// (128, 1): without the minimum of one block an SM, ptxas holds the kernel
// to 72-80 registers and spills at head dims 96 and 128
template <int HD, bool SP>
__global__ void __launch_bounds__(128, 1) relpos_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ rh, const float* __restrict__ rw, float* __restrict__ out,
    float* __restrict__ lse, const float* __restrict__ lse_prev, int N, int H, int W, int KH,
    int KW, long long qsb, long long qsh, long long qsn,
    long long ksb, long long ksh, long long ksn, long long vsb, long long vsh, long long vsn, long long osb,
    long long osh, long long osn, float scale, Geo geo) {
  constexpr int QR = f32_rows<HD>(), NV = out_cols<HD>(), NSL = HD / NV;
  constexpr int LDT = HD + 8, LDV = NV + 8, LDO = NV + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + QR * LDT;
  float* Vs = Ks + 64 * LDT;
  float* Ss = Vs + 64 * LDV;
  float* Ps = Ss + QR * LDSS;
  float* Os = Ps + QR * LDSS;
  float* U = reinterpret_cast<float*>(smem + f32_head<HD>());
  const int UP = KH + KW + 1, NK = KH * KW;

  const int q0 = blockIdx.x * QR, h = blockIdx.y / NSL, sl = blockIdx.y - h * NSL, b = blockIdx.z;
  const float* qb = q + batch_off<SP>(geo, b, qsb, qsn) + h * qsh;
  const float* kb = k + batch_off<SP>(geo, b, ksb, ksn) + h * ksh;
  const float* vb = v + batch_off<SP>(geo, b, vsb, vsn) + h * vsh + sl * NV;
  float* ob = out + batch_off<SP>(geo, b, osb, osn) + h * osh + sl * NV;

  load_tile<float, HD, QR, SP>(Qs, qb, qsn, q0, N, geo);
  cp_async_commit();
  for (int i = threadIdx.x; i < QR * LDO; i += blockDim.x) Os[i] = 0.f;
  cp_async_wait<0>();
  __syncthreads();
  build_u_rows<float, HD>(U, UP, Qs, rh, rw, q0, QR, N, H, W, KH, KW);

  // each warp owns 16 rows and walks them one at a time; a lane holds keys
  // (lane, lane + 32) of the tile and dims (lane, lane + 32, ...)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Sw = Ss + warp * 16 * LDSS;
  float* Pw = Ps + warp * 16 * LDSS;
  float* Ow = Os + warp * 16 * LDO;
  const float* Qw = Qs + warp * 16 * LDT;
  const float* Uw = U + warp * 16 * UP;
  float m[16], l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) { m[r] = -INFINITY; l[r] = 0.f; }

  for (int k0 = 0; k0 < NK; k0 += KT) {
    __syncthreads();  // previous tile consumed (and U complete on entry)
    load_key_tile<float, HD, 64, SP>(Ks, kb, ksn, k0, NK, KW, W, geo);
    load_key_tile<float, NV, 64, SP>(Vs, vb, vsn, k0, NK, KW, W, geo);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int r = 0; r < 16; ++r) {
      for (int c = lane; c < KT; c += 32) {
        float acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) acc = fmaf(Qw[r * LDT + d], Ks[c * LDT + d], acc);
        Sw[r * LDSS + c] = acc;
      }
    }
    __syncwarp();
    const int key0 = k0 + lane, key1 = key0 + 32;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float* Ur = Uw + r * UP;
      float s0 = -INFINITY, s1 = -INFINITY;
      if (key0 < NK) s0 = Sw[r * LDSS + lane] * scale + Ur[key0 / KW] + Ur[KH + key0 % KW];
      if (key1 < NK) s1 = Sw[r * LDSS + lane + 32] * scale + Ur[key1 / KW] + Ur[KH + key1 % KW];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      Pw[r * LDSS + lane] = p0;
      Pw[r * LDSS + lane + 32] = p1;
      float ps = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
      for (int d = lane; d < NV; d += 32) Ow[r * LDO + d] *= alpha;
    }
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      for (int d = lane; d < NV; d += 32) {
        float acc = Ow[r * LDO + d];
        for (int c = 0; c < KT; ++c) acc = fmaf(Pw[r * LDSS + c], Vs[c * LDV + d], acc);
        Ow[r * LDO + d] = acc;
      }
    }
    __syncwarp();
  }

  const size_t bh = (size_t)b * (gridDim.y / NSL) + h;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qi = q0 + warp * 16 + r;
    if (qi < N) {
      float inv = 1.f / l[r], keep = 0.f, L = m[r] + logf(l[r]);
      if (lse_prev != nullptr) {  // merged into the key rectangles before
        const float p = lse_prev[bh * N + qi], M = fmaxf(L, p);
        const float wr = expf(L - M), wp = expf(p - M), s = wr + wp;
        inv *= wr / s;
        keep = wp / s;
        L = M + logf(s);
      }
      float* orow = ob + tok_off<SP>(geo, qi, osn);
      for (int d = lane; d < NV; d += 32)
        orow[d] = lse_prev != nullptr ? fmaf(orow[d], keep, Ow[r * LDO + d] * inv)
                                      : Ow[r * LDO + d] * inv;
      if (lse != nullptr && sl == 0 && lane == 0) lse[bh * N + qi] = L;
    }
  }
}

// a launch's operands: k, v, rh and rw already at the key rectangle's first
// key, first table row and first table column
struct Operands {
  const void *q, *k, *v, *rh, *rw;
  void* out;
  float* lse;
  const float* lse_prev;
  int N, H, W, KH, KW;
};

template <typename T, typename Kernel>
static int launch(Kernel kern, size_t smem, dim3 grid, int threads, const Operands& o,
                  const long long* st, float scale, Geo geo, cudaStream_t s) {
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, threads, smem, s>>>(
      (const T*)o.q, (const T*)o.k, (const T*)o.v, (const T*)o.rh, (const T*)o.rw, (T*)o.out,
      o.lse, o.lse_prev, o.N, o.H, o.W, o.KH, o.KW, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], scale, geo);
  return (int)cudaGetLastError();
}

template <int HD, bool SP>
static int launch_bf16(int var, int B, int nH, const Operands& o, const long long* st, float scale,
                       Geo geo, cudaStream_t s) {
  constexpr int NSL = HD / out_cols<HD>();
  const int H = o.H, W = o.W;
  const size_t smem = bf16_smem<HD>(var, o.N, H, W, o.KH, o.KW);
  if constexpr (HD <= 128) {
    if (var == VAR_WINDOW)
      return launch<bf16>(relpos_attention_bf16_kernel<HD, SP, VAR_WINDOW>, smem,
                          dim3(1, nH * NSL, B), 256, o, st, scale, geo, s);
  }
  const int py = patch_rows(HD, H, W);
  const dim3 grid((H + py - 1) / py * ((W + 7) / 8), nH * NSL, B);
  if (var == VAR_ROWS)
    return launch<bf16>(relpos_attention_bf16_kernel<HD, SP, VAR_ROWS>, smem, grid, 16 * py, o,
                        st, scale, geo, s);
  return launch<bf16>(relpos_attention_bf16_kernel<HD, SP, VAR_GENERAL>, smem, grid, 16 * py, o,
                      st, scale, geo, s);
}

// strides: 12 element strides, (batch, head, token) for q, k, v, out in turn
// (the batch strides unused in the spatial mode). win > 0: the spatial mode,
// B windows of win x win tokens (H == W == win) of maps of nwy x nwx windows.
// variant: VAR_ROWS, VAR_GENERAL or VAR_WINDOW, as forward_plan picks it
// (bf16; the f32 kernel has one form); refused where it does not apply.
// lse: null, or a contiguous (B, nH, N) f32 buffer that takes each row's
// log-sum-exp of the logits (natural units; the backward's row statistics);
// not in the spatial mode. (ky0, kx0, kh, kw): the key rectangle the launch
// attends over (the whole map: 0, 0, H, W); lse_prev: null, or the (B, nH, N)
// log-sum-exps of the rectangles launched before, into whose output in out
// this one's is merged (then lse, a buffer other than lse_prev, is required).
// The window variant and the spatial mode take the whole map only.
MSAM_EXPORT int msam_relpos_attention(const void* q, const void* k, const void* v,
                                      const void* rh, const void* rw, void* out, float* lse,
                                      const float* lse_prev, int B, int nH, int N, int H, int W,
                                      int hd, const long long* strides, float scale, int win,
                                      int nwy, int nwx, int variant, int ky0, int kx0, int kh,
                                      int kw, int dtype, void* stream) {
  constexpr int NSL = MSAM_HD / out_cols<MSAM_HD>();
  if (hd != MSAM_HD || N != H * W || B <= 0 || nH <= 0 || B > 65535 || nH * NSL > 65535)
    return (int)cudaErrorInvalidValue;
  const bool whole = ky0 == 0 && kx0 == 0 && kh == H && kw == W;
  if (ky0 < 0 || kx0 < 0 || kh <= 0 || kw <= 0 || ky0 + kh > H || kx0 + kw > W ||
      (lse_prev != nullptr && (lse == nullptr || lse == lse_prev)))
    return (int)cudaErrorInvalidValue;
  if (win < 0 || (win > 0 && (H != win || W != win || nwy <= 0 || nwx <= 0 || B % (nwy * nwx) ||
                              lse != nullptr || !whole)))
    return (int)cudaErrorInvalidValue;
  const Geo geo{win, nwy, nwx};
  cudaStream_t s = (cudaStream_t)stream;
  const size_t esz = dtype == MSAM_BF16 ? 2 : 4;
  const long long first = (long long)ky0 * W + kx0;  // the rectangle's first key token
  const Operands o{q,
                   (const char*)k + first * strides[5] * esz,
                   (const char*)v + first * strides[8] * esz,
                   (const char*)rh + (size_t)ky0 * hd * esz,
                   (const char*)rw + (size_t)kx0 * hd * esz,
                   out, lse, lse_prev, N, H, W, kh, kw};
  if (dtype == MSAM_BF16) {
    const Tiling T = tiling_of(H, W);
    const bool window = whole && MSAM_HD <= 128 && T.segs == 1 && H * T.wp <= 256 &&
                        bf16_smem<MSAM_HD>(VAR_WINDOW, N, H, W, H, W) <= SMEM_LIMIT;
    const bool ok = variant == VAR_WINDOW ? window
                  : variant == VAR_ROWS   ? kw <= 64
                  : variant == VAR_GENERAL && kw > 64;
    if (!ok) return (int)cudaErrorInvalidValue;
    return win ? launch_bf16<MSAM_HD, true>(variant, B, nH, o, strides, scale, geo, s)
               : launch_bf16<MSAM_HD, false>(variant, B, nH, o, strides, scale, geo, s);
  }
  if (dtype == MSAM_F32) {
    constexpr int QR = f32_rows<MSAM_HD>();
    const dim3 grid((N + QR - 1) / QR, nH * NSL, B);
    const size_t smem = f32_smem<MSAM_HD>(kh, kw);
    return win ? launch<float>(relpos_attention_f32_kernel<MSAM_HD, true>, smem, grid, 2 * QR, o,
                               strides, scale, geo, s)
               : launch<float>(relpos_attention_f32_kernel<MSAM_HD, false>, smem, grid, 2 * QR,
                               o, strides, scale, geo, s);
  }
  return (int)cudaErrorInvalidValue;
}

MSAM_ERROR_STRING(msam_relpos_attention)
