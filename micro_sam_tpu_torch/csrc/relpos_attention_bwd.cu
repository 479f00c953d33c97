// Backward of the rel-pos flash attention (relpos_attention.cu):
//
//   P = softmax(S), S = (q * s) k^T + bias, s = hd^-0.5,
//   bias[i, j] = q_i . Rh[y(i), y(j)] + q_i . Rw[x(i), x(j)]   (unscaled q)
//   D_i  = dO_i . O_i
//   dS   = P o (dO v^T - D)
//   dv   = P^T dO
//   dk   = s dS^T q
//   dq   = s dS k + sum_b dSr[i, b] Rh[y(i), b] + sum_c dSc[i, c] Rw[x(i), c]
//   dRh[a, b] = sum_{y(i) = a} dSr[i, b] q_i,  dRw[a, c] = sum_{x(i) = a} dSc[i, c] q_i
//
// with dSr[i, b] = sum_{y(j) = b} dS[i, j] and dSc[i, c] = sum_{x(j) = c} dS[i, j],
// summed over batch and heads for the tables.
//
// Replaces micro_sam_tpu/ops/flash_attention.py::_flash_bwd_kernel (reached
// through _flash_backward_qkv, the custom_vjp backward of flash_attention_qkv).
// The TPU kernel accumulates dRh / dRw into one output block across its
// sequential grid; blocks on the card run in parallel and in no order, so
// this is four launches (the `stage` argument), each deterministic (no
// atomics, every sum in a fixed order):
//
//   0 prep:   per map patch: the u rows u_h = q . Rh[y] | u_w = q . Rw[x]
//             (log2 units) as tensor-core products over q rows that share a
//             table, D = rowsum(dO o O) and the row log-sum-exp in log2 units.
//             The log-sum-exp itself comes from the forward, which stores it
//             (the TPU kernel recomputes it by a second walk over the keys,
//             because a per-row output tiles badly there).
//   1 dk/dv:  per key block of whole map rows (or per window): S^T = k q^T and
//             dP^T = v dO^T on the tensor cores, each logit one FFMA and one
//             ex2 on log2-scaled values, P^T and dS^T repacked in registers as
//             the A fragments of dv += P^T dO and dk += dS^T q.
//   2 dq:     per map patch of q rows (or per window), key tiles of whole map
//             rows as in the forward (Tiling): S and dP, dS in registers,
//             dq += dS k; dSc (per key column) summed in registers in the
//             fragment layout (a thread's key columns are the same in every
//             tile) and dSr (per key row) by quad shuffles, both into the u
//             rows' shared memory as the u entries they replace fall dead;
//             the table terms dSr . Rh[y] and dSc . Rw[x] as tensor-core
//             products over rows that share a table; dSr / dSc to scratch.
//   3 tables: per (table, row a, 16 of its columns): dRh[a] = dSr^T q over
//             the B nH W rows with y = a (dRw likewise), TF32 m16n8k8 products
//             over 64-row chunks in a cp.async ring, summed across warps in a
//             fixed order.
//
// Bound on the H100: operations. The stages do about 10 N^2 hd flops per head
// (a vit_b global block, N = 4096, 12 heads: 129 GFLOP, 0.13 ms at 989
// TFLOP/s) against the bytes of q, k, v, O, dO, dq, dk and dv (44 MB, 0.013
// ms). The design before this one ran at 1.5 % of that: around each
// mma.sync it did a division, two shared gathers and an expf per logit, summed
// dS per key row and column through shared memory (half of the dq stage),
// added the table terms and the table gradients by scalar loops (the table
// stage 38 % of a window launch) and walked the keys once more for the row
// statistics. This design keeps the JAX kernel's row-aligned structure: every
// table term is a product, the row statistics come from the forward, and what
// remains around the products is one FFMA, one ex2 and two multiply-adds a
// logit.
//
// Variants (chosen in ops/relpos_attention.py::backward_plan, checked here),
// for stages 1 and 2 in bf16: VAR_WINDOW (the whole window's keys and q rows
// resident, one block per (window, head): the 14 x 14 windows up to head dim
// 96; for stage 2 only windows whose rows pad to 16 slots), VAR_ROWS (W <=
// 64: key tiles of 64 / W whole rows) and VAR_GENERAL
// (W > 64: key tiles of 64-column row segments). Head dims above 128 (built
// at 256): a block computes one 128-column slice of dq, dk, dv or the table
// gradients (a grid dimension), the products over the full head dim
// recomputed per slice.
//
// Key rectangles (as in the forward): a launch of each stage takes the keys
// of one rectangle of the key map (KH x KW from row ky0, column kx0; the
// whole map unless the wrapper splits it) and its u rows, dSr and dSc hold
// that rectangle's KH + KW entries a q row, so no stage's shared memory
// grows with the map (ops/relpos_attention.py::backward_plan splits a map
// whose stages would not fit). With the forward's global lse and D, the
// rectangles' dk and dv are their own keys'; their dq and table gradients
// add up: with acc set, stage 2 adds its dq into dq and stage 3 its table
// gradients into drh / drw (the wrapper zeroes those first).
//
// Built once per head dim: the source is compiled with -DMSAM_HD=<hd> into a
// library of its own for each of 32, 64 (vit_b, vit_l), 80 (vit_h), 96, 128
// and 256 (ops/_cuda.py), so the builds run in parallel; the wrapper runs any
// other head dim up to 256 in the next larger one, zero-padded.
//
// f32: plain SIMT walks of the same stages (a warp owns 16 rows; a lane owns
// keys / q rows (lane, lane + 32) and dims lane + 32 e), kept as the parity
// path; above head dim 128 they take 32-row tiles and a 128-column slice.
//
// What bounds each stage on the card, and the design's answer (vit_b's
// global call (2, 12, 4096, 64), bf16, device time on an H100 at 700 W: all
// four 2.41 ms against a bound of 0.27 ms of operations; the design before
// this one took 14.63 ms):
//   0 prep: the u products and reading O / dO (bytes): 0.12 ms.
//   1 dk/dv: the products (4 a logit) and the per-logit u / lse / D loads
//     (2.5 shared loads a logit, 8 n8 tiles a warp in flight): 1.15 ms. A
//     block holds 128 key slots (two tiles) so that each q step's 32 KB of
//     q, dO and u rows from L2 feeds twice the products; the ring keeps two
//     q steps in flight across the barrier.
//   2 dq: the same products and the tables' terms: 1.06 ms; what the design
//     before spent around the products (the per-key-row and per-key-column
//     sums of dS through shared memory, 52 % of it) is a quad shuffle and
//     register sums.
//   3 tables: latency of the row stream (a block walks B nH W rows of dSr
//     and q): 0.08 ms; 128-row chunks, four in the ring, and column groups
//     as a grid dimension where the tables have few rows (the windows: 28
//     blocks without them).
//
// ptxas (-Xptxas -v, sm_90a): no instantiation spills or keeps a stack
// frame. Registers, bf16, at head dims 32 / 64 / 80 / 96 / 128 / 256:
// prep 96 / 148 / 168 / 168 / 154 / 255; dk/dv rows and general 232 / 255 /
// 255 / 245 / 255 / 242, window 149 / 167 / 201 / 180 / 218 / -; dq rows
// 214 / 250 / 253 / 242 / 247 / 250, general 130 / 148 / 216 / 255 / 255 /
// 255, window 141 / 188 / 207 / 209 / 255 / -; tables 70 / 72 / 73 / 80 /
// 114 / 114; f32 38-254. Shared memory, dynamic, at head dim 64 / 80:
// prep 43008 / 45056 (64 x 64 grid); dk/dv rows 158208 / 178688, window
// 160640 / 189312 (14 x 14); dq rows 159744 / 180224, window 158976 /
// 187648; tables 122880 / 139264 (65536 / 73728 with 8 column groups); at
// 128 the largest, the dq stage's rows, 206848.
#include "relpos_common.cuh"

#ifndef MSAM_HD
#error "build with -DMSAM_HD=<head dim>"
#endif

// operands: 0 q, 1 k, 2 v, 3 O, 4 dO, 5 dq, 6 dk, 7 dv
struct BwdArgs {
  const void* in[5];
  void* grad[3];
  const void* rh;
  const void* rw;
  float* drh;
  float* drw;
  const float* lse;  // (B nH, N): the forward's row log-sum-exps, natural units
  float* U;          // (B nH, N, UG): u rows, log2 units (bwd_tiling's layout)
  float* L;          // (B nH, N): lse in log2 units
  float* D;          // (B nH, N)
  float* dsr;        // (B nH, N, HP): dSr, zero past H
  float* dsc;        // (B nH, N, WQ): dSc, zero past W
  long long st[8][3];  // element strides (batch, head, token)
  int B, nH, N, H, W, UG, HP, WQ;
  int KH, KW;  // the key rectangle (k, v, dk, dv, rh, rw, drh, drw start at its first key)
  int acc;     // 1: stage 2 adds into dq; 2: stage 3 adds into drh / drw
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* in_ptr(const BwdArgs& a, int i, int b, int h) {
  return reinterpret_cast<const T*>(a.in[i]) + b * a.st[i][0] + h * a.st[i][1];
}
template <typename T>
__device__ __forceinline__ T* grad_ptr(const BwdArgs& a, int i, int b, int h) {
  return reinterpret_cast<T*>(a.grad[i]) + b * a.st[5 + i][0] + h * a.st[5 + i][1];
}

// The u row layout of the backward: the forward's Tiling with u_w starting at
// H rounded up to 4 (so that u_h and u_w rows copy as 16-byte chunks):
// [0, H) u_h, [uwo, uwo + W) u_w, [uwo + W, uwo + uwl) -inf.
__host__ __device__ inline Tiling bwd_tiling(int H, int W) {
  Tiling T = tiling_of(H, W);
  T.uwo = (H + 3) & ~3;
  return T;
}
__host__ __device__ inline int u_global(const Tiling& T) { return T.uwo + T.uwl; }
// a smem pitch for rows of n floats (n a multiple of 4): 16-byte rows, and
// 8 rows of a fragment 4 banks apart
__host__ __device__ inline int pitch_4mod8(int n) { return n % 8 ? n : n + 4; }
// a smem pitch for rows of n floats read as (row 2t + e, column g) by a warp:
// 16-byte rows with 2 * pitch = 8 (mod 32) banks
__host__ __device__ inline int pitch_4mod16(int n) {
  while (n % 16 != 4 && n % 16 != 12) n += 4;
  return n;
}
__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void mma1688_tf32(float c[4], const float a[4], float b0, float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

__device__ __forceinline__ float bf16_bits_to_f32(unsigned short v) {
  return __uint_as_float((uint32_t)v << 16);
}

// ---------------------------------------------------------------------------
// stage 0 (bf16): u rows by products over a patch's rows that share a table
// ---------------------------------------------------------------------------

// KH, KW: the key rectangle (its u rows)
template <int HD>
__host__ __device__ inline size_t prep_bf16_smem(int KH, int KW) {
  const Tiling T = bwd_tiling(KH, KW);
  return align128(sizeof(bf16) * 64 * (HD + 8)) +
         sizeof(float) * 64 * (size_t)pitch_4mod8(u_global(T));
}

// one block per 8 x 8 map patch (4 warps); (128, 1): with the block size
// alone ptxas held the kernel to 128 registers and spilled
template <int HD>
__global__ void __launch_bounds__(128, 1) prep_bf16_kernel(const BwdArgs a) {
  constexpr int LDK = HD + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = a.N, H = a.H, W = a.W, UG = a.UG;
  Tiling T = bwd_tiling(a.KH, a.KW);
  T.up = pitch_4mod8(UG);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  float* U = reinterpret_cast<float*>(smem + align128(sizeof(bf16) * 64 * LDK));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * a.nH + h;
  const int pnx = (W + 7) / 8, qy0 = blockIdx.x / pnx * 8, qx0 = (blockIdx.x % pnx) * 8;
  const Geo geo{0, 0, 0};
  const bf16* rh = reinterpret_cast<const bf16*>(a.rh);
  const bf16* rw = reinterpret_cast<const bf16*>(a.rw);
  load_patch<HD, LDK, false>(Qs, in_ptr<bf16>(a, 0, b, h), a.st[0][2], 64, qy0, qx0, H, W, geo,
                             threadIdx.x, blockDim.x);
  cp_async_commit();
  u_pads(U, T, 64, 0, true, qy0, qx0, H, W, a.KW, threadIdx.x, blockDim.x);
  cp_async_wait<0>();
  __syncthreads();
  const int nx = min(8, W - qx0), ny = min(8, H - qy0);
  for (int item = warp; item < 16; item += blockDim.x / 32) {
    if (item < 8) {
      if (item < ny)
        u_product<HD>(U, T.up, 0, Qs, item * 8, 1, nx, rh + (size_t)(qy0 + item) * H * HD, a.KH,
                      lane);
    } else if (item - 8 < nx) {
      u_product<HD>(U, T.up, T.uwo, Qs, item - 8, 8, ny, rw + (size_t)(qx0 + item - 8) * W * HD,
                    a.KW, lane);
    }
  }
  __syncthreads();
  float* Ug = a.U + (size_t)bh * N * UG;
  for (int idx = threadIdx.x; idx < 64 * (UG / 4); idx += blockDim.x) {
    const int r = idx / (UG / 4), c = idx - r * (UG / 4);
    const int qy = qy0 + (r >> 3), qx = qx0 + (r & 7);
    if (qy < H && qx < W)
      *reinterpret_cast<float4*>(Ug + (size_t)(qy * W + qx) * UG + 4 * c) =
          *reinterpret_cast<const float4*>(U + r * T.up + 4 * c);
  }
  const bf16* ob = in_ptr<bf16>(a, 3, b, h);
  const bf16* gb = in_ptr<bf16>(a, 4, b, h);
  for (int r = threadIdx.x; r < 64; r += blockDim.x) {
    const int qy = qy0 + (r >> 3), qx = qx0 + (r & 7), tok = qy * W + qx;
    if (qy < H && qx < W) {
      a.D[(size_t)bh * N + tok] =
          dot_row<bf16, HD>(ob + (long long)tok * a.st[3][2], gb + (long long)tok * a.st[4][2]);
      a.L[(size_t)bh * N + tok] = a.lse[(size_t)bh * N + tok] * LOG2E;
    }
  }
}

// ---------------------------------------------------------------------------
// stage 1 (bf16): dk, dv. A warp owns 16 key slots (the A rows of S^T = k q^T);
// a thread's keys (rows g and g + 8) are fixed, so its u_w / u_h columns are.
// ---------------------------------------------------------------------------

// 64-slot key tiles a block, q rows a step, q steps in the ring
template <int HD> __host__ __device__ constexpr int dkdv_tiles() { return HD > 128 ? 1 : 2; }
template <int HD> __host__ __device__ constexpr int dkdv_qb() { return HD > 128 ? 32 : 64; }
template <int HD> __host__ __device__ constexpr int dkdv_ring() { return HD <= 80 ? 3 : 2; }
constexpr int UHC = 20;  // u_h columns a stage-1 block keeps a q row (rows / general)

// u row pitch of stage 1's shared memory: [uh window (UHC, or uwo for the
// window variant) | u_w (uwl)]
__host__ __device__ inline int dkdv_upitch(const Tiling& T, int var) {
  return pitch_4mod16((var == VAR_WINDOW ? T.uwo : UHC) + T.uwl);
}

// H, W: the key rectangle (the window variant: the whole map, N = H W)
template <int HD>
__host__ __device__ inline size_t dkdv_bf16_smem(int var, int N, int H, int W) {
  constexpr int LDK = HD + 8;
  const Tiling T = bwd_tiling(H, W);
  const int P = dkdv_upitch(T, var);
  if (var == VAR_WINDOW) {
    const int NS = window_slots(T, H), NQ = (N + 15) & ~15;
    return align128(sizeof(bf16) * (size_t)(2 * NS + 2 * NQ) * LDK) + sizeof(float) * (size_t)NQ * (P + 2);
  }
  constexpr int QB = dkdv_qb<HD>();
  const size_t slot = align128(sizeof(bf16) * 2 * QB * LDK + sizeof(float) * QB * (size_t)(P + 2));
  return align128(sizeof(bf16) * 2 * 64 * dkdv_tiles<HD>() * LDK) + dkdv_ring<HD>() * slot;
}

// One warp, its 16 key slots against 16 q rows (smem rows q0.. of Qs / Gs,
// their u rows at Us, pitch P): S^T, dP^T, then dv += P^T dO and dk += dS^T q
// over the slice's NV columns. kf / vf: the warp's k and v A fragments (held,
// or read from Kw / Vw per k step). uwi / uhi: each key row's u_w and u_h
// column in a u row.
template <int HD, bool HOLD>
__device__ __forceinline__ void dkdv_chunk(float (&dk)[out_cols<HD>() / 8][4],
                                           float (&dv)[out_cols<HD>() / 8][4],
                                           const uint32_t (&ka)[HOLD ? HD / 16 : 1][4],
                                           const uint32_t (&va)[HOLD ? HD / 16 : 1][4],
                                           const bf16* Kw, const bf16* Vw, const bf16* Qs,
                                           const bf16* Gs, const float* Us, const float* Ls,
                                           const float* Ds, int P, int q0, int uwi0, int uwi1,
                                           int uhi0, int uhi1, float c2, int sl, int lane) {
  constexpr int KS = HD / 16, LDK = HD + 8, NV = out_cols<HD>(), NT = NV / 8;
  const int g = lane >> 2, t = lane & 3;
  float st[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  const int boff = (q0 + (lane >> 4) * 8 + (lane & 7)) * LDK + ((lane >> 3) & 1) * 8;
  auto kstep = [&](int kk, const uint32_t (&kf)[4], const uint32_t (&vf)[4]) {
    uint32_t bq[4], bg[4];
    ldsm_x4(bq, Qs + boff + kk * 16);
    ldsm_x4(bg, Gs + boff + kk * 16);
    mma16816(st[0], kf, bq[0], bq[1]);
    mma16816(st[1], kf, bq[2], bq[3]);
    mma16816(dp[0], vf, bg[0], bg[1]);
    mma16816(dp[1], vf, bg[2], bg[3]);
  };
  if constexpr (HOLD) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) kstep(kk, ka[kk], va[kk]);
  } else {  // unrolled 2 deep: fully, ptxas hoists every k step's loads and spills at 256
#pragma unroll 2
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kf[4], vf[4];
      ldsm_x4(kf, Kw + (lane & 15) * LDK + kk * 16 + (lane >> 4) * 8);
      ldsm_x4(vf, Vw + (lane & 15) * LDK + kk * 16 + (lane >> 4) * 8);
      kstep(kk, kf, vf);
    }
  }
  // p = 2^(s c2 + u_w + u_h - lse), dS = p (dP - D); keys g (0, 1) and g + 8
  // (2, 3), q rows q0 + 8 jj + 2t + e
  uint32_t pa[4], da[4];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = q0 + jj * 8 + t * 2 + e;
      const float* ur = Us + q * P;
      const float lq = Ls[q], dq = Ds[q];
      p[e] = ex2(fmaf(st[jj][e], c2, ur[uwi0] + ur[uhi0] - lq));
      p[2 + e] = ex2(fmaf(st[jj][2 + e], c2, ur[uwi1] + ur[uhi1] - lq));
      ds[e] = p[e] * (dp[jj][e] - dq);
      ds[2 + e] = p[2 + e] * (dp[jj][2 + e] - dq);
    }
    pa[jj * 2] = pack_bf16(p[0], p[1]);
    pa[jj * 2 + 1] = pack_bf16(p[2], p[3]);
    da[jj * 2] = pack_bf16(ds[0], ds[1]);
    da[jj * 2 + 1] = pack_bf16(ds[2], ds[3]);
  }
#pragma unroll
  for (int n = 0; n < NT; n += 2) {
    uint32_t b[4];
    ldsm_x4_trans(b, Gs + (q0 + (lane & 15)) * LDK + sl * NV + (n + (lane >> 4)) * 8);
    mma16816(dv[n], pa, b[0], b[1]);
    mma16816(dv[n + 1], pa, b[2], b[3]);
    ldsm_x4_trans(b, Qs + (q0 + (lane & 15)) * LDK + sl * NV + (n + (lane >> 4)) * 8);
    mma16816(dk[n], da, b[0], b[1]);
    mma16816(dk[n + 1], da, b[2], b[3]);
  }
}

// a warp's dk (times the scale) and dv rows: key slots g, g + 8 at tokens
// tok0 / tok1 (ok: a key of the map)
template <int NV>
__device__ __forceinline__ void store_kv(const BwdArgs& a, int b, int h, int sl,
                                         const float (&dk)[NV / 8][4], const float (&dv)[NV / 8][4],
                                         int tok0, bool ok0, int tok1, bool ok1, int t) {
  bf16* dkb = grad_ptr<bf16>(a, 1, b, h) + sl * NV;
  bf16* dvb = grad_ptr<bf16>(a, 2, b, h) + sl * NV;
  const long long ksn = a.st[6][2], vsn = a.st[7][2];
#pragma unroll
  for (int n = 0; n < NV / 8; ++n) {
    const int d = n * 8 + t * 2;
    if (ok0) {
      *reinterpret_cast<uint32_t*>(dkb + (long long)tok0 * ksn + d) =
          pack_bf16(dk[n][0] * a.scale, dk[n][1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvb + (long long)tok0 * vsn + d) = pack_bf16(dv[n][0], dv[n][1]);
    }
    if (ok1) {
      *reinterpret_cast<uint32_t*>(dkb + (long long)tok1 * ksn + d) =
          pack_bf16(dk[n][2] * a.scale, dk[n][3] * a.scale);
      *reinterpret_cast<uint32_t*>(dvb + (long long)tok1 * vsn + d) = pack_bf16(dv[n][2], dv[n][3]);
    }
  }
}

// nrows u rows from token t0 into smem rows of pitch P: the u_h columns
// [c4, c4 + nh) (zero past uwo) at 0, u_w at nh; rows past N zero-filled.
// Then lse2 and D of the rows into Ls / Ds.
__device__ __forceinline__ void load_u_rows(float* Us, float* Ls, float* Ds, const float* Ug,
                                            const float* Lg, const float* Dg, int UG, int uwo,
                                            int uwl, int P, int c4, int nh, int t0, int nrows,
                                            int N) {
  const int ch = (nh + uwl) / 4;
  for (int c = threadIdx.x; c < nrows * ch; c += blockDim.x) {
    const int r = c / ch, part = c - r * ch, tok = t0 + r;
    const int col = part * 4 < nh ? c4 + part * 4 : uwo + part * 4 - nh;
    const bool ok = tok < N && (part * 4 >= nh || col < uwo);
    cp_async16(Us + r * P + part * 4, ok ? Ug + (size_t)tok * UG + col : Ug, ok);
  }
  for (int r = threadIdx.x; r < 2 * nrows; r += blockDim.x) {
    const int rr = r < nrows ? r : r - nrows, tok = t0 + rr;
    const bool ok = tok < N;
    cp_async4((r < nrows ? Ls : Ds) + rr, (r < nrows ? Lg : Dg) + (ok ? tok : 0), ok);
  }
}

template <int HD, int VAR>
__global__ void __launch_bounds__(256, 1) dkdv_bf16_kernel(const BwdArgs a) {
  constexpr int LDK = HD + 8, NV = out_cols<HD>(), NSL = HD / NV, NT = NV / 8;
  constexpr bool HOLD = HD <= 80;  // k / v A fragments held in registers
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = a.N, H = a.H, W = a.W, KH = a.KH, KW = a.KW;
  const Tiling T = bwd_tiling(KH, KW);
  const int P = dkdv_upitch(T, VAR);
  const float c2 = a.scale * LOG2E;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y / NSL, sl = blockIdx.y - h * NSL, b = blockIdx.z, bh = b * a.nH + h;
  const bf16* qb = in_ptr<bf16>(a, 0, b, h);
  const bf16* kb = in_ptr<bf16>(a, 1, b, h);
  const bf16* vb = in_ptr<bf16>(a, 2, b, h);
  const bf16* gb = in_ptr<bf16>(a, 4, b, h);
  const float* Ug = a.U + (size_t)bh * N * a.UG;
  const float* Lg = a.L + (size_t)bh * N;
  const float* Dg = a.D + (size_t)bh * N;
  const Geo geo{0, 0, 0};
  uint32_t ka[HOLD ? HD / 16 : 1][4], va[HOLD ? HD / 16 : 1][4];
  float dk[NT][4], dv[NT][4];

  if constexpr (VAR == VAR_WINDOW) {
    // the whole window resident: k, v (slot = ky * WP + kx), q, dO, u rows
    const int NS = window_slots(T, H), NQ = (N + 15) & ~15;
    bf16* Ks = reinterpret_cast<bf16*>(smem);
    bf16* Vs = Ks + NS * LDK;
    bf16* Qs = Vs + NS * LDK;
    bf16* Gs = Qs + NQ * LDK;
    float* Us = reinterpret_cast<float*>(smem + align128(sizeof(bf16) * (size_t)(2 * NS + 2 * NQ) * LDK));
    float* Ls = Us + NQ * P;
    float* Ds = Ls + NQ;
    load_slots<HD, LDK, false>(Ks, kb, a.st[1][2], NS, 0, 0, T.wp, H, H, W, W, geo, threadIdx.x, blockDim.x);
    load_slots<HD, LDK, false>(Vs, vb, a.st[2][2], NS, 0, 0, T.wp, H, H, W, W, geo, threadIdx.x, blockDim.x);
    load_rows<HD, LDK, false>(Qs, qb, a.st[0][2], 0, NQ, N, geo, threadIdx.x, blockDim.x);
    load_rows<HD, LDK, false>(Gs, gb, a.st[4][2], 0, NQ, N, geo, threadIdx.x, blockDim.x);
    load_u_rows(Us, Ls, Ds, Ug, Lg, Dg, a.UG, T.uwo, T.uwl, P, 0, T.uwo, 0, NQ, N);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int kt = warp; kt * 16 < NS; kt += blockDim.x / 32) {
      const bf16* Kw = Ks + kt * 16 * LDK;
      const bf16* Vw = Vs + kt * 16 * LDK;
      if constexpr (HOLD) {
        load_a_frags<HD, LDK>(ka, Kw, g, t);
        load_a_frags<HD, LDK>(va, Vw, g, t);
      }
      const int s0 = kt * 16 + g, s1 = s0 + 8;
      const int ky0 = s0 / T.wp, kx0 = s0 - ky0 * T.wp, ky1 = s1 / T.wp, kx1 = s1 - ky1 * T.wp;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
      const int uw0 = T.uwo + kx0, uw1 = T.uwo + kx1, uh0 = min(ky0, H - 1), uh1 = min(ky1, H - 1);
      for (int q0 = 0; q0 < NQ; q0 += 16)
        dkdv_chunk<HD, HOLD>(dk, dv, ka, va, Kw, Vw, Qs, Gs, Us, Ls, Ds, P, q0, uw0, uw1, uh0, uh1,
                             c2, sl, lane);
      store_kv<NV>(a, b, h, sl, dk, dv, ky0 * W + kx0, ky0 < H && kx0 < W, ky1 * W + kx1,
                   ky1 < H && kx1 < W, t);
    }
  } else {
    constexpr int QB = dkdv_qb<HD>(), ST = dkdv_ring<HD>(), TPB = dkdv_tiles<HD>();
    const size_t slot_bytes = align128(sizeof(bf16) * 2 * QB * LDK + sizeof(float) * QB * (size_t)(P + 2));
    bf16* Ks = reinterpret_cast<bf16*>(smem);
    bf16* Vs = Ks + TPB * 64 * LDK;
    unsigned char* ring = smem + align128(sizeof(bf16) * 2 * 64 * TPB * LDK);
    const int it0 = blockIdx.x * TPB;
    // the block's map rows (for its u_h columns) and each warp's tile
    const TileAt first = tile_at(T, it0, KH);
    const int c4 = first.ky0 & ~3, nh = min(UHC, T.uwo);
    const int wt = it0 + warp / 4;
    const TileAt mine = tile_at(T, min(wt, T.ntiles - 1), KH);
    for (int i = 0; i < TPB; ++i) {
      if (it0 + i >= T.ntiles) break;
      const TileAt ta = tile_at(T, it0 + i, KH);
      load_slots<HD, LDK, false>(Ks + i * 64 * LDK, kb, a.st[1][2], 64, ta.ky0, ta.kx0, T.twp, T.rows,
                                 KH, KW, W, geo, threadIdx.x, blockDim.x);
      load_slots<HD, LDK, false>(Vs + i * 64 * LDK, vb, a.st[2][2], 64, ta.ky0, ta.kx0, T.twp, T.rows,
                                 KH, KW, W, geo, threadIdx.x, blockDim.x);
    }
    cp_async_commit();
    const int nsteps = (N + QB - 1) / QB;
    auto issue = [&](int step, int s) {
      unsigned char* base = ring + s * slot_bytes;
      bf16* Qd = reinterpret_cast<bf16*>(base);
      float* Ud = reinterpret_cast<float*>(base + sizeof(bf16) * 2 * QB * LDK);
      load_rows<HD, LDK, false>(Qd, qb, a.st[0][2], step * QB, QB, N, geo, threadIdx.x, blockDim.x);
      load_rows<HD, LDK, false>(Qd + QB * LDK, gb, a.st[4][2], step * QB, QB, N, geo, threadIdx.x,
                                blockDim.x);
      load_u_rows(Ud, Ud + QB * P, Ud + QB * P + QB, Ug, Lg, Dg, a.UG, T.uwo, T.uwl, P, c4, nh,
                  step * QB, QB, N);
    };
#pragma unroll
    for (int s = 0; s < ST - 1; ++s) {
      if (s < nsteps) issue(s, s);
      cp_async_commit();
    }
    // this warp's 16 slots: tile wt, slots (warp % 4) * 16 + g (+ 8)
    const int s0 = (warp & 3) * 16 + g, s1 = s0 + 8;
    const int r0 = s0 / T.twp, r1 = s1 / T.twp;
    const int ky0 = mine.ky0 + r0, kx0 = mine.kx0 + s0 - r0 * T.twp;
    const int ky1 = mine.ky0 + r1, kx1 = mine.kx0 + s1 - r1 * T.twp;
    const bool ok0 = wt < T.ntiles && r0 < T.rows && ky0 < KH && kx0 < KW;
    const bool ok1 = wt < T.ntiles && r1 < T.rows && ky1 < KH && kx1 < KW;
    const int uw0 = nh + min(kx0, T.uwl - 1), uw1 = nh + min(kx1, T.uwl - 1);
    const int uh0 = min(max(ky0 - c4, 0), nh - 1), uh1 = min(max(ky1 - c4, 0), nh - 1);
    const bf16* Kw = Ks + ((warp >> 2) * 64 + (warp & 3) * 16) * LDK;
    const bf16* Vw = Vs + ((warp >> 2) * 64 + (warp & 3) * 16) * LDK;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
    for (int it = 0; it < nsteps; ++it) {
      cp_async_wait<ST - 2>();
      __syncthreads();  // step it is visible; the slot of step it - 1 is free
      if (it + ST - 1 < nsteps) issue(it + ST - 1, (it + ST - 1) % ST);
      cp_async_commit();
      if constexpr (HOLD) {
        if (it == 0) {
          load_a_frags<HD, LDK>(ka, Kw, g, t);
          load_a_frags<HD, LDK>(va, Vw, g, t);
        }
      }
      const unsigned char* base = ring + (it % ST) * slot_bytes;
      const bf16* Qs = reinterpret_cast<const bf16*>(base);
      const bf16* Gs = Qs + QB * LDK;
      const float* Us = reinterpret_cast<const float*>(base + sizeof(bf16) * 2 * QB * LDK);
      const float* Ls = Us + QB * P;
      const float* Ds = Ls + QB;
#pragma unroll
      for (int q0 = 0; q0 < QB; q0 += 16)
        dkdv_chunk<HD, HOLD>(dk, dv, ka, va, Kw, Vw, Qs, Gs, Us, Ls, Ds, P, q0, uw0, uw1, uh0, uh1,
                             c2, sl, lane);
    }
    store_kv<NV>(a, b, h, sl, dk, dv, ky0 * W + kx0, ok0, ky1 * W + kx1, ok1, t);
  }
}

// ---------------------------------------------------------------------------
// stage 2 (bf16): dq and the per-key-row / per-key-column sums of dS
// ---------------------------------------------------------------------------

// q rows a block of the rows / general variants takes: a PY x 8 patch
__host__ __device__ inline int dq_patch_rows(int hd, int H, int W) {
  return hd > 128 ? 4 : (H <= 64 && W <= 64 ? 16 : 8);
}
template <int HD> __host__ __device__ constexpr int dq_ring() { return HD <= 96 ? 3 : 2; }

// the map is H x W, its key rectangle KH x KW (the window variant: the whole map)
template <int HD>
__host__ __device__ inline size_t dq_bf16_smem(int var, int N, int H, int W, int KH, int KW) {
  constexpr int LDK = HD + 8, NV = out_cols<HD>();
  const Tiling T = bwd_tiling(KH, KW);
  const int up = pitch_4mod8(u_global(T));
  if (var == VAR_WINDOW) {
    const int NS = window_slots(T, H), NQ = (N + 15) & ~15;
    return align128(sizeof(bf16) * (size_t)(2 * NS + 2 * NQ) * LDK) + sizeof(float) * (size_t)NQ * up;
  }
  const int QR = 8 * dq_patch_rows(HD, H, W);
  const size_t ring = sizeof(bf16) * dq_ring<HD>() * 64 * 2 * LDK;
  const size_t stage = sizeof(float) * QR * (NV + 4);
  return align128(sizeof(bf16) * 2 * QR * LDK) + align128(ring > stage ? ring : stage) +
         sizeof(float) * (size_t)QR * (up + (var == VAR_GENERAL ? T.uwl : 0));
}

// One warp: its 16 q rows against one key tile (FULL: all 8 n8 tiles of
// slots in use), a k16 step of keys (two n8 tiles) at a time: S and dP,
// dS, then dq += dS k over the slice's columns; dSc summed per key column;
// dS summed per key row (a row's n8 tiles are consecutive, so each row is
// summed, reduced over the quad and stored as soon as its last n8 tile is
// done): with one row a tile into rs0 / rs1 (the caller stores it), else
// into the row's u_h entry, which no later n8 tile reads. jy: the padded
// row within the tile of n8 tile j, 3 bits each.
// JW: n8 tiles of distinct key columns (8: u_w terms uw and dSc sums dsc in
// registers in the fragment layout; 2: the same for rows of 16 slots, n8
// tile j's in j % 2, the k16 steps not unrolled; 0: the general variant,
// whose columns change every tile: u_w read from Uw0 / Uw1 and dS added
// into C0 / C1 in shared memory, column j * 8 + 2t + e)
template <int HD, int JW, bool QREG, bool FULL>
__device__ __forceinline__ void dq_tile(float (&dq)[out_cols<HD>() / 8][4],
                                        float (&dsc)[JW ? JW : 1][4], float& rs0, float& rs1,
                                        const uint32_t (&qa)[QREG ? HD / 16 : 1][4],
                                        const uint32_t (&ga)[QREG ? HD / 16 : 1][4],
                                        const bf16* Qw, const bf16* Gw, const bf16* Ks,
                                        const bf16* Vs, int nj_, const float (&uw)[JW ? JW : 1][4],
                                        const float* Uw0, const float* Uw1, float* C0, float* C1,
                                        float* U0, float* U1, int ky0, int jy, bool one_row,
                                        float c2, float L0, float L1, float D0, float D1, int sl,
                                        int lane) {
  constexpr int KS = HD / 16, LDK = HD + 8, NV = out_cols<HD>(), NT = NV / 8;
  const int t = lane & 3;
  const int nj = FULL ? 8 : nj_;
  float hb0 = 0.f, hb1 = 0.f;
  if (one_row) {
    hb0 = U0[ky0] - L0;
    hb1 = U1[ky0] - L1;
  }
  float a0 = 0.f, a1 = 0.f;  // the current key row's dS sums, rows g / g + 8
  auto pair = [&](int jp) {
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if (jp < nj) {
      const int boff = ((jp + (lane >> 4)) * 8 + (lane & 7)) * LDK + ((lane >> 3) & 1) * 8;
      auto kstep = [&](int kk, const uint32_t (&aq)[4], const uint32_t (&ag)[4]) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, Ks + boff + kk * 16);
        ldsm_x4(bv, Vs + boff + kk * 16);
        mma16816(s[0], aq, bk[0], bk[1]);
        mma16816(s[1], aq, bk[2], bk[3]);
        mma16816(dp[0], ag, bv[0], bv[1]);
        mma16816(dp[1], ag, bv[2], bv[3]);
      };
      if constexpr (QREG) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) kstep(kk, qa[kk], ga[kk]);
      } else {  // unrolled 2 deep, as in dkdv_chunk
#pragma unroll 2
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t aq[4], ag[4];
          ldsm_x4(aq, Qw + (lane & 15) * LDK + kk * 16 + (lane >> 4) * 8);
          ldsm_x4(ag, Gw + (lane & 15) * LDK + kk * 16 + (lane >> 4) * 8);
          kstep(kk, aq, ag);
        }
      }
    }
    uint32_t da[4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = jp + jj, ry = (jy >> (3 * j)) & 7;
      const int ju = JW == 8 ? j : (JW ? jj % JW : 0);  // jp is even
      const int cw = j * 8 + 2 * t;  // JW 0: the column of e = 0
      float ds[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < nj) {
        float y0 = hb0, y1 = hb1;
        if (!one_row) {
          y0 = U0[ky0 + ry] - L0;
          y1 = U1[ky0 + ry] - L1;
        }
        float u[4];
        if constexpr (JW == 0) {
          u[0] = Uw0[cw]; u[1] = Uw0[cw + 1]; u[2] = Uw1[cw]; u[3] = Uw1[cw + 1];
        } else {
          u[0] = uw[ju][0]; u[1] = uw[ju][1]; u[2] = uw[ju][2]; u[3] = uw[ju][3];
        }
        ds[0] = ex2(fmaf(s[jj][0], c2, u[0] + y0)) * (dp[jj][0] - D0);
        ds[1] = ex2(fmaf(s[jj][1], c2, u[1] + y0)) * (dp[jj][1] - D0);
        ds[2] = ex2(fmaf(s[jj][2], c2, u[2] + y1)) * (dp[jj][2] - D1);
        ds[3] = ex2(fmaf(s[jj][3], c2, u[3] + y1)) * (dp[jj][3] - D1);
      }
      if constexpr (JW == 0) {
        C0[cw] += ds[0]; C0[cw + 1] += ds[1]; C1[cw] += ds[2]; C1[cw + 1] += ds[3];
      } else {
        dsc[ju][0] += ds[0]; dsc[ju][1] += ds[1]; dsc[ju][2] += ds[2]; dsc[ju][3] += ds[3];
      }
      a0 += ds[0] + ds[1];
      a1 += ds[2] + ds[3];
      da[jj * 2] = pack_bf16(ds[0], ds[1]);
      da[jj * 2 + 1] = pack_bf16(ds[2], ds[3]);
      if (j == 7 || (!one_row && ((jy >> (3 * j + 3)) & 7) != ry)) {  // the row's last n8 tile
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          a0 += __shfl_xor_sync(0xffffffffu, a0, off);
          a1 += __shfl_xor_sync(0xffffffffu, a1, off);
        }
        if (one_row) {
          rs0 += a0;
          rs1 += a1;
        } else if (t == 0 && j < nj) {
          U0[ky0 + ry] = a0;
          U1[ky0 + ry] = a1;
        }
        a0 = a1 = 0.f;
      }
    }
    // dq += dS k over this k16 step of keys
    if (jp < nj) {
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, Ks + (jp * 8 + (lane & 15)) * LDK + sl * NV + (n + (lane >> 4)) * 8);
        mma16816(dq[n], da, b[0], b[1]);
        mma16816(dq[n + 1], da, b[2], b[3]);
      }
    }
  };
  if constexpr (JW == 2) {  // fully unrolled, ptxas spills in the window kernel
#pragma unroll 1
    for (int jp = 0; jp < 8; jp += 2) pair(jp);
  } else {
#pragma unroll
    for (int jp = 0; jp < 8; jp += 2) pair(jp);
  }
}

template <int HD, int JW, bool QREG>
__device__ __forceinline__ void dq_tile_any(float (&dq)[out_cols<HD>() / 8][4],
                                            float (&dsc)[JW ? JW : 1][4], float& rs0, float& rs1,
                                            const uint32_t (&qa)[QREG ? HD / 16 : 1][4],
                                            const uint32_t (&ga)[QREG ? HD / 16 : 1][4],
                                            const bf16* Qw, const bf16* Gw, const bf16* Ks,
                                            const bf16* Vs, int nj, const float (&uw)[JW ? JW : 1][4],
                                            const float* Uw0, const float* Uw1, float* C0,
                                            float* C1, float* U0, float* U1, int ky0, int jy,
                                            bool one_row, float c2, float L0, float L1, float D0,
                                            float D1, int sl, int lane) {
  if (JW != 0 && nj == 8)  // the general variant: one copy (two spill)
    dq_tile<HD, JW, QREG, true>(dq, dsc, rs0, rs1, qa, ga, Qw, Gw, Ks, Vs, nj, uw, Uw0, Uw1, C0,
                                C1, U0, U1, ky0, jy, one_row, c2, L0, L1, D0, D1, sl, lane);
  else
    dq_tile<HD, JW, QREG, false>(dq, dsc, rs0, rs1, qa, ga, Qw, Gw, Ks, Vs, nj, uw, Uw0, Uw1, C0,
                                 C1, U0, U1, ky0, jy, one_row, c2, L0, L1, D0, D1, sl, lane);
}

// a thread's dSc sums (fragment layout, key slots of a tile of twp-slot rows)
// into the u_w entries of its rows (dead once loaded into registers): each
// key column belongs to one thread, which adds its tiles' rows in order
// (JW < 8: the sums are already per column, n8 tile j's in j % JW); W: the
// key rectangle's columns
template <int JW>
__device__ __forceinline__ void store_dsc(float* U0, float* U1, const float (&dsc)[JW][4],
                                          const Tiling& T, int jy, int W, int t) {
#pragma unroll
  for (int j = 0; j < JW; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = j * 8 + t * 2 + e, cx = c % T.twp;
      if (c < T.rows * T.twp && cx < W) {
        if (((jy >> (3 * j)) & 7) == 0) {
          U0[T.uwo + cx] = dsc[j][e];
          U1[T.uwo + cx] = dsc[j][2 + e];
        } else {
          U0[T.uwo + cx] += dsc[j][e];
          U1[T.uwo + cx] += dsc[j][2 + e];
        }
      }
    }
  }
}

// One warp: rows row0 + i * rstride (i < ni) of the staged dq (f32, row(r)
// its address) += A[rows, 0:nb] . tab[0:nb, slice] (A: f32 shared rows of
// pitch ap; tab: nb rows of HD, bf16, device memory), as a tensor-core
// product with A rounded to bf16. UNR: the k16 loop's unrolling (2 for the
// general variant at head dim 80, whose dq kernel spills 132 bytes at 1
// since the table's rows are a key rectangle's; 1, as ptxas chose for it,
// everywhere else)
template <int HD, int UNR = 1, typename Row>
__device__ __forceinline__ void table_term(Row row, const float* A, int ap, int row0, int rstride,
                                           int ni, const bf16* tab, int nb, int sl, int lane) {
  constexpr int NV = out_cols<HD>(), NT = NV / 8;
  const int g = lane >> 2, t = lane & 3;
  const unsigned short* tb = reinterpret_cast<const unsigned short*>(tab) + sl * NV;
  float c[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
  const float* A0 = A + (row0 + min(g, ni - 1) * rstride) * ap;
  const float* A1 = A + (row0 + min(g + 8, ni - 1) * rstride) * ap;
#pragma unroll UNR
  for (int k0 = 0; k0 < nb; k0 += 16) {
    auto av = [&](const float* ar, bool ok, int k) { return ok && k < nb ? ar[k] : 0.f; };
    uint32_t a[4];
    const int k = k0 + 2 * t;
    a[0] = pack_bf16(av(A0, g < ni, k), av(A0, g < ni, k + 1));
    a[1] = pack_bf16(av(A1, g + 8 < ni, k), av(A1, g + 8 < ni, k + 1));
    a[2] = pack_bf16(av(A0, g < ni, k + 8), av(A0, g < ni, k + 9));
    a[3] = pack_bf16(av(A1, g + 8 < ni, k + 8), av(A1, g + 8 < ni, k + 9));
    auto bv = [&](int kr, int d) -> uint32_t { return kr < nb ? __ldg(tb + (size_t)kr * HD + d) : 0u; };
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = n * 8 + g;
      mma16816(c[n], a, bv(k, d) | bv(k + 1, d) << 16, bv(k + 8, d) | bv(k + 9, d) << 16);
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = n * 8 + 2 * t;
    if (g < ni) {
      float* r = row(row0 + g * rstride);
      r[d] += c[n][0];
      r[d + 1] += c[n][1];
    }
    if (g + 8 < ni) {
      float* r = row(row0 + (g + 8) * rstride);
      r[d] += c[n][2];
      r[d + 1] += c[n][3];
    }
  }
}

// the table terms of a block's staged dq: products over the q rows that
// share Rh[y] (rows ry(y), ny of them) then, after a barrier, over those
// that share Rw[x]; A: dSr at column 0 and dSc at column dsc_off of the u rows
template <int HD, typename Row, typename ByY, typename ByX>
__device__ __forceinline__ void table_terms(Row row, const float* Ua, int up, int dsc_off,
                                            const bf16* rh, const bf16* rw, int H, int W,
                                            int ny, int nx, ByY by_y, ByX by_x, int sl) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x / 32;
  // by_y(i) -> (y, row0, rstride, ni); pieces of 16 rows
  for (int item = warp; item < ny; item += nw) {
    int y, row0, rs, ni;
    by_y(item, y, row0, rs, ni);
    if (ni > 0) table_term<HD>(row, Ua, up, row0, rs, ni, rh + (size_t)y * H * HD, H, sl, lane);
  }
  __syncthreads();
  for (int item = warp; item < nx; item += nw) {
    int x, row0, rs, ni;
    by_x(item, x, row0, rs, ni);
    if (ni > 0) table_term<HD>(row, Ua + dsc_off, up, row0, rs, ni, rw + (size_t)x * W * HD, W, sl, lane);
  }
  __syncthreads();
}

// a q row's finished dq (f32 staged) to device memory (added to what is
// there with acc & 1), its dSr / dSc rows (the key rectangle's KH / KW
// entries) to scratch (slice 0), 16 bytes a thread at a time
template <int NV>
__device__ __forceinline__ void store_q_row(const BwdArgs& a, bf16* dqb, const float* Dq,
                                            const float* Ur, const float* Cr, int tok, int bh,
                                            int sl, int part) {
  const int H = a.KH, W = a.KW;
  if (part < NV / 8) {
    uint4* dst = reinterpret_cast<uint4*>(dqb + (long long)tok * a.st[5][2] + part * 8);
    float d[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) d[e] = Dq[part * 8 + e];
    if (a.acc & 1) {
      const uint4 old = *dst;
      const uint32_t w[4] = {old.x, old.y, old.z, old.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d[2 * e] += __uint_as_float(w[e] << 16);
        d[2 * e + 1] += __uint_as_float(w[e] & 0xffff0000u);
      }
    }
    uint4 v;
    v.x = pack_bf16(d[0], d[1]);
    v.y = pack_bf16(d[2], d[3]);
    v.z = pack_bf16(d[4], d[5]);
    v.w = pack_bf16(d[6], d[7]);
    *dst = v;
    return;
  }
  if (sl != 0) return;
  part -= NV / 8;
  if (part < a.HP / 4) {
    float* dst = a.dsr + ((size_t)bh * a.N + tok) * a.HP + part * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[e] = part * 4 + e < H ? Ur[part * 4 + e] : 0.f;
    return;
  }
  part -= a.HP / 4;
  float* dst = a.dsc + ((size_t)bh * a.N + tok) * a.WQ + part * 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[e] = part * 4 + e < W ? Cr[part * 4 + e] : 0.f;
}

// JW: as dq_tile's (the window variant, taken only for rows of 16 slots
// (the 14 x 14 windows): 2, its u_w terms and dSc sums in 8 registers, not
// 32; rows: 8; general: 0)
template <int HD, int VAR, int JW>
__global__ void __launch_bounds__(256, 1) dq_bf16_kernel(const BwdArgs a) {
  constexpr int LDK = HD + 8, NV = out_cols<HD>(), NSL = HD / NV, NT = NV / 8, LDQ = NV + 4;
  // q / dO A fragments held in registers up to head dim 80, else read from
  // shared memory per k step; the general variant holds them at 96 only
  // (the forms in which ptxas does not spill it, found by trying each)
  constexpr bool QREG = VAR == VAR_GENERAL ? HD == 96 : HD <= 80;
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = a.N, H = a.H, W = a.W, UG = a.UG, KH = a.KH, KW = a.KW;
  Tiling T = bwd_tiling(KH, KW);  // the window variant: KH, KW = H, W
  T.up = pitch_4mod8(UG);
  const int up = T.up;
  const float c2 = a.scale * LOG2E;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y / NSL, sl = blockIdx.y - h * NSL, b = blockIdx.z, bh = b * a.nH + h;
  const bf16* qb = in_ptr<bf16>(a, 0, b, h);
  const bf16* kb = in_ptr<bf16>(a, 1, b, h);
  const bf16* vb = in_ptr<bf16>(a, 2, b, h);
  const bf16* gb = in_ptr<bf16>(a, 4, b, h);
  bf16* dqb = grad_ptr<bf16>(a, 0, b, h) + sl * NV;
  const bf16* rh = reinterpret_cast<const bf16*>(a.rh);
  const bf16* rw = reinterpret_cast<const bf16*>(a.rw);
  const float* Ug = a.U + (size_t)bh * N * UG;
  const float* Lg = a.L + (size_t)bh * N;
  const float* Dg = a.D + (size_t)bh * N;
  const Geo geo{0, 0, 0};
  const int chunks = NV / 8 + (sl == 0 ? (a.HP + a.WQ) / 4 : 0);  // 16-byte stores of a row
  int jy = 0;  // the padded row (within a tile) of each n8 tile of slots, 3 bits each
  for (int j = 0; j < 8; ++j) jy |= (j * 8 / T.twp) << (3 * j);
  const bool one_row = T.rows == 1;
  uint32_t qa[QREG ? HD / 16 : 1][4], ga[QREG ? HD / 16 : 1][4];
  float uw[JW ? JW : 1][4], dsc[JW ? JW : 1][4], dq[NT][4];

  if constexpr (VAR == VAR_WINDOW) {
    // k, v resident (slot = ky * WP + kx); q and dO interleaved per 16-row
    // q tile (the tile's finished dq, f32, is staged over them); u rows
    const int NS = window_slots(T, H), NQ = (N + 15) & ~15;
    bf16* Ks = reinterpret_cast<bf16*>(smem);
    bf16* Vs = Ks + NS * LDK;
    bf16* QG = Vs + NS * LDK;
    float* U = reinterpret_cast<float*>(smem + align128(sizeof(bf16) * (size_t)(2 * NS + 2 * NQ) * LDK));
    auto dq_row = [&](int r) { return reinterpret_cast<float*>(QG + (r >> 4) * 32 * LDK) + (r & 15) * LDQ; };
    constexpr int CH = HD * 2 / 16;
    for (int c = threadIdx.x; c < 2 * NQ * CH; c += blockDim.x) {
      const int r2 = c / CH, part = c - r2 * CH, which = r2 / NQ, r = r2 - which * NQ;
      const bf16* src = which ? gb : qb;
      const long long sn = a.st[which ? 4 : 0][2];
      cp_async16(QG + ((r >> 4) * 32 + which * 16 + (r & 15)) * LDK + part * 8,
                 r < N ? src + (long long)r * sn + part * 8 : src, r < N);
    }
    for (int c = threadIdx.x; c < NQ * (UG / 4); c += blockDim.x) {
      const int r = c / (UG / 4), part = c - r * (UG / 4);
      cp_async16(U + r * up + part * 4, r < N ? Ug + (size_t)r * UG + part * 4 : Ug, r < N);
    }
    load_slots<HD, LDK, false>(Ks, kb, a.st[1][2], NS, 0, 0, T.wp, H, H, W, W, geo, threadIdx.x, blockDim.x);
    load_slots<HD, LDK, false>(Vs, vb, a.st[2][2], NS, 0, 0, T.wp, H, H, W, W, geo, threadIdx.x, blockDim.x);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int qt = warp; qt * 16 < N; qt += blockDim.x / 32) {
      const bf16* Qw = QG + qt * 32 * LDK;
      const bf16* Gw = Qw + 16 * LDK;
      const int r0 = qt * 16 + g, r1 = r0 + 8;
      const float L0 = r0 < N ? Lg[r0] : 0.f, L1 = r1 < N ? Lg[r1] : 0.f;
      const float D0 = r0 < N ? Dg[r0] : 0.f, D1 = r1 < N ? Dg[r1] : 0.f;
      if constexpr (QREG) {
        load_a_frags<HD, LDK>(qa, Qw, g, t);
        load_a_frags<HD, LDK>(ga, Gw, g, t);
      }
      float* U0 = U + r0 * up;
      float* U1 = U0 + 8 * up;
      load_uw(uw, U0, U1, T, 0, t);
#pragma unroll
      for (int j = 0; j < JW; ++j) dsc[j][0] = dsc[j][1] = dsc[j][2] = dsc[j][3] = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
      float rs0 = 0.f, rs1 = 0.f;
      for (int it = 0; it < T.ntiles; ++it) {
        const int ky0 = it * T.rows;
        const int nj = min(T.rows, H - ky0) * T.wp / 8;
        dq_tile_any<HD, JW, QREG>(dq, dsc, rs0, rs1, qa, ga, Qw, Gw, Ks + ky0 * T.wp * LDK,
                                  Vs + ky0 * T.wp * LDK, nj, uw, nullptr, nullptr, nullptr,
                                  nullptr, U0, U1, ky0, jy, one_row, c2, L0, L1, D0, D1, sl, lane);
        if (T.rows == 1) {
          if (t == 0) { U0[ky0] = rs0; U1[ky0] = rs1; }
          rs0 = rs1 = 0.f;
        }
      }
      store_dsc(U0, U1, dsc, T, jy, W, t);
      __syncwarp();  // every lane's q / dO reads of the tile are done
      float* D0w = dq_row(qt * 16 + g);
      float* D1w = dq_row(qt * 16 + g + 8);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int d = n * 8 + 2 * t;
        D0w[d] = dq[n][0] * a.scale;
        D0w[d + 1] = dq[n][1] * a.scale;
        D1w[d] = dq[n][2] * a.scale;
        D1w[d + 1] = dq[n][3] * a.scale;
      }
    }
    __syncthreads();
    const int py = (W + 15) / 16, px = (H + 15) / 16;
    table_terms<HD>(dq_row, U, up, T.uwo, rh, rw, H, W, H * py, W * px,
                    [&](int item, int& y, int& row0, int& rs, int& ni) {
                      y = item / py;
                      const int p = item - y * py;
                      row0 = y * W + p * 16; rs = 1; ni = min(16, W - p * 16);
                    },
                    [&](int item, int& x, int& row0, int& rs, int& ni) {
                      x = item / px;
                      const int p = item - x * px;
                      row0 = p * 16 * W + x; rs = W; ni = min(16, H - p * 16);
                    }, sl);
    for (int c = threadIdx.x; c < N * chunks; c += blockDim.x) {
      const int r = c / chunks, part = c - r * chunks;
      store_q_row<NV>(a, dqb, dq_row(r), U + r * up, U + r * up + T.uwo, r, bh, sl, part);
    }
  } else {
    constexpr int ST = dq_ring<HD>();
    const int PY = blockDim.x / 16, QR = 8 * PY;
    bf16* Qs = reinterpret_cast<bf16*>(smem);
    bf16* Gs = Qs + QR * LDK;
    unsigned char* ring = smem + align128(sizeof(bf16) * 2 * QR * LDK);
    const size_t ring_bytes = sizeof(bf16) * ST * 64 * 2 * LDK;
    const size_t stage_bytes = sizeof(float) * QR * LDQ;
    bf16* Kb = reinterpret_cast<bf16*>(ring);
    bf16* Vb = Kb + ST * 64 * LDK;
    float* U = reinterpret_cast<float*>(ring + align128(ring_bytes > stage_bytes ? ring_bytes : stage_bytes));
    float* Cs = U + QR * up;  // VAR_GENERAL: dSc rows (pitch uwl), summed tile by tile
    float* Dq = reinterpret_cast<float*>(ring);  // after the walk
    const int pnx = (W + 7) / 8;
    const int qy0 = blockIdx.x / pnx * PY, qx0 = (blockIdx.x % pnx) * 8;
    auto issue = [&](int it, int s) {
      const TileAt ta = tile_at(T, it, KH);
      load_slots<HD, LDK, false>(Kb + s * 64 * LDK, kb, a.st[1][2], 64, ta.ky0, ta.kx0, T.twp,
                                 T.rows, KH, KW, W, geo, threadIdx.x, blockDim.x);
      load_slots<HD, LDK, false>(Vb + s * 64 * LDK, vb, a.st[2][2], 64, ta.ky0, ta.kx0, T.twp,
                                 T.rows, KH, KW, W, geo, threadIdx.x, blockDim.x);
    };
    load_patch<HD, LDK, false>(Qs, qb, a.st[0][2], QR, qy0, qx0, H, W, geo, threadIdx.x, blockDim.x);
    load_patch<HD, LDK, false>(Gs, gb, a.st[4][2], QR, qy0, qx0, H, W, geo, threadIdx.x, blockDim.x);
    for (int c = threadIdx.x; c < QR * (UG / 4); c += blockDim.x) {
      const int r = c / (UG / 4), part = c - r * (UG / 4);
      const int qy = qy0 + (r >> 3), qx = qx0 + (r & 7);
      const bool ok = qy < H && qx < W;
      cp_async16(U + r * up + part * 4, ok ? Ug + (size_t)(qy * W + qx) * UG + part * 4 : Ug, ok);
    }
    cp_async_commit();
    if constexpr (VAR == VAR_GENERAL)
      for (int i = threadIdx.x; i < QR * T.uwl; i += blockDim.x) Cs[i] = 0.f;
#pragma unroll
    for (int s = 0; s < ST - 1; ++s) {
      if (s < T.ntiles) issue(s, s);
      cp_async_commit();
    }
    // rows g and g + 8 of the warp: patch cells (2 warp, g) and (2 warp + 1, g)
    const int qx = qx0 + g, qy = qy0 + 2 * warp;
    const bool ok0 = qx < W && qy < H, ok1 = qx < W && qy + 1 < H;
    const int tok0 = qy * W + qx, tok1 = tok0 + W;
    const float L0 = ok0 ? Lg[tok0] : 0.f, L1 = ok1 ? Lg[tok1] : 0.f;
    const float D0 = ok0 ? Dg[tok0] : 0.f, D1 = ok1 ? Dg[tok1] : 0.f;
    const bf16* Qw = Qs + warp * 16 * LDK;
    const bf16* Gw = Gs + warp * 16 * LDK;
    float* U0 = U + (warp * 16 + g) * up;
    float* U1 = U0 + 8 * up;
#pragma unroll
    for (int j = 0; j < JW; ++j) dsc[j][0] = dsc[j][1] = dsc[j][2] = dsc[j][3] = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
    float rs0 = 0.f, rs1 = 0.f;
    for (int it = 0; it < T.ntiles; ++it) {
      cp_async_wait<ST - 2>();
      __syncthreads();  // tile it (and, at it = 0, q, dO, u) visible; tile it - 1's slot free
      if (it + ST - 1 < T.ntiles) issue(it + ST - 1, (it + ST - 1) % ST);
      cp_async_commit();
      if (it == 0) {
        if constexpr (QREG) {
          load_a_frags<HD, LDK>(qa, Qw, g, t);
          load_a_frags<HD, LDK>(ga, Gw, g, t);
        }
        if constexpr (VAR == VAR_ROWS) load_uw(uw, U0, U1, T, 0, t);
      }
      const TileAt ta = tile_at(T, it, KH);
      const int s = it % ST;
      // VAR_GENERAL: this segment's u_w terms and dSc sums in shared memory
      // (each key column's owned by one thread)
      float* C0 = Cs + (warp * 16 + g) * T.uwl + ta.kx0;
      dq_tile_any<HD, JW, QREG>(dq, dsc, rs0, rs1, qa, ga, Qw, Gw, Kb + s * 64 * LDK,
                                Vb + s * 64 * LDK, ta.nj, uw, U0 + T.uwo + ta.kx0,
                                U1 + T.uwo + ta.kx0, C0, C0 + 8 * T.uwl, U0, U1, ta.ky0, jy,
                                one_row, c2, L0, L1, D0, D1, sl, lane);
      if (T.rows == 1 && ta.kx0 + 64 >= T.wp) {  // the row's last segment: its u_h entry is dead
        if (t == 0) { U0[ta.ky0] = rs0; U1[ta.ky0] = rs1; }
        rs0 = rs1 = 0.f;
      }
    }
    if constexpr (VAR == VAR_ROWS) store_dsc(U0, U1, dsc, T, jy, KW, t);
    __syncthreads();  // the walk is over: the ring takes the staged dq
    float* D0w = Dq + (warp * 16 + g) * LDQ;
    float* D1w = D0w + 8 * LDQ;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = n * 8 + 2 * t;
      D0w[d] = dq[n][0] * a.scale;
      D0w[d + 1] = dq[n][1] * a.scale;
      D1w[d] = dq[n][2] * a.scale;
      D1w[d + 1] = dq[n][3] * a.scale;
    }
    __syncthreads();
    const float* Ca = VAR == VAR_GENERAL ? Cs : U + T.uwo;  // dSc rows
    const int cp = VAR == VAR_GENERAL ? T.uwl : up;
    const int nx = min(8, W - qx0), ny = min(PY, H - qy0);
    auto dq_row = [&](int r) { return Dq + r * LDQ; };
    // patch row py: its cells share Rh[qy0 + py]; patch column px: Rw[qx0 +
    // px]; over the key rectangle's KH rows / KW columns
    constexpr int UNR = VAR == VAR_GENERAL && HD == 80 ? 2 : 1;
    for (int item = warp; item < ny; item += blockDim.x / 32)
      table_term<HD, UNR>(dq_row, U, up, item * 8, 1, nx, rh + (size_t)(qy0 + item) * H * HD, KH,
                          sl, lane);
    __syncthreads();
    for (int item = warp; item < nx; item += blockDim.x / 32)
      table_term<HD, UNR>(dq_row, Ca, cp, item, 8, ny, rw + (size_t)(qx0 + item) * W * HD, KW,
                          sl, lane);
    __syncthreads();
    for (int c = threadIdx.x; c < QR * chunks; c += blockDim.x) {
      const int r = c / chunks, part = c - r * chunks;
      const int cy = qy0 + (r >> 3), cx = qx0 + (r & 7);
      if (cy < H && cx < W)
        store_q_row<NV>(a, dqb, Dq + r * LDQ, U + r * up, Ca + r * cp, cy * W + cx, bh, sl, part);
    }
  }
}

// ---------------------------------------------------------------------------
// stage 3 (bf16): dRh[A] = dSr^T q over the rows with y = A (dRw[A] over
// x = A), TF32 products; one block per (table, A, 16 table columns, slice,
// column group). The column groups (a grid dimension: the slice's n8 tiles
// split NB ways) give a map of few rows (a 14 x 14 window: 28 (table, A)
// pairs) enough blocks to keep the loads of every SM in flight.
// ---------------------------------------------------------------------------
constexpr int RB = 128;  // rows (terms of the sum) a chunk: two k8 steps a warp
constexpr int RST = 4;   // chunks in the ring
constexpr int RAP = 24;  // f32 pitch of a chunk's 16 dS columns

// n8 tiles of the slice a block takes, with nb groups
template <int HD> __host__ __device__ constexpr int relgrad_tiles(int nb) {
  return (out_cols<HD>() / 8 + nb - 1) / nb;
}

template <int HD>
__host__ __device__ inline size_t relgrad_bf16_smem(int nb) {
  const size_t ldb = relgrad_tiles<HD>(nb) * 8 + 8;
  const size_t ring = RST * (sizeof(float) * RB * RAP + sizeof(bf16) * RB * ldb);
  const size_t red = sizeof(float) * 8 * 16 * (relgrad_tiles<HD>(nb) * 8 + 4);
  return ring > red ? ring : red;
}

template <int HD>
__global__ void __launch_bounds__(256) relgrad_bf16_kernel(const BwdArgs a) {
  constexpr int NV = out_cols<HD>(), NT = NV / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, W = a.W, N = a.N, sl = blockIdx.y;
  const int per = relgrad_tiles<HD>(gridDim.z), n0 = blockIdx.z * per, nt = min(per, NT - n0);
  const int LDB = per * 8 + 8, LDR = per * 8 + 4;
  const size_t CHUNK = sizeof(float) * RB * RAP + sizeof(bf16) * RB * LDB;
  const int mh = (a.KH + 15) / 16, mw = (a.KW + 15) / 16;
  int blk = blockIdx.x;
  const bool is_h = blk < H * mh;
  if (!is_h) blk -= H * mh;
  const int mt_n = is_h ? mh : mw, A = blk / mt_n, mt = blk - A * mt_n;
  const int Lc = is_h ? a.KH : a.KW;  // the table's columns in the key rectangle
  const int Lp = is_h ? H : W;        // the table's row pitch
  const int M = is_h ? W : H;   // rows with y (x) = A per (batch, head)
  const float* src = is_h ? a.dsr : a.dsc;
  const int sp = is_h ? a.HP : a.WQ;
  const int K = a.B * a.nH * M, nchunks = (K + RB - 1) / RB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // a thread's row of each chunk (two threads a row, each every other
  // 16-byte piece): its addresses cost two divisions a chunk
  const int r = threadIdx.x % RB, half = threadIdx.x / RB;
  auto issue = [&](int ch, int s) {
    float* As = reinterpret_cast<float*>(smem + s * CHUNK);
    bf16* Bs = reinterpret_cast<bf16*>(smem + s * CHUNK + sizeof(float) * RB * RAP);
    const int kk = ch * RB + r;
    const bool ok = kk < K;
    const int bh = ok ? kk / M : 0, m = kk - bh * M, b = bh / a.nH;
    const int i = is_h ? A * W + m : m * W + A;
    const float* g4 = src + ((size_t)bh * N + i) * sp + mt * 16;
    const bf16* q = in_ptr<bf16>(a, 0, b, bh - b * a.nH) + (long long)i * a.st[0][2] + sl * NV + n0 * 8;
    for (int part = half; part < 4 + nt; part += 2) {
      if (part < 4) cp_async16(As + r * RAP + part * 4, ok ? g4 + part * 4 : src, ok);
      else
        cp_async16(Bs + r * LDB + (part - 4) * 8,
                   ok ? q + (part - 4) * 8 : reinterpret_cast<const bf16*>(a.in[0]), ok);
    }
  };
#pragma unroll
  for (int s = 0; s < RST - 1; ++s) {
    if (s < nchunks) issue(s, s);
    cp_async_commit();
  }
  float c[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<RST - 2>();
    __syncthreads();
    if (ch + RST - 1 < nchunks) issue(ch + RST - 1, (ch + RST - 1) % RST);
    cp_async_commit();
    const float* As = reinterpret_cast<const float*>(smem + (ch % RST) * CHUNK);
    const unsigned short* Bs =
        reinterpret_cast<const unsigned short*>(smem + (ch % RST) * CHUNK + sizeof(float) * RB * RAP);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int k0 = (warp * 2 + ks) * 8;
      float af[4];
      af[0] = tf32(As[(k0 + t) * RAP + g]);
      af[1] = tf32(As[(k0 + t) * RAP + g + 8]);
      af[2] = tf32(As[(k0 + t + 4) * RAP + g]);
      af[3] = tf32(As[(k0 + t + 4) * RAP + g + 8]);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (n < nt)
          mma1688_tf32(c[n], af, bf16_bits_to_f32(Bs[(k0 + t) * LDB + n * 8 + g]),
                       bf16_bits_to_f32(Bs[(k0 + t + 4) * LDB + n * 8 + g]));
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n < nt) {
      const int d = n * 8 + 2 * t;
      red[(warp * 16 + g) * LDR + d] = c[n][0];
      red[(warp * 16 + g) * LDR + d + 1] = c[n][1];
      red[(warp * 16 + g + 8) * LDR + d] = c[n][2];
      red[(warp * 16 + g + 8) * LDR + d + 1] = c[n][3];
    }
  }
  __syncthreads();
  float* out = is_h ? a.drh : a.drw;
  for (int idx = threadIdx.x; idx < 16 * nt * 8; idx += blockDim.x) {
    const int row = idx / (nt * 8), d = idx - row * (nt * 8);
    if (mt * 16 + row < Lc) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) sum += red[(w * 16 + row) * LDR + d];  // warps in order
      float* o = out + ((size_t)A * Lp + mt * 16 + row) * HD + sl * NV + n0 * 8 + d;
      *o = (a.acc & 2) ? *o + sum : sum;
    }
  }
}

// column groups of stage 3: the fewest (a power of two, at most one a n8
// tile) that give at least one block an SM
template <int HD>
static int relgrad_groups(int blocks) {
  int nb = 1;
  while (blocks * nb < 132 && nb * 2 <= out_cols<HD>() / 8) nb *= 2;
  return nb;
}

// ---------------------------------------------------------------------------
// f32 kernels: the same stages as plain SIMT loops (a warp owns 16 rows; a
// lane owns keys / q rows (lane, lane + 32) and dims lane + 32 e, e < DE);
// FR rows a block and a tile: 64, or 32 above head dim 128
// ---------------------------------------------------------------------------
template <int HD> __host__ __device__ constexpr int f32_rows() { return HD > 128 ? 32 : 64; }

// u rows, D and lse2 of 64 tokens by scalar dot products
template <int HD>
__global__ void __launch_bounds__(128) prep_f32_kernel(const BwdArgs a) {
  const int N = a.N, H = a.H, W = a.W, UG = a.UG, KH = a.KH, KW = a.KW;
  const Tiling T = bwd_tiling(KH, KW);
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z, bh = b * a.nH + h;
  const float* qb = in_ptr<float>(a, 0, b, h);
  const float* rh = reinterpret_cast<const float*>(a.rh);
  const float* rw = reinterpret_cast<const float*>(a.rw);
  float* Ug = a.U + (size_t)bh * N * UG;
  for (int idx = threadIdx.x; idx < 64 * UG; idx += blockDim.x) {
    const int r = idx / UG, j = idx - r * UG, qi = q0 + r;
    if (qi >= N) continue;
    const float* qr = qb + (long long)qi * a.st[0][2];
    const int y = qi / W, x = qi - y * W;
    float v = 0.f;
    if (j < KH) v = dot_row<float, HD>(qr, rh + ((size_t)y * H + j) * HD) * LOG2E;
    else if (j >= T.uwo + KW) v = -INFINITY;
    else if (j >= T.uwo) v = dot_row<float, HD>(qr, rw + ((size_t)x * W + j - T.uwo) * HD) * LOG2E;
    Ug[(size_t)qi * UG + j] = v;
  }
  const float* ob = in_ptr<float>(a, 3, b, h);
  const float* gb = in_ptr<float>(a, 4, b, h);
  for (int r = threadIdx.x; r < 64; r += blockDim.x) {
    const int qi = q0 + r;
    if (qi < N) {
      a.D[(size_t)bh * N + qi] =
          dot_row<float, HD>(ob + (long long)qi * a.st[3][2], gb + (long long)qi * a.st[4][2]);
      a.L[(size_t)bh * N + qi] = a.lse[(size_t)bh * N + qi] * LOG2E;
    }
  }
}

// rows [t0, t0 + FR) of the u rows, lse2 and D into shared memory (rows past N: 0)
template <int FR>
__device__ __forceinline__ void load_u_f32(float* U, float* Ls, float* Ds, const BwdArgs& a,
                                           int bh, int t0) {
  const int N = a.N, UG = a.UG;
  const float* Ug = a.U + (size_t)bh * N * UG;
  for (int idx = threadIdx.x; idx < FR * UG; idx += blockDim.x) {
    const int r = idx / UG, j = idx - r * UG;
    U[idx] = t0 + r < N ? Ug[(size_t)(t0 + r) * UG + j] : 0.f;
  }
  for (int r = threadIdx.x; r < FR; r += blockDim.x) {
    Ls[r] = t0 + r < N ? a.L[(size_t)bh * N + t0 + r] : 0.f;
    Ds[r] = t0 + r < N ? a.D[(size_t)bh * N + t0 + r] : 0.f;
  }
}

// q, dO, k, v tiles and ns tiles of FR x FR logits
template <int HD>
__host__ __device__ constexpr size_t f32_tiles_bytes(int ns) {
  constexpr int FR = f32_rows<HD>();
  return align128(sizeof(float) * (4 * FR * (HD + 8) + ns * FR * (FR + 4)));
}

// H, W: the key rectangle
template <int HD>
__host__ __device__ inline size_t dkdv_f32_smem(int H, int W) {
  constexpr int FR = f32_rows<HD>();
  return f32_tiles_bytes<HD>(2) + sizeof(float) * FR * (size_t)(u_global(bwd_tiling(H, W)) + 2);
}

template <int HD>
__global__ void __launch_bounds__(2 * f32_rows<HD>(), 1) dkdv_f32_kernel(const BwdArgs a) {
  constexpr int FR = f32_rows<HD>(), LDT = HD + 8, LDS = FR + 4;
  constexpr int NV = out_cols<HD>(), NSL = HD / NV, DE = (NV + 31) / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + FR * LDT;
  float* Qs = Vs + FR * LDT;
  float* Gs = Qs + FR * LDT;
  float* Ps = Gs + FR * LDT;
  float* DSs = Ps + FR * LDS;
  const int N = a.N, W = a.W, UG = a.UG, KW = a.KW, NK = a.KH * a.KW;
  const Tiling T = bwd_tiling(a.KH, KW);
  float* U = reinterpret_cast<float*>(smem + f32_tiles_bytes<HD>(2));
  float* Ls = U + FR * UG;
  float* Ds = Ls + FR;
  const float c2 = a.scale * LOG2E;
  const int k0 = blockIdx.x * FR, h = blockIdx.y / NSL, sl = blockIdx.y - h * NSL, b = blockIdx.z;
  const int bh = b * a.nH + h;
  const float* qb = in_ptr<float>(a, 0, b, h);
  const float* gb = in_ptr<float>(a, 4, b, h);

  // keys of the rectangle (key t: row t / KW, column t % KW)
  load_key_tile<float, HD, FR>(Ks, in_ptr<float>(a, 1, b, h), a.st[1][2], k0, NK, KW, W);
  load_key_tile<float, HD, FR>(Vs, in_ptr<float>(a, 2, b, h), a.st[2][2], k0, NK, KW, W);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* Kw = Ks + warp * 16 * LDT;
  const float* Vw = Vs + warp * 16 * LDT;
  float* Pw = Ps + warp * 16 * LDS;
  float* Dw = DSs + warp * 16 * LDS;
  float dk[16][DE], dv[16][DE];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int e = 0; e < DE; ++e) dk[r][e] = dv[r][e] = 0.f;

  for (int q0 = 0; q0 < N; q0 += FR) {
    __syncthreads();  // the previous q tile is consumed
    load_tile<float, HD, FR>(Qs, qb, a.st[0][2], q0, N);
    load_tile<float, HD, FR>(Gs, gb, a.st[4][2], q0, N);
    cp_async_commit();
    load_u_f32<FR>(U, Ls, Ds, a, bh, q0);
    cp_async_wait<0>();
    __syncthreads();
    for (int r = 0; r < 16; ++r) {
      const int key = k0 + warp * 16 + r;
      const int ky = key / KW, kx = key - ky * KW;
      for (int c = lane; c < FR; c += 32) {
        const int qi = q0 + c;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
          s = fmaf(Kw[r * LDT + d], Qs[c * LDT + d], s);
          dp = fmaf(Vw[r * LDT + d], Gs[c * LDT + d], dp);
        }
        float p = 0.f, ds = 0.f;
        if (key < NK && qi < N) {
          p = exp2f(fmaf(s, c2, U[c * UG + ky] + U[c * UG + T.uwo + kx] - Ls[c]));
          ds = p * (dp - Ds[c]);
        }
        Pw[r * LDS + c] = p;
        Dw[r * LDS + c] = ds;
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
#pragma unroll
      for (int e = 0; e < DE; ++e) {
        const int d = lane + 32 * e;
        if (d >= NV) continue;
        float av = dv[r][e], ak = dk[r][e];
#pragma unroll 8
        for (int c = 0; c < FR; ++c) {
          av = fmaf(Pw[r * LDS + c], Gs[c * LDT + sl * NV + d], av);
          ak = fmaf(Dw[r * LDS + c], Qs[c * LDT + sl * NV + d], ak);
        }
        dv[r][e] = av;
        dk[r][e] = ak;
      }
    }
    __syncwarp();
  }
  float* dkb = grad_ptr<float>(a, 1, b, h) + sl * NV;
  float* dvb = grad_ptr<float>(a, 2, b, h) + sl * NV;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int key = k0 + warp * 16 + r;
    if (key >= NK) continue;
    const int ky = key / KW, tok = ky * W + key - ky * KW;
#pragma unroll
    for (int e = 0; e < DE; ++e) {
      const int d = lane + 32 * e;
      if (d >= NV) continue;
      dkb[(long long)tok * a.st[6][2] + d] = dk[r][e] * a.scale;
      dvb[(long long)tok * a.st[7][2] + d] = dv[r][e];
    }
  }
}

// stage 2 (f32): add one key tile's dS row sums (per key row y) and column
// sums (per key column x) into the warp's 16 rows of Acc ([0, H): y,
// [uwo, uwo + W): x). Sd holds the warp's 16 rows of dS with pitch LDS. Each
// (row, column) is summed by one lane, in key order.
template <int FR>
__device__ __forceinline__ void accumulate_rel(float* Acc, int up, int uwo, const float* Sd,
                                               int k0, int N, int H, int W, int lane) {
  constexpr int LDS = FR + 4;
  const int kend = min(k0 + FR, N);
  const int y_lo = k0 / W, nY = (kend - 1) / W - y_lo + 1;
  for (int idx = lane; idx < 16 * nY; idx += 32) {
    const int r = idx / nY, y = y_lo + idx % nY;
    const int hi = min((y + 1) * W, kend) - k0;
    float s = 0.f;
    for (int c = max(y * W, k0) - k0; c < hi; ++c) s += Sd[r * LDS + c];
    Acc[r * up + y] += s;
  }
  const int xs = k0 % W;
  for (int idx = lane; idx < 16 * W; idx += 32) {
    const int r = idx / W, x = idx % W;
    float s = 0.f;
    for (int c = (x - xs + W) % W; c < kend - k0; c += W) s += Sd[r * LDS + c];
    Acc[r * up + uwo + x] += s;
  }
}

// H, W: the key rectangle
template <int HD>
__host__ __device__ inline size_t dq_f32_smem(int H, int W) {
  constexpr int FR = f32_rows<HD>();
  return f32_tiles_bytes<HD>(1) + sizeof(float) * FR * (size_t)(2 * u_global(bwd_tiling(H, W)) + 2);
}

template <int HD>
__global__ void __launch_bounds__(2 * f32_rows<HD>(), 1) dq_f32_kernel(const BwdArgs a) {
  constexpr int FR = f32_rows<HD>(), LDT = HD + 8, LDS = FR + 4;
  constexpr int NV = out_cols<HD>(), NSL = HD / NV, DE = (NV + 31) / 32, LDQ = NV + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Gs = Qs + FR * LDT;
  float* Ks = Gs + FR * LDT;
  float* Vs = Ks + FR * LDT;
  float* Sd = Vs + FR * LDT;
  const int N = a.N, H = a.H, W = a.W, UG = a.UG, KH = a.KH, KW = a.KW, NK = KH * KW;
  const Tiling T = bwd_tiling(KH, KW);
  float* U = reinterpret_cast<float*>(smem + f32_tiles_bytes<HD>(1));
  float* Acc = U + FR * UG;
  float* Ls = Acc + FR * UG;
  float* Ds = Ls + FR;
  const float c2 = a.scale * LOG2E;
  const int q0 = blockIdx.x * FR, h = blockIdx.y / NSL, sl = blockIdx.y - h * NSL, b = blockIdx.z;
  const int bh = b * a.nH + h;
  const float* kb = in_ptr<float>(a, 1, b, h);
  const float* vb = in_ptr<float>(a, 2, b, h);

  load_tile<float, HD, FR>(Qs, in_ptr<float>(a, 0, b, h), a.st[0][2], q0, N);
  load_tile<float, HD, FR>(Gs, in_ptr<float>(a, 4, b, h), a.st[4][2], q0, N);
  cp_async_commit();
  load_u_f32<FR>(U, Ls, Ds, a, bh, q0);
  for (int i = threadIdx.x; i < FR * UG; i += blockDim.x) Acc[i] = 0.f;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* Qw = Qs + warp * 16 * LDT;
  const float* Gw = Gs + warp * 16 * LDT;
  float* Sw = Sd + warp * 16 * LDS;
  float dq[16][DE];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int e = 0; e < DE; ++e) dq[r][e] = 0.f;

  for (int k0 = 0; k0 < NK; k0 += FR) {  // the rectangle's keys
    __syncthreads();  // the previous k/v tile is consumed (and U, Acc are set on entry)
    load_key_tile<float, HD, FR>(Ks, kb, a.st[1][2], k0, NK, KW, W);
    load_key_tile<float, HD, FR>(Vs, vb, a.st[2][2], k0, NK, KW, W);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r, qi = q0 + row;
      for (int c = lane; c < FR; c += 32) {
        const int key = k0 + c;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
          s = fmaf(Qw[r * LDT + d], Ks[c * LDT + d], s);
          dp = fmaf(Gw[r * LDT + d], Vs[c * LDT + d], dp);
        }
        float ds = 0.f;
        if (key < NK && qi < N) {
          const int ky = key / KW, kx = key - ky * KW;
          ds = exp2f(fmaf(s, c2, U[row * UG + ky] + U[row * UG + T.uwo + kx] - Ls[row])) *
               (dp - Ds[row]);
        }
        Sw[r * LDS + c] = ds;
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
#pragma unroll
      for (int e = 0; e < DE; ++e) {
        const int d = lane + 32 * e;
        if (d >= NV) continue;
        float acc = dq[r][e];
#pragma unroll 8
        for (int c = 0; c < FR; ++c) acc = fmaf(Sw[r * LDS + c], Ks[c * LDT + sl * NV + d], acc);
        dq[r][e] = acc;
      }
    }
    accumulate_rel<FR>(Acc + warp * 16 * UG, UG, T.uwo, Sw, k0, NK, KH, KW, lane);
    __syncwarp();
  }
  // every warp is done with the last k tile: it takes the finished dq
  __syncthreads();
  float* Dq = Ks;
  static_assert(FR * LDQ <= 2 * FR * LDT, "the finished dq is staged in the k / v tiles");
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int e = 0; e < DE; ++e) {
      const int d = lane + 32 * e;
      if (d < NV) Dq[(warp * 16 + r) * LDQ + d] = dq[r][e] * a.scale;
    }
  __syncthreads();
  // dq += the tables' terms; dq, dSr, dSc out
  const float* rh = reinterpret_cast<const float*>(a.rh);
  const float* rw = reinterpret_cast<const float*>(a.rw);
  float* dqb = grad_ptr<float>(a, 0, b, h) + sl * NV;
  for (int idx = threadIdx.x; idx < FR * NV; idx += blockDim.x) {
    const int r = idx / NV, d = idx % NV, qi = q0 + r;
    if (qi >= N) continue;
    const int y = qi / W, x = qi - y * W;
    const float* ar = Acc + r * UG;
    float acc = Dq[r * LDQ + d];
    const float* th = rh + (size_t)y * H * HD + sl * NV + d;
    for (int j = 0; j < KH; ++j) acc = fmaf(ar[j], th[(size_t)j * HD], acc);
    const float* tw = rw + (size_t)x * W * HD + sl * NV + d;
    for (int j = 0; j < KW; ++j) acc = fmaf(ar[T.uwo + j], tw[(size_t)j * HD], acc);
    float* dst = dqb + (long long)qi * a.st[5][2] + d;
    *dst = (a.acc & 1) ? *dst + acc : acc;
  }
  if (sl != 0) return;
  for (int idx = threadIdx.x; idx < FR * (a.HP + a.WQ); idx += blockDim.x) {
    const int r = idx / (a.HP + a.WQ), j = idx % (a.HP + a.WQ), qi = q0 + r;
    if (qi >= N) continue;
    if (j < a.HP) a.dsr[((size_t)bh * N + qi) * a.HP + j] = j < KH ? Acc[r * UG + j] : 0.f;
    else {
      const int x = j - a.HP;
      a.dsc[((size_t)bh * N + qi) * a.WQ + x] = x < KW ? Acc[r * UG + T.uwo + x] : 0.f;
    }
  }
}

// stage 3 (f32): one block per (table row A, RG columns); 4 groups of HD
// threads split the (bh, i) terms and are summed in a fixed order
constexpr int RG = 4;

template <int HD>
__global__ void __launch_bounds__(4 * HD) relgrad_f32_kernel(const BwdArgs a) {
  __shared__ float red[4][RG][HD];
  const int H = a.H, W = a.W, N = a.N;
  const int nbh = (a.KH + RG - 1) / RG, nbw = (a.KW + RG - 1) / RG;
  int blk = blockIdx.x;
  const bool is_h = blk < H * nbh;
  if (!is_h) blk -= H * nbh;
  // L: the table's columns in the key rectangle, Lp its row pitch
  const int nb = is_h ? nbh : nbw, L = is_h ? a.KH : a.KW, Lp = is_h ? H : W, M = is_h ? W : H;
  const int A = blk / nb, c0 = (blk % nb) * RG;
  const float* src = is_h ? a.dsr : a.dsc;
  const int sp = is_h ? a.HP : a.WQ;
  const int d = threadIdx.x % HD, sp4 = threadIdx.x / HD;
  float acc[RG];
#pragma unroll
  for (int e = 0; e < RG; ++e) acc[e] = 0.f;
  const int total = a.B * a.nH * M;
  for (int tt = sp4; tt < total; tt += 4) {
    const int bh = tt / M, m = tt % M;
    const int i = is_h ? A * W + m : m * W + A;
    const float qv = in_ptr<float>(a, 0, bh / a.nH, bh % a.nH)[(long long)i * a.st[0][2] + d];
    const float* row = src + ((size_t)bh * N + i) * sp + c0;
#pragma unroll
    for (int e = 0; e < RG; ++e)
      if (c0 + e < L) acc[e] = fmaf(row[e], qv, acc[e]);
  }
#pragma unroll
  for (int e = 0; e < RG; ++e) red[sp4][e][d] = acc[e];
  __syncthreads();
  if (sp4 == 0) {
    float* out = is_h ? a.drh : a.drw;
#pragma unroll
    for (int e = 0; e < RG; ++e)
      if (c0 + e < L) {
        float* o = out + ((size_t)A * Lp + c0 + e) * HD + d;
        const float sum = red[0][e][d] + red[1][e][d] + red[2][e][d] + red[3][e][d];
        *o = (a.acc & 2) ? *o + sum : sum;
      }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <typename Kernel>
static int run(Kernel kern, dim3 grid, int threads, size_t smem, const BwdArgs& a, cudaStream_t s) {
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// float count of the scratch: per (batch, head) the u rows (UG a row), lse2
// and D, dSr (HP a row) and dSc (WQ a row); H, W: the key rectangle
static long long scratch_floats(int B, int nH, int N, int H, int W, int* UG, int* HP, int* WQ) {
  *UG = u_global(bwd_tiling(H, W));
  *HP = round16(H);
  *WQ = round16(W);
  return (long long)B * nH * N * (*UG + 2 + *HP + *WQ);
}

// whether the bf16 stage 1 / 2 variant applies (backward_plan's rule): the
// window variant takes the whole map only; rows / general go by the key
// rectangle's columns
template <int HD>
static bool variant_ok(int stage, int var, const BwdArgs& a) {
  const int N = a.N, H = a.H, W = a.W;
  const Tiling T = bwd_tiling(H, W);
  if (var == VAR_WINDOW) {
    const size_t smem = stage == 1 ? dkdv_bf16_smem<HD>(VAR_WINDOW, N, H, W)
                                   : dq_bf16_smem<HD>(VAR_WINDOW, N, H, W, H, W);
    return a.KH == H && a.KW == W && HD <= 128 && T.segs == 1 && H * T.wp <= 256 &&
           smem <= SMEM_LIMIT && (stage == 1 || T.wp == 16);
  }
  return var == VAR_ROWS ? a.KW <= 64 : var == VAR_GENERAL && a.KW > 64;
}

template <int HD>
static int launch_bf16(int stage, int var, BwdArgs& a, cudaStream_t s) {
  constexpr int NSL = HD / out_cols<HD>();
  const Tiling T = bwd_tiling(a.KH, a.KW);
  const int N = a.N, H = a.H, W = a.W, KH = a.KH, KW = a.KW;
  if ((stage == 1 || stage == 2) ? !variant_ok<HD>(stage, var, a) : var != VAR_ROWS)
    return (int)cudaErrorInvalidValue;
  switch (stage) {
    case 0:
      return run(prep_bf16_kernel<HD>, dim3((H + 7) / 8 * ((W + 7) / 8), a.nH, a.B), 128,
                 prep_bf16_smem<HD>(KH, KW), a, s);
    case 1: {
      const size_t smem = dkdv_bf16_smem<HD>(var, N, KH, KW);
      if constexpr (HD <= 128) {
        if (var == VAR_WINDOW)
          return run(dkdv_bf16_kernel<HD, VAR_WINDOW>, dim3(1, a.nH * NSL, a.B), 256, smem, a, s);
      }
      constexpr int TPB = dkdv_tiles<HD>();
      const dim3 grid((T.ntiles + TPB - 1) / TPB, a.nH * NSL, a.B);
      return var == VAR_ROWS ? run(dkdv_bf16_kernel<HD, VAR_ROWS>, grid, 128 * TPB, smem, a, s)
                             : run(dkdv_bf16_kernel<HD, VAR_GENERAL>, grid, 128 * TPB, smem, a, s);
    }
    case 2: {
      const size_t smem = dq_bf16_smem<HD>(var, N, H, W, KH, KW);
      if constexpr (HD <= 128) {
        if (var == VAR_WINDOW)
          return run(dq_bf16_kernel<HD, VAR_WINDOW, 2>, dim3(1, a.nH * NSL, a.B), 256, smem, a, s);
      }
      const int py = dq_patch_rows(HD, H, W);
      const dim3 grid((H + py - 1) / py * ((W + 7) / 8), a.nH * NSL, a.B);
      return var == VAR_ROWS ? run(dq_bf16_kernel<HD, VAR_ROWS, 8>, grid, 16 * py, smem, a, s)
                             : run(dq_bf16_kernel<HD, VAR_GENERAL, 0>, grid, 16 * py, smem, a, s);
    }
    case 3: {
      const int blocks = H * ((KH + 15) / 16) + W * ((KW + 15) / 16);
      const int nb = relgrad_groups<HD>(blocks * NSL);
      return run(relgrad_bf16_kernel<HD>, dim3(blocks, NSL, nb), 256, relgrad_bf16_smem<HD>(nb),
                 a, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <int HD>
static int launch_f32(int stage, int var, BwdArgs& a, cudaStream_t s) {
  constexpr int FR = f32_rows<HD>(), NSL = HD / out_cols<HD>();
  if (var != VAR_ROWS) return (int)cudaErrorInvalidValue;
  const dim3 tiles((a.N + FR - 1) / FR, a.nH * NSL, a.B);            // q rows
  const dim3 key_tiles((a.KH * a.KW + FR - 1) / FR, a.nH * NSL, a.B);  // the rectangle's keys
  switch (stage) {
    case 0:
      return run(prep_f32_kernel<HD>, dim3((a.N + 63) / 64, a.nH, a.B), 128, 0, a, s);
    case 1:
      return run(dkdv_f32_kernel<HD>, key_tiles, 2 * FR, dkdv_f32_smem<HD>(a.KH, a.KW), a, s);
    case 2:
      return run(dq_f32_kernel<HD>, tiles, 2 * FR, dq_f32_smem<HD>(a.KH, a.KW), a, s);
    case 3: {
      const int blocks = a.H * ((a.KH + RG - 1) / RG) + a.W * ((a.KW + RG - 1) / RG);
      return run(relgrad_f32_kernel<HD>, dim3(blocks), 4 * HD, 0, a, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// One stage (0 prep, 1 dk/dv, 2 dq, 3 table gradients) of the backward; run
// the four in order. variant: the stage's VAR_* as backward_plan picks it
// (VAR_ROWS for stages 0 and 3 and in f32); refused where it does not apply.
// inputs: q, k, v, O, dO; lse: the forward's (B, nH, N) f32 row log-sum-exps;
// grads: dq, dk, dv (strided (B, nH, N, hd) views); rh (H, H, hd), rw
// (W, W, hd) contiguous in the compute dtype; drh, drw contiguous f32;
// strides: 24 element strides, (batch, head, token) for q, k, v, O, dO, dq,
// dk, dv in turn; scratch: f32, at least scratch_floats() long (of the key
// rectangle). (ky0, kx0, kh, kw): the key rectangle of the launch (the whole
// map: 0, 0, H, W); run the four stages of one rectangle before the next's.
// acc: 1, stage 2 adds into dq; 2, stage 3 adds into drh / drw.
MSAM_EXPORT int msam_relpos_attention_bwd(int stage, int variant, const void* q, const void* k,
                                          const void* v, const void* o, const void* dout,
                                          const float* lse, const void* rh, const void* rw,
                                          void* dq, void* dk, void* dv, float* drh, float* drw,
                                          float* scratch, long long scratch_len, int B, int nH,
                                          int N, int H, int W, int hd, const long long* strides,
                                          float scale, int ky0, int kx0, int kh, int kw, int acc,
                                          int dtype, void* stream) {
  constexpr int NSL = MSAM_HD / out_cols<MSAM_HD>();
  if (N != H * W || B <= 0 || nH <= 0 || B > 65535 || nH * NSL > 65535 || hd != MSAM_HD)
    return (int)cudaErrorInvalidValue;
  if (ky0 < 0 || kx0 < 0 || kh <= 0 || kw <= 0 || ky0 + kh > H || kx0 + kw > W || acc < 0 ||
      acc > 3)
    return (int)cudaErrorInvalidValue;
  const size_t esz = dtype == MSAM_BF16 ? 2 : 4;
  const long long first = (long long)ky0 * W + kx0;  // the rectangle's first key token
  BwdArgs a;
  a.in[0] = q; a.in[3] = o; a.in[4] = dout;
  a.in[1] = (const char*)k + first * strides[5] * esz;
  a.in[2] = (const char*)v + first * strides[8] * esz;
  a.grad[0] = dq;
  a.grad[1] = (char*)dk + first * strides[20] * esz;
  a.grad[2] = (char*)dv + first * strides[23] * esz;
  a.rh = (const char*)rh + (size_t)ky0 * hd * esz;
  a.rw = (const char*)rw + (size_t)kx0 * hd * esz;
  a.drh = drh + (size_t)ky0 * hd;
  a.drw = drw + (size_t)kx0 * hd;
  a.lse = lse;
  a.B = B; a.nH = nH; a.N = N; a.H = H; a.W = W; a.scale = scale;
  a.KH = kh; a.KW = kw; a.acc = acc;
  if (scratch_len < scratch_floats(B, nH, N, kh, kw, &a.UG, &a.HP, &a.WQ))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * nH * N;
  a.U = scratch;
  a.L = a.U + rows * a.UG;
  a.D = a.L + rows;
  a.dsr = a.D + rows;
  a.dsc = a.dsr + rows * a.HP;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MSAM_BF16) return launch_bf16<MSAM_HD>(stage, variant, a, s);
  if (dtype == MSAM_F32) return launch_f32<MSAM_HD>(stage, variant, a, s);
  return (int)cudaErrorInvalidValue;
}

MSAM_ERROR_STRING(msam_relpos_attention_bwd)
