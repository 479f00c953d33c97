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
// this is four launches (the `stage` argument), each deterministic:
//
//   0 prep:  per (64-row q tile, head, batch): the per-row tables
//            u = q . Rh | q . Rw (N x (H + W), f32), the row log-sum-exp by the
//            forward's own online-softmax walk (no p v product), and D.
//   1 dk/dv: per (64-key tile, head, batch), walking q tiles of 32 rows:
//            S^T = k q^T on the tensor cores, P^T and dS^T in registers,
//            repacked as A fragments of dv += P^T dO and dk += dS^T q.
//   2 dq:    per (64-row q tile, head, batch), walking 64-key tiles: S and
//            dP = dO v^T, dS, dq += dS k; dS is also staged in shared memory
//            and reduced per key row / key column into dSr / dSc, which the
//            block adds into dq through the tables at the end and writes out.
//   3 dR:    one block per (table row a, 4 columns): dRh / dRw from dSr / dSc
//            and q, summed in a fixed order (no atomics).
//
// Bound on the H100: operations. Stages 0-2 do about 10 N^2 hd flops per
// head (a vit_b global block, N = 4096, 12 heads: 129 GFLOP, 0.13 ms at
// 989 TFLOP/s) against the bytes of q, k, v, O, dO, dq, dk and dv (44 MB,
// 0.013 ms). Like the forward, bf16 products run on mma.sync with the
// probabilities and dS in registers; f32 is a plain SIMT version of the same
// walks. q, k, v, O, dO and the three gradients are strided (batch, head,
// token) views with a contiguous head dim, so dq / dk / dv land straight in
// the rows of the qkv product's gradient (or of a (B, N, nH, hd) tensor, for
// flash_attention_rel_pos). A first, simple design: scratch (u, lse, D, dSr,
// dSc) goes through device memory.
//
// Built once per head dim: the source is compiled with -DMSAM_HD=<hd> into a
// library of its own for each of 32, 64 (vit_b, vit_l), 80 (vit_h), 96 and
// 128 (ops/_cuda.py), so the five builds run in parallel; the wrapper runs any
// other head dim up to 128 in the next larger one, zero-padded. Every size
// follows from HD: HD / 16 k steps and HD / 8 n8 tiles in bf16, ceil(HD / 32)
// dims a lane in f32. The finished dq (64 x HD f32) is staged for the table
// terms of finish_dq in the k tile(s), free after the walk, at row pitch
// HD + 4. Registers: above 96 the bf16 dk/dv walk reads its k / v A
// fragments from shared memory at each step instead of holding them (64
// registers at 128); the f32 stages' sums over a tile's 64 keys (q rows) are
// unrolled 8 deep, not fully (fully unrolled, ptxas hoists 64 k values a dim
// of the lane and the f32 dq stage spills at 128), and the f32 kernels
// declare a minimum of one block an SM (without it ptxas holds some of them
// to 64-72 registers and spills). At 128 the largest launch, the f32 dk/dv
// stage, takes 203 KB of shared memory at the 64 x 64 global grid (the bf16
// dq stage 184 KB).
#include "relpos_common.cuh"

#ifndef MSAM_HD
#error "build with -DMSAM_HD=<head dim>"
#endif

constexpr int LDSS = KT + 4;  // f32 row pitch of an S / dS tile
constexpr int QB = 32;        // q rows per step of the bf16 dk/dv walk
constexpr int RG = 4;         // table columns per block of the dR stage

// operands: 0 q, 1 k, 2 v, 3 O, 4 dO, 5 dq, 6 dk, 7 dv
struct BwdArgs {
  const void* in[5];
  void* grad[3];
  const void* rh;
  const void* rw;
  float* drh;
  float* drw;
  float* U;    // (B nH, NP, UG): u_h | u_w per row
  float* lse;  // (B nH, NP)
  float* D;    // (B nH, NP)
  float* dsr;  // (B nH, N, H)
  float* dsc;  // (B nH, N, W)
  long long st[8][3];  // element strides (batch, head, token)
  int B, nH, N, H, W, NP, UG, UPB;
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

// stage 0 tail: u rows to scratch, D = rowsum(dO o O)
template <typename T, int HD>
__device__ __forceinline__ void write_u_and_d(const BwdArgs& a, const float* U, int up, int q0,
                                              int b, int h) {
  const int N = a.N, HW = a.H + a.W, bh = b * a.nH + h;
  float* Ug = a.U + ((size_t)bh * a.NP + q0) * a.UG;
  for (int idx = threadIdx.x; idx < QT * HW; idx += blockDim.x) {
    const int r = idx / HW, j = idx % HW;
    if (q0 + r < N) Ug[(size_t)r * a.UG + j] = U[r * up + j];
  }
  const T* ob = in_ptr<T>(a, 3, b, h);
  const T* gb = in_ptr<T>(a, 4, b, h);
  for (int r = threadIdx.x; r < QT; r += blockDim.x) {
    const int qi = q0 + r;
    if (qi < N)
      a.D[(size_t)bh * a.NP + qi] =
          dot_row<T, HD>(ob + (long long)qi * a.st[3][2], gb + (long long)qi * a.st[4][2]);
  }
}

// stage 2: add one key tile's dS row sums (per key row y) and column sums
// (per key column x) into the warp's 16 rows of Acc ([0, H): y, [H, H + W): x).
// Sd holds the warp's 16 rows of dS with pitch LDSS. Each (row, column) is
// summed by one lane, in key order.
__device__ __forceinline__ void accumulate_rel(float* Acc, int up, const float* Sd, int k0,
                                               int N, int H, int W, int lane) {
  const int kend = min(k0 + KT, N);
  const int y_lo = k0 / W, nY = (kend - 1) / W - y_lo + 1;
  for (int idx = lane; idx < 16 * nY; idx += 32) {
    const int r = idx / nY, y = y_lo + idx % nY;
    const int hi = min((y + 1) * W, kend) - k0;
    float s = 0.f;
    for (int c = max(y * W, k0) - k0; c < hi; ++c) s += Sd[r * LDSS + c];
    Acc[r * up + y] += s;
  }
  const int xs = k0 % W;
  for (int idx = lane; idx < 16 * W; idx += 32) {
    const int r = idx / W, x = idx % W;
    float s = 0.f;
    for (int c = (x - xs + W) % W; c < kend - k0; c += W) s += Sd[r * LDSS + c];
    Acc[r * up + H + x] += s;
  }
}

// stage 2 tail: dq = Dq (s dS k, staged f32 at row pitch HD + 4) + the
// tables' terms, and the block's dSr / dSc rows to scratch
template <typename T, int HD>
__device__ void finish_dq(const BwdArgs& a, const float* Dq, const float* Acc, int up, int q0,
                          int b, int h) {
  constexpr int LDQ = HD + 4;
  const int N = a.N, H = a.H, W = a.W, bh = b * a.nH + h;
  const T* rh = reinterpret_cast<const T*>(a.rh);
  const T* rw = reinterpret_cast<const T*>(a.rw);
  T* dqb = grad_ptr<T>(a, 0, b, h);
  for (int idx = threadIdx.x; idx < QT * HD; idx += blockDim.x) {
    const int r = idx / HD, d = idx % HD, qi = q0 + r;
    if (qi >= N) continue;
    const int y = qi / W, x = qi - y * W;
    const float* ar = Acc + r * up;
    float acc = Dq[r * LDQ + d];
    const T* th = rh + (size_t)y * H * HD + d;
    for (int j = 0; j < H; ++j) acc = fmaf(ar[j], to_f32(th[(size_t)j * HD]), acc);
    const T* tw = rw + (size_t)x * W * HD + d;
    for (int j = 0; j < W; ++j) acc = fmaf(ar[H + j], to_f32(tw[(size_t)j * HD]), acc);
    dqb[(long long)qi * a.st[5][2] + d] = from_f32<T>(acc);
  }
  const int HW = H + W;
  for (int idx = threadIdx.x; idx < QT * HW; idx += blockDim.x) {
    const int r = idx / HW, j = idx % HW, qi = q0 + r;
    if (qi >= N) continue;
    if (j < H) a.dsr[((size_t)bh * N + qi) * H + j] = Acc[r * up + j];
    else a.dsc[((size_t)bh * N + qi) * W + (j - H)] = Acc[r * up + j];
  }
}

// ---------------------------------------------------------------------------
// bf16 kernels (mma.sync)
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

template <int HD>
__host__ __device__ constexpr size_t prep_bf16_smem(int H, int W) {
  return align128(sizeof(bf16) * 3 * 64 * (HD + 8)) + sizeof(float) * QT * (H + W + 1);
}

template <int HD>
__global__ void __launch_bounds__(128) prep_bf16_kernel(const BwdArgs a) {
  constexpr int LDT = HD + 8, KS = HD / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Kb = Qs + 64 * LDT;  // two slots
  float* U = reinterpret_cast<float*>(smem + align128(sizeof(bf16) * 3 * 64 * LDT));
  const int N = a.N, H = a.H, W = a.W, UP = H + W + 1;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = in_ptr<bf16>(a, 0, b, h);
  const bf16* kb = in_ptr<bf16>(a, 1, b, h);
  const long long qsn = a.st[0][2], ksn = a.st[1][2];
  const int ntiles = (N + KT - 1) / KT;

  load_tile<bf16, HD>(Qs, qb, qsn, q0, N);
  load_tile<bf16, HD>(Kb, kb, ksn, 0, N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  build_u<bf16, HD>(U, UP, Qs, reinterpret_cast<const bf16*>(a.rh),
                    reinterpret_cast<const bf16*>(a.rw), q0, N, H, W);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint32_t qa[KS][4];
  load_a_frags<HD, LDT>(qa, Qs + warp * 16 * LDT, g, t);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g and g + 8
  const float* U0 = U + (warp * 16 + g) * UP;
  const float* U1 = U0 + 8 * UP;
  __syncthreads();  // U complete
  write_u_and_d<bf16, HD>(a, U, UP, q0, b, h);

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_tile<bf16, HD>(Kb + ((it + 1) & 1) * 64 * LDT, kb, ksn, (it + 1) * KT, N);
      cp_async_commit();
    }
    const bf16* Ks = Kb + (it & 1) * 64 * LDT;
    const int k0 = it * KT;
    float s[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const bf16* kr = Ks + (j * 8 + g) * LDT + kk * 16 + t * 2;
        mma16816(s[j], qa[kk], lds32(kr), lds32(kr + 8));
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + j * 8 + t * 2 + e;
        if (key < N) {
          const int ky = key / W, kx = key - ky * W;
          s[j][e] = s[j][e] * a.scale + U0[ky] + U0[H + kx];
          s[j][2 + e] = s[j][2 + e] * a.scale + U1[ky] + U1[H + kx];
        } else {
          s[j][e] = s[j][2 + e] = -INFINITY;
        }
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      ps0 += expf(s[j][0] - mn0) + expf(s[j][1] - mn0);
      ps1 += expf(s[j][2] - mn1) + expf(s[j][3] - mn1);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, off);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, off);
    }
    l0 = l0 * expf(m0 - mn0) + ps0;
    l1 = l1 * expf(m1 - mn1) + ps1;
    m0 = mn0;
    m1 = mn1;
    if (it + 1 < ntiles) cp_async_wait<0>();
    __syncthreads();
  }
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  float* lse = a.lse + (size_t)(b * a.nH + h) * a.NP;
  if (t == 0) {
    if (r0 < N) lse[r0] = m0 + logf(l0);
    if (r1 < N) lse[r1] = m1 + logf(l1);
  }
}

template <int HD>
__host__ __device__ constexpr size_t dkdv_bf16_smem(int UPB) {
  return align128(sizeof(bf16) * (2 * 64 + 4 * QB) * (HD + 8)) +
         sizeof(float) * (2 * QB * UPB + 4 * QB);
}

// one q step (QB rows) of the dk/dv walk into slot `slot`: q, dO, u rows, lse, D
template <int HD>
__device__ __forceinline__ void load_q_step(const BwdArgs& a, bf16* Qd, bf16* Gd, float* Ud,
                                            float* Ld, float* Dd, const bf16* qb, const bf16* gb,
                                            int q0, int bh) {
  const int N = a.N;
  load_tile<bf16, HD, QB>(Qd, qb, a.st[0][2], q0, N);
  load_tile<bf16, HD, QB>(Gd, gb, a.st[4][2], q0, N);
  const float* Ug = a.U + ((size_t)bh * a.NP + q0) * a.UG;
  const int CH = a.UG / 4;
  for (int c = threadIdx.x; c < QB * CH; c += blockDim.x) {
    const int r = c / CH, part = c % CH;
    const bool ok = q0 + r < N;
    cp_async16(Ud + r * a.UPB + part * 4, ok ? Ug + (size_t)r * a.UG + part * 4 : Ug, ok);
  }
  for (int r = threadIdx.x; r < 2 * QB; r += blockDim.x) {
    const int rr = r % QB;
    const bool ok = q0 + rr < N;
    const float* src = (r < QB ? a.lse : a.D) + (size_t)bh * a.NP + (ok ? q0 + rr : 0);
    cp_async4((r < QB ? Ld : Dd) + rr, src, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(128) dkdv_bf16_kernel(const BwdArgs a) {
  constexpr int LDT = HD + 8, KS = HD / 16, NT = HD / 8;
  constexpr bool kHold = HD <= 96;  // k / v A fragments held in registers across the walk
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + 64 * LDT;
  bf16* Qb = Vs + 64 * LDT;      // two slots of QB rows
  bf16* Gb = Qb + 2 * QB * LDT;  // two slots of QB rows
  float* Ub = reinterpret_cast<float*>(smem + align128(sizeof(bf16) * (2 * 64 + 4 * QB) * LDT));
  float* Lb = Ub + 2 * QB * a.UPB;
  float* Db = Lb + 2 * QB;
  const int N = a.N, H = a.H, W = a.W, UPB = a.UPB;
  const int k0 = blockIdx.x * KT, h = blockIdx.y, b = blockIdx.z, bh = b * a.nH + h;
  const bf16* qb = in_ptr<bf16>(a, 0, b, h);
  const bf16* gb = in_ptr<bf16>(a, 4, b, h);
  const int nsteps = (N + QB - 1) / QB;

  load_tile<bf16, HD>(Ks, in_ptr<bf16>(a, 1, b, h), a.st[1][2], k0, N);
  load_tile<bf16, HD>(Vs, in_ptr<bf16>(a, 2, b, h), a.st[2][2], k0, N);
  load_q_step<HD>(a, Qb, Gb, Ub, Lb, Db, qb, gb, 0, bh);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* Kw = Ks + warp * 16 * LDT;
  const bf16* Vw = Vs + warp * 16 * LDT;
  uint32_t ka[kHold ? KS : 1][4], va[kHold ? KS : 1][4];
  if constexpr (kHold) {
    load_a_frags<HD, LDT>(ka, Kw, g, t);
    load_a_frags<HD, LDT>(va, Vw, g, t);
  }
  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;
  const bool kv0 = kr0 < N, kv1 = kr1 < N;
  const int ky0 = kv0 ? kr0 / W : 0, kx0 = kv0 ? kr0 - ky0 * W : 0;
  const int ky1 = kv1 ? kr1 / W : 0, kx1 = kv1 ? kr1 - ky1 * W : 0;
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int it = 0; it < nsteps; ++it) {
    const int cur = it & 1, q0 = it * QB;
    if (it + 1 < nsteps) {
      const int nx = cur ^ 1;
      load_q_step<HD>(a, Qb + nx * QB * LDT, Gb + nx * QB * LDT, Ub + nx * QB * UPB,
                      Lb + nx * QB, Db + nx * QB, qb, gb, q0 + QB, bh);
      cp_async_commit();
    }
    const bf16* Qs = Qb + cur * QB * LDT;
    const bf16* Gs = Gb + cur * QB * LDT;
    const float* Us = Ub + cur * QB * UPB;
    const float* Ls = Lb + cur * QB;
    const float* Ds = Db + cur * QB;

    // S^T = k q^T and dP^T = v dO^T: n8 tiles over the step's q rows
    float st[QB / 8][4], dp[QB / 8][4];
#pragma unroll
    for (int j = 0; j < QB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kf[4], vf[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kHold) {
          kf[e] = ka[kk][e];
          vf[e] = va[kk][e];
        } else {  // the A fragment layout of load_a_frags, for this k step only
          const int off = ((e & 1) ? 8 : 0) * LDT + kk * 16 + t * 2 + ((e & 2) ? 8 : 0);
          kf[e] = lds32(Kw + g * LDT + off);
          vf[e] = lds32(Vw + g * LDT + off);
        }
      }
#pragma unroll
      for (int j = 0; j < QB / 8; ++j) {
        const bf16* qr = Qs + (j * 8 + g) * LDT + kk * 16 + t * 2;
        const bf16* gr = Gs + (j * 8 + g) * LDT + kk * 16 + t * 2;
        mma16816(st[j], kf, lds32(qr), lds32(qr + 8));
        mma16816(dp[j], vf, lds32(gr), lds32(gr + 8));
      }
    }
    // P^T and dS^T, packed into A fragments (rows: keys; k: q rows)
    uint32_t pa[QB / 16][4], da[QB / 16][4];
#pragma unroll
    for (int j = 0; j < QB / 8; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qr = j * 8 + t * 2 + e;
        const bool qv = q0 + qr < N;
        const float* ur = Us + qr * UPB;
        const float lq = Ls[qr], dq = Ds[qr];
        p[e] = (qv && kv0) ? expf(st[j][e] * a.scale + ur[ky0] + ur[H + kx0] - lq) : 0.f;
        p[2 + e] = (qv && kv1) ? expf(st[j][2 + e] * a.scale + ur[ky1] + ur[H + kx1] - lq) : 0.f;
        ds[e] = (qv && kv0) ? p[e] * (dp[j][e] - dq) : 0.f;
        ds[2 + e] = (qv && kv1) ? p[2 + e] * (dp[j][2 + e] - dq) : 0.f;
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      da[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      da[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dv += P^T dO, dk += dS^T q
#pragma unroll
    for (int kk = 0; kk < QB / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, Gs + (kk * 16 + (lane & 15)) * LDT + n * 8);
        mma16816(dv[n], pa[kk], b0, b1);
        ldsm_x2_trans(b0, b1, Qs + (kk * 16 + (lane & 15)) * LDT + n * 8);
        mma16816(dk[n], da[kk], b0, b1);
      }
    }
    if (it + 1 < nsteps) cp_async_wait<0>();
    __syncthreads();
  }

  bf16* dkb = grad_ptr<bf16>(a, 1, b, h);
  bf16* dvb = grad_ptr<bf16>(a, 2, b, h);
  const long long ksn = a.st[6][2], vsn = a.st[7][2];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = n * 8 + t * 2;
    if (kv0) {
      *reinterpret_cast<uint32_t*>(dkb + (long long)kr0 * ksn + d) =
          pack_bf16(dk[n][0] * a.scale, dk[n][1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvb + (long long)kr0 * vsn + d) = pack_bf16(dv[n][0], dv[n][1]);
    }
    if (kv1) {
      *reinterpret_cast<uint32_t*>(dkb + (long long)kr1 * ksn + d) =
          pack_bf16(dk[n][2] * a.scale, dk[n][3] * a.scale);
      *reinterpret_cast<uint32_t*>(dvb + (long long)kr1 * vsn + d) = pack_bf16(dv[n][2], dv[n][3]);
    }
  }
}

template <int HD>
__host__ __device__ constexpr size_t dq_bf16_smem(int H, int W) {
  return align128(sizeof(bf16) * 6 * 64 * (HD + 8)) +
         sizeof(float) * (2 * QT * (H + W + 1) + QT * LDSS);
}

template <int HD>
__global__ void __launch_bounds__(128) dq_bf16_kernel(const BwdArgs a) {
  constexpr int LDT = HD + 8, KS = HD / 16, NT = HD / 8, LDQ = HD + 4;
  static_assert(QT * LDQ * sizeof(float) <= 2 * 64 * LDT * sizeof(bf16),
                "the finished dq is staged in the k ring");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + 64 * LDT;
  bf16* Kb = Gs + 64 * LDT;      // two slots
  bf16* Vb = Kb + 2 * 64 * LDT;  // two slots
  const int N = a.N, H = a.H, W = a.W, UP = H + W + 1;
  float* U = reinterpret_cast<float*>(smem + align128(sizeof(bf16) * 6 * 64 * LDT));
  float* Acc = U + QT * UP;
  float* Sd = Acc + QT * UP;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z, bh = b * a.nH + h;
  const bf16* kb = in_ptr<bf16>(a, 1, b, h);
  const bf16* vb = in_ptr<bf16>(a, 2, b, h);
  const long long ksn = a.st[1][2], vsn = a.st[2][2];
  const int ntiles = (N + KT - 1) / KT;

  load_tile<bf16, HD>(Qs, in_ptr<bf16>(a, 0, b, h), a.st[0][2], q0, N);
  load_tile<bf16, HD>(Gs, in_ptr<bf16>(a, 4, b, h), a.st[4][2], q0, N);
  load_tile<bf16, HD>(Kb, kb, ksn, 0, N);
  load_tile<bf16, HD>(Vb, vb, vsn, 0, N);
  cp_async_commit();
  const float* Ug = a.U + ((size_t)bh * a.NP + q0) * a.UG;
  for (int idx = threadIdx.x; idx < QT * (H + W); idx += blockDim.x) {
    const int r = idx / (H + W), j = idx % (H + W);
    U[r * UP + j] = q0 + r < N ? Ug[(size_t)r * a.UG + j] : 0.f;
    Acc[r * UP + j] = 0.f;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const bool rv0 = r0 < N, rv1 = r1 < N;
  const float* lse = a.lse + (size_t)bh * a.NP;
  const float* Dg = a.D + (size_t)bh * a.NP;
  const float lse0 = rv0 ? lse[r0] : 0.f, lse1 = rv1 ? lse[r1] : 0.f;
  const float D0 = rv0 ? Dg[r0] : 0.f, D1 = rv1 ? Dg[r1] : 0.f;
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[KS][4], ga[KS][4];
  load_a_frags<HD, LDT>(qa, Qs + warp * 16 * LDT, g, t);
  load_a_frags<HD, LDT>(ga, Gs + warp * 16 * LDT, g, t);
  const float* U0 = U + (warp * 16 + g) * UP;
  const float* U1 = U0 + 8 * UP;
  float* Sw = Sd + warp * 16 * LDSS;
  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      const int nx = (it + 1) & 1;
      load_tile<bf16, HD>(Kb + nx * 64 * LDT, kb, ksn, (it + 1) * KT, N);
      load_tile<bf16, HD>(Vb + nx * 64 * LDT, vb, vsn, (it + 1) * KT, N);
      cp_async_commit();
    }
    const bf16* Ks = Kb + (it & 1) * 64 * LDT;
    const bf16* Vs = Vb + (it & 1) * 64 * LDT;
    const int k0 = it * KT;

    uint32_t da[KT / 16][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const bf16* kr = Ks + (j * 8 + g) * LDT + kk * 16 + t * 2;
        const bf16* vr = Vs + (j * 8 + g) * LDT + kk * 16 + t * 2;
        mma16816(s, qa[kk], lds32(kr), lds32(kr + 8));
        mma16816(dp, ga[kk], lds32(vr), lds32(vr + 8));
      }
      float ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + t * 2 + e, key = k0 + c;
        ds[e] = ds[2 + e] = 0.f;
        if (key < N) {
          const int ky = key / W, kx = key - ky * W;
          if (rv0) ds[e] = expf(s[e] * a.scale + U0[ky] + U0[H + kx] - lse0) * (dp[e] - D0);
          if (rv1)
            ds[2 + e] = expf(s[2 + e] * a.scale + U1[ky] + U1[H + kx] - lse1) * (dp[2 + e] - D1);
        }
        Sw[g * LDSS + c] = ds[e];
        Sw[(g + 8) * LDSS + c] = ds[2 + e];
      }
      da[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      da[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dq += dS k
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, Ks + (kk * 16 + (lane & 15)) * LDT + n * 8);
        mma16816(dq[n], da[kk], b0, b1);
      }
    }
    __syncwarp();
    accumulate_rel(Acc + warp * 16 * UP, UP, Sw, k0, N, H, W, lane);
    __syncwarp();
    if (it + 1 < ntiles) cp_async_wait<0>();
    __syncthreads();
  }
  // the walk is over (its last __syncthreads): the k ring takes the finished dq
  float* Dq = reinterpret_cast<float*>(Kb);
  float* Dw = Dq + warp * 16 * LDQ;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = n * 8 + t * 2;
    Dw[g * LDQ + d] = dq[n][0] * a.scale;
    Dw[g * LDQ + d + 1] = dq[n][1] * a.scale;
    Dw[(g + 8) * LDQ + d] = dq[n][2] * a.scale;
    Dw[(g + 8) * LDQ + d + 1] = dq[n][3] * a.scale;
  }
  __syncthreads();
  finish_dq<bf16, HD>(a, Dq, Acc, UP, q0, b, h);
}

// ---------------------------------------------------------------------------
// f32 kernels: the same walks as plain SIMT loops (a warp owns 16 rows; a
// lane owns keys / q rows (lane, lane + 32) and dims lane + 32 e, e < DE)
// ---------------------------------------------------------------------------

template <int HD>
__host__ __device__ constexpr size_t prep_f32_smem(int H, int W) {
  return align128(sizeof(float) * (2 * 64 * (HD + 8) + QT * LDSS)) +
         sizeof(float) * QT * (H + W + 1);
}

template <int HD>
__global__ void __launch_bounds__(128, 1) prep_f32_kernel(const BwdArgs a) {
  constexpr int LDT = HD + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + 64 * LDT;
  float* Ss = Ks + 64 * LDT;
  float* U = reinterpret_cast<float*>(smem + align128(sizeof(float) * (2 * 64 * LDT + QT * LDSS)));
  const int N = a.N, H = a.H, W = a.W, UP = H + W + 1;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const float* kb = in_ptr<float>(a, 1, b, h);

  load_tile<float, HD>(Qs, in_ptr<float>(a, 0, b, h), a.st[0][2], q0, N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  build_u<float, HD>(U, UP, Qs, reinterpret_cast<const float*>(a.rh),
                     reinterpret_cast<const float*>(a.rw), q0, N, H, W);
  __syncthreads();
  write_u_and_d<float, HD>(a, U, UP, q0, b, h);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Sw = Ss + warp * 16 * LDSS;
  const float* Qw = Qs + warp * 16 * LDT;
  const float* Uw = U + warp * 16 * UP;
  float m[16], l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) { m[r] = -INFINITY; l[r] = 0.f; }
  for (int k0 = 0; k0 < N; k0 += KT) {
    __syncthreads();
    load_tile<float, HD>(Ks, kb, a.st[1][2], k0, N);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int r = 0; r < 16; ++r)
      for (int c = lane; c < KT; c += 32) {
        float acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) acc = fmaf(Qw[r * LDT + d], Ks[c * LDT + d], acc);
        Sw[r * LDSS + c] = acc;
      }
    __syncwarp();
    const int key0 = k0 + lane, key1 = key0 + 32;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float* Ur = Uw + r * UP;
      float s0 = -INFINITY, s1 = -INFINITY;
      if (key0 < N) s0 = Sw[r * LDSS + lane] * a.scale + Ur[key0 / W] + Ur[H + key0 % W];
      if (key1 < N) s1 = Sw[r * LDSS + lane + 32] * a.scale + Ur[key1 / W] + Ur[H + key1 % W];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float ps = expf(s0 - m_new) + expf(s1 - m_new);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[r] = l[r] * expf(m[r] - m_new) + ps;
      m[r] = m_new;
    }
    __syncwarp();
  }
  float* lse = a.lse + (size_t)(b * a.nH + h) * a.NP;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qi = q0 + warp * 16 + r;
    if (lane == 0 && qi < N) lse[qi] = m[r] + logf(l[r]);
  }
}

template <int HD>
__host__ __device__ constexpr size_t dkdv_f32_smem(int H, int W) {
  return align128(sizeof(float) * (4 * 64 * (HD + 8) + 2 * 64 * LDSS)) +
         sizeof(float) * (QT * (H + W + 1) + 2 * QT);
}

template <int HD>
__global__ void __launch_bounds__(128, 1) dkdv_f32_kernel(const BwdArgs a) {
  constexpr int LDT = HD + 8, DE = (HD + 31) / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + 64 * LDT;
  float* Qs = Vs + 64 * LDT;
  float* Gs = Qs + 64 * LDT;
  float* Ps = Gs + 64 * LDT;
  float* DSs = Ps + 64 * LDSS;
  const int N = a.N, H = a.H, W = a.W, UP = H + W + 1;
  float* U = reinterpret_cast<float*>(smem + align128(sizeof(float) * (4 * 64 * LDT + 2 * 64 * LDSS)));
  float* Ls = U + QT * UP;
  float* Ds = Ls + QT;
  const int k0 = blockIdx.x * KT, h = blockIdx.y, b = blockIdx.z, bh = b * a.nH + h;
  const float* qb = in_ptr<float>(a, 0, b, h);
  const float* gb = in_ptr<float>(a, 4, b, h);

  load_tile<float, HD>(Ks, in_ptr<float>(a, 1, b, h), a.st[1][2], k0, N);
  load_tile<float, HD>(Vs, in_ptr<float>(a, 2, b, h), a.st[2][2], k0, N);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* Kw = Ks + warp * 16 * LDT;
  const float* Vw = Vs + warp * 16 * LDT;
  float* Pw = Ps + warp * 16 * LDSS;
  float* Dw = DSs + warp * 16 * LDSS;
  float dk[16][DE], dv[16][DE];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int e = 0; e < DE; ++e) dk[r][e] = dv[r][e] = 0.f;

  for (int q0 = 0; q0 < N; q0 += QT) {
    __syncthreads();  // the previous q tile is consumed
    load_tile<float, HD>(Qs, qb, a.st[0][2], q0, N);
    load_tile<float, HD>(Gs, gb, a.st[4][2], q0, N);
    cp_async_commit();
    const float* Ug = a.U + ((size_t)bh * a.NP + q0) * a.UG;
    for (int idx = threadIdx.x; idx < QT * (H + W); idx += blockDim.x) {
      const int r = idx / (H + W), j = idx % (H + W);
      U[r * UP + j] = q0 + r < N ? Ug[(size_t)r * a.UG + j] : 0.f;
    }
    for (int r = threadIdx.x; r < QT; r += blockDim.x) {
      Ls[r] = q0 + r < N ? a.lse[(size_t)bh * a.NP + q0 + r] : 0.f;
      Ds[r] = q0 + r < N ? a.D[(size_t)bh * a.NP + q0 + r] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int r = 0; r < 16; ++r) {
      const int key = k0 + warp * 16 + r;
      const int ky = key / W, kx = key - ky * W;
      for (int c = lane; c < QT; c += 32) {
        const int qi = q0 + c;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
          s = fmaf(Kw[r * LDT + d], Qs[c * LDT + d], s);
          dp = fmaf(Vw[r * LDT + d], Gs[c * LDT + d], dp);
        }
        float p = 0.f, ds = 0.f;
        if (key < N && qi < N) {
          p = expf(s * a.scale + U[c * UP + ky] + U[c * UP + H + kx] - Ls[c]);
          ds = p * (dp - Ds[c]);
        }
        Pw[r * LDSS + c] = p;
        Dw[r * LDSS + c] = ds;
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
#pragma unroll
      for (int e = 0; e < DE; ++e) {
        const int d = lane + 32 * e;
        if (d >= HD) continue;
        float av = dv[r][e], ak = dk[r][e];
#pragma unroll 8
        for (int c = 0; c < QT; ++c) {
          av = fmaf(Pw[r * LDSS + c], Gs[c * LDT + d], av);
          ak = fmaf(Dw[r * LDSS + c], Qs[c * LDT + d], ak);
        }
        dv[r][e] = av;
        dk[r][e] = ak;
      }
    }
    __syncwarp();
  }
  float* dkb = grad_ptr<float>(a, 1, b, h);
  float* dvb = grad_ptr<float>(a, 2, b, h);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int key = k0 + warp * 16 + r;
    if (key >= N) continue;
#pragma unroll
    for (int e = 0; e < DE; ++e) {
      const int d = lane + 32 * e;
      if (d >= HD) continue;
      dkb[(long long)key * a.st[6][2] + d] = dk[r][e] * a.scale;
      dvb[(long long)key * a.st[7][2] + d] = dv[r][e];
    }
  }
}

template <int HD>
__host__ __device__ constexpr size_t dq_f32_smem(int H, int W) {
  return align128(sizeof(float) * (4 * 64 * (HD + 8) + QT * LDSS)) +
         sizeof(float) * (2 * QT * (H + W + 1) + 2 * QT);
}

template <int HD>
__global__ void __launch_bounds__(128, 1) dq_f32_kernel(const BwdArgs a) {
  constexpr int LDT = HD + 8, DE = (HD + 31) / 32, LDQ = HD + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Gs = Qs + 64 * LDT;
  float* Ks = Gs + 64 * LDT;
  float* Vs = Ks + 64 * LDT;
  float* Sd = Vs + 64 * LDT;
  const int N = a.N, H = a.H, W = a.W, UP = H + W + 1;
  float* U = reinterpret_cast<float*>(smem + align128(sizeof(float) * (4 * 64 * LDT + QT * LDSS)));
  float* Acc = U + QT * UP;
  float* Ls = Acc + QT * UP;
  float* Ds = Ls + QT;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z, bh = b * a.nH + h;
  const float* kb = in_ptr<float>(a, 1, b, h);
  const float* vb = in_ptr<float>(a, 2, b, h);

  load_tile<float, HD>(Qs, in_ptr<float>(a, 0, b, h), a.st[0][2], q0, N);
  load_tile<float, HD>(Gs, in_ptr<float>(a, 4, b, h), a.st[4][2], q0, N);
  cp_async_commit();
  const float* Ug = a.U + ((size_t)bh * a.NP + q0) * a.UG;
  for (int idx = threadIdx.x; idx < QT * (H + W); idx += blockDim.x) {
    const int r = idx / (H + W), j = idx % (H + W);
    U[r * UP + j] = q0 + r < N ? Ug[(size_t)r * a.UG + j] : 0.f;
    Acc[r * UP + j] = 0.f;
  }
  for (int r = threadIdx.x; r < QT; r += blockDim.x) {
    Ls[r] = q0 + r < N ? a.lse[(size_t)bh * a.NP + q0 + r] : 0.f;
    Ds[r] = q0 + r < N ? a.D[(size_t)bh * a.NP + q0 + r] : 0.f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* Qw = Qs + warp * 16 * LDT;
  const float* Gw = Gs + warp * 16 * LDT;
  float* Sw = Sd + warp * 16 * LDSS;
  float dq[16][DE];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int e = 0; e < DE; ++e) dq[r][e] = 0.f;

  for (int k0 = 0; k0 < N; k0 += KT) {
    __syncthreads();  // the previous k/v tile is consumed (and U, Acc are set on entry)
    load_tile<float, HD>(Ks, kb, a.st[1][2], k0, N);
    load_tile<float, HD>(Vs, vb, a.st[2][2], k0, N);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r, qi = q0 + row;
      for (int c = lane; c < KT; c += 32) {
        const int key = k0 + c;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
          s = fmaf(Qw[r * LDT + d], Ks[c * LDT + d], s);
          dp = fmaf(Gw[r * LDT + d], Vs[c * LDT + d], dp);
        }
        float ds = 0.f;
        if (key < N && qi < N) {
          const int ky = key / W, kx = key - ky * W;
          ds = expf(s * a.scale + U[row * UP + ky] + U[row * UP + H + kx] - Ls[row]) *
               (dp - Ds[row]);
        }
        Sw[r * LDSS + c] = ds;
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
#pragma unroll
      for (int e = 0; e < DE; ++e) {
        const int d = lane + 32 * e;
        if (d >= HD) continue;
        float acc = dq[r][e];
#pragma unroll 8
        for (int c = 0; c < KT; ++c) acc = fmaf(Sw[r * LDSS + c], Ks[c * LDT + d], acc);
        dq[r][e] = acc;
      }
    }
    accumulate_rel(Acc + warp * 16 * UP, UP, Sw, k0, N, H, W, lane);
    __syncwarp();
  }
  // every warp is done with the last k tile: it takes the finished dq
  __syncthreads();
  float* Dw = Ks + warp * 16 * LDQ;
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int e = 0; e < DE; ++e) {
      const int d = lane + 32 * e;
      if (d < HD) Dw[r * LDQ + d] = dq[r][e] * a.scale;
    }
  __syncthreads();
  finish_dq<float, HD>(a, Ks, Acc, UP, q0, b, h);
}

// ---------------------------------------------------------------------------
// stage 3: dRh[a, c] = sum_{bh, y(i) = a} dSr[bh, i, c] q_i and dRw likewise,
// one block per (table row a, RG columns); 4 groups of HD threads split the
// (bh, i) terms and are summed in a fixed order
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(4 * HD) relgrad_kernel(const BwdArgs a) {
  __shared__ float red[4][RG][HD];
  const int H = a.H, W = a.W, N = a.N;
  const int nbh = (H + RG - 1) / RG, nbw = (W + RG - 1) / RG;
  int blk = blockIdx.x;
  const bool is_h = blk < H * nbh;
  if (!is_h) blk -= H * nbh;
  const int nb = is_h ? nbh : nbw, L = is_h ? H : W, M = is_h ? W : H;
  const int A = blk / nb, c0 = (blk % nb) * RG;
  const float* src = is_h ? a.dsr : a.dsc;
  const int d = threadIdx.x % HD, sp = threadIdx.x / HD;
  float acc[RG];
#pragma unroll
  for (int e = 0; e < RG; ++e) acc[e] = 0.f;
  const int total = a.B * a.nH * M;
  for (int tt = sp; tt < total; tt += 4) {
    const int bh = tt / M, m = tt % M;
    const int i = is_h ? A * W + m : m * W + A;
    const float qv = to_f32(in_ptr<T>(a, 0, bh / a.nH, bh % a.nH)[(long long)i * a.st[0][2] + d]);
    const float* row = src + ((size_t)bh * N + i) * L + c0;
#pragma unroll
    for (int e = 0; e < RG; ++e)
      if (c0 + e < L) acc[e] = fmaf(row[e], qv, acc[e]);
  }
#pragma unroll
  for (int e = 0; e < RG; ++e) red[sp][e][d] = acc[e];
  __syncthreads();
  if (sp == 0) {
    float* out = is_h ? a.drh : a.drw;
#pragma unroll
    for (int e = 0; e < RG; ++e)
      if (c0 + e < L)
        out[((size_t)A * L + c0 + e) * HD + d] = red[0][e][d] + red[1][e][d] + red[2][e][d] + red[3][e][d];
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <typename Kernel>
static int run(Kernel kern, dim3 grid, int threads, size_t smem, const BwdArgs& a, cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// float count of the scratch buffer: u (UG per row), lse and D (NP rows each)
// per (batch, head), then dSr and dSc
static long long scratch_floats(int B, int nH, int N, int H, int W, int* NP, int* UG) {
  *NP = (N + QT - 1) / QT * QT;
  *UG = (H + W + 3) / 4 * 4;
  const long long bh = (long long)B * nH;
  return bh * (*NP) * (*UG + 2) + bh * N * (H + W);
}

template <typename T, int HD>
static int launch_stage(int stage, BwdArgs& a, cudaStream_t s) {
  const dim3 tiles((a.N + QT - 1) / QT, a.nH, a.B);
  const bool bf = sizeof(T) == 2;
  switch (stage) {
    case 0:
      return bf ? run(prep_bf16_kernel<HD>, tiles, 128, prep_bf16_smem<HD>(a.H, a.W), a, s)
                : run(prep_f32_kernel<HD>, tiles, 128, prep_f32_smem<HD>(a.H, a.W), a, s);
    case 1:
      return bf ? run(dkdv_bf16_kernel<HD>, tiles, 128, dkdv_bf16_smem<HD>(a.UPB), a, s)
                : run(dkdv_f32_kernel<HD>, tiles, 128, dkdv_f32_smem<HD>(a.H, a.W), a, s);
    case 2:
      return bf ? run(dq_bf16_kernel<HD>, tiles, 128, dq_bf16_smem<HD>(a.H, a.W), a, s)
                : run(dq_f32_kernel<HD>, tiles, 128, dq_f32_smem<HD>(a.H, a.W), a, s);
    case 3: {
      const int blocks = a.H * ((a.H + RG - 1) / RG) + a.W * ((a.W + RG - 1) / RG);
      return run(relgrad_kernel<T, HD>, dim3(blocks), 4 * HD, 0, a, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// One stage (0 prep, 1 dk/dv, 2 dq, 3 table gradients) of the backward; run
// the four in order. inputs: q, k, v, O, dO; grads: dq, dk, dv (strided
// (B, nH, N, hd) views); rh (H, H, hd), rw (W, W, hd) contiguous in the
// compute dtype; drh, drw contiguous f32; strides: 24 element strides,
// (batch, head, token) for q, k, v, O, dO, dq, dk, dv in turn; scratch: f32,
// at least scratch_floats() long.
MSAM_EXPORT int msam_relpos_attention_bwd(int stage, const void* q, const void* k,
                                          const void* v, const void* o, const void* dout,
                                          const void* rh, const void* rw, void* dq, void* dk,
                                          void* dv, float* drh, float* drw, float* scratch,
                                          long long scratch_len, int B, int nH, int N, int H,
                                          int W, int hd, const long long* strides, float scale,
                                          int dtype, void* stream) {
  if (N != H * W || B <= 0 || nH <= 0 || B > 65535 || nH > 65535) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.in[0] = q; a.in[1] = k; a.in[2] = v; a.in[3] = o; a.in[4] = dout;
  a.grad[0] = dq; a.grad[1] = dk; a.grad[2] = dv;
  a.rh = rh; a.rw = rw; a.drh = drh; a.drw = drw;
  a.B = B; a.nH = nH; a.N = N; a.H = H; a.W = W; a.scale = scale;
  if (scratch_len < scratch_floats(B, nH, N, H, W, &a.NP, &a.UG)) return (int)cudaErrorInvalidValue;
  a.UPB = a.UG;  // u row pitch of the dk/dv walk: 16-byte rows, 4 rows apart in banks
  while (a.UPB % 16 != 4 && a.UPB % 16 != 12) a.UPB += 4;
  const long long bh = (long long)B * nH;
  a.U = scratch;
  a.lse = a.U + bh * a.NP * a.UG;
  a.D = a.lse + bh * a.NP;
  a.dsr = a.D + bh * a.NP;
  a.dsc = a.dsr + bh * N * H;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  cudaStream_t s = (cudaStream_t)stream;
  if (hd != MSAM_HD) return (int)cudaErrorInvalidValue;  // another head dim's library
  if (dtype == MSAM_BF16) return launch_stage<__nv_bfloat16, MSAM_HD>(stage, a, s);
  if (dtype == MSAM_F32) return launch_stage<float, MSAM_HD>(stage, a, s);
  return (int)cudaErrorInvalidValue;
}

MSAM_ERROR_STRING(msam_relpos_attention_bwd)
