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
//
// One block of 4 warps per (q-tile of 64 rows, head, batch), each warp owning
// 16 q rows. The block first builds the per-row u_h / u_w tables
// (64 x (H + W) f32) in shared memory, then walks k/v in tiles of 64 keys with
// an online softmax, so no N x N logits or bias ever reach device memory.
// Every pointer comes with element strides (batch, head, token; the head dim
// is contiguous), so the kernel reads q/k/v straight out of the qkv product's
// token-major (M, 3, nH, hd) rows and writes the (M, nH * hd) rows the proj
// product reads, with no transposes; the same strides serve the
// (B, 3, nH, N, hd) -> (B, nH, N, hd) layout of flash_attention_qkv.
//
// Spatial mode (Geo, relpos_common.cuh; the counterpart of the spatial
// window kernel micro_sam_tpu/ops/fused_window_block.py::_fused_block_kernel
// (spatial=), reached through fused_window_block_spatial): the batch index
// runs over the windows of a padded (img, Hp, Wp) token map and each window's
// tokens are gathered from the map's rows by index arithmetic in the tile
// loads and the output store, so the qkv product's map rows are read and the
// proj product's map rows written with no partition or unpartition copy.
// Only the addresses change: the arithmetic is that of the plain mode. The
// mode is a template parameter (SP), so the plain instantiations, which the
// default route runs, compile to the plain addressing alone.
//
// Bound on the H100: operations. A vit_b global block (N = 4096, 12 heads,
// hd 64) is 4 N^2 hd nH = 52 GFLOP (53 us at 989 TFLOP/s) against 25 MB of
// q/k/v/out traffic (7 us); the windowed blocks (N = 196) move 30 MB per image
// for 3 GFLOP, so they are bound by bytes. The bf16 kernel keeps everything of
// the inner loop in registers: q as mma.sync m16n8k16 A fragments, the
// logits and the output as f32 accumulators, and the probabilities, whose
// accumulator layout is the A layout of the next product, repacked to bf16
// without leaving the thread. k/v tiles arrive through a two-slot cp.async
// ring, the next tile in flight while the current one is multiplied. The f32
// kernel is a plain SIMT version of the same loop, kept for holding the kernel
// path against the plain one at a tight tolerance.
//
// Both are instantiated for head dims 32 (TinyViT-sized), 64 (vit_b, vit_l),
// 80 (vit_h), 96 and 128; the wrapper runs any other head dim up to 128 in
// the next larger one, zero-padded. Every size follows from HD (HD / 16 k
// steps of q k^T, HD / 8 output n8 tiles, a padded row of HD + 8,
// HD * sizeof(T) / 16 cp.async chunks a row); at 80 the bf16 kernel holds 40
// output, 32 logit and 20 q-fragment registers and takes 89 KB of shared
// memory at the global grid, two blocks an SM as at 64. The largest, f32 at
// 128, takes 206 KB at the 64 x 64 global grid.
#include "relpos_common.cuh"

// ---------------------------------------------------------------------------
// bf16: mma.sync, everything of the inner loop in registers
// ---------------------------------------------------------------------------

template <int HD>
__host__ __device__ constexpr size_t bf16_smem(int H, int W) {
  return align128(sizeof(__nv_bfloat16) * 5 * 64 * (HD + 8)) + sizeof(float) * QT * (H + W + 1);
}

template <int HD, bool SP>
__global__ void __launch_bounds__(128) relpos_attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ rh,
    const __nv_bfloat16* __restrict__ rw, __nv_bfloat16* __restrict__ out, int N, int H, int W,
    long long qsb, long long qsh, long long qsn, long long ksb, long long ksh, long long ksn,
    long long vsb, long long vsh, long long vsn, long long osb, long long osh, long long osn,
    float scale, Geo geo) {
  constexpr int LDT = HD + 8;  // padded smem row: conflict-free fragment loads
  constexpr int KS = HD / 16;  // k steps of q k^T
  constexpr int NT = HD / 8;   // n8 tiles of the output
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Kb = Qs + 64 * LDT;      // two slots
  __nv_bfloat16* Vb = Kb + 2 * 64 * LDT;  // two slots
  float* U = reinterpret_cast<float*>(smem + align128(sizeof(__nv_bfloat16) * 5 * 64 * LDT));
  const int UP = H + W + 1;  // odd row stride: the 8 rows of a fragment hit 8 banks

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qb = q + batch_off<SP>(geo, b, qsb, qsn) + h * qsh;
  const __nv_bfloat16* kb = k + batch_off<SP>(geo, b, ksb, ksn) + h * ksh;
  const __nv_bfloat16* vb = v + batch_off<SP>(geo, b, vsb, vsn) + h * vsh;
  __nv_bfloat16* ob = out + batch_off<SP>(geo, b, osb, osn) + h * osh;
  const int ntiles = (N + KT - 1) / KT;

  load_tile<__nv_bfloat16, HD, 64, SP>(Qs, qb, qsn, q0, N, geo);
  load_tile<__nv_bfloat16, HD, 64, SP>(Kb, kb, ksn, 0, N, geo);
  load_tile<__nv_bfloat16, HD, 64, SP>(Vb, vb, vsn, 0, N, geo);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  build_u<__nv_bfloat16, HD>(U, UP, Qs, rh, rw, q0, N, H, W);

  // fragment coordinates (PTX m16n8k16): g = row within 8, t = column pair
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* Qw = Qs + warp * 16 * LDT;
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    qa[kk][0] = lds32(Qw + g * LDT + kk * 16 + t * 2);
    qa[kk][1] = lds32(Qw + (g + 8) * LDT + kk * 16 + t * 2);
    qa[kk][2] = lds32(Qw + g * LDT + kk * 16 + t * 2 + 8);
    qa[kk][3] = lds32(Qw + (g + 8) * LDT + kk * 16 + t * 2 + 8);
  }
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g and g + 8
  const float* U0 = U + (warp * 16 + g) * UP;
  const float* U1 = U0 + 8 * UP;
  __syncthreads();  // U complete

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {  // the next tile flies while this one is multiplied
      const int nxt = (it + 1) & 1;
      load_tile<__nv_bfloat16, HD, 64, SP>(Kb + nxt * 64 * LDT, kb, ksn, (it + 1) * KT, N, geo);
      load_tile<__nv_bfloat16, HD, 64, SP>(Vb + nxt * 64 * LDT, vb, vsn, (it + 1) * KT, N, geo);
      cp_async_commit();
    }
    const __nv_bfloat16* Ks = Kb + (it & 1) * 64 * LDT;
    const __nv_bfloat16* Vs = Vb + (it & 1) * 64 * LDT;
    const int k0 = it * KT;

    // s = q k^T: 8 n8 tiles of keys
    float s[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const __nv_bfloat16* kr = Ks + (j * 8 + g) * LDT + kk * 16 + t * 2;
        mma16816(s[j], qa[kk], lds32(kr), lds32(kr + 8));
      }
    }

    // scale, bias and mask; row maxima over the 4 lanes sharing a row
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + j * 8 + t * 2 + e;
        if (key < N) {
          const int ky = key / W, kx = key - ky * W;
          s[j][e] = s[j][e] * scale + U0[ky] + U0[H + kx];
          s[j][2 + e] = s[j][2 + e] * scale + U1[ky] + U1[H + kx];
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
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);

    // p = exp(s - m), rounded to bf16 and packed straight into A fragments
    uint32_t pa[KT / 16][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      const float p0 = round_to<__nv_bfloat16>(expf(s[j][0] - mn0));
      const float p1 = round_to<__nv_bfloat16>(expf(s[j][1] - mn0));
      const float p2 = round_to<__nv_bfloat16>(expf(s[j][2] - mn1));
      const float p3 = round_to<__nv_bfloat16>(expf(s[j][3] - mn1));
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, off);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, off);
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
    m0 = mn0;
    m1 = mn1;

    // o = o * alpha + p v; v fragments come transposed out of shared memory
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= a0; o[n][1] *= a0; o[n][2] *= a1; o[n][3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        unsigned addr = (unsigned)__cvta_generic_to_shared(
            Vs + (kk * 16 + (lane & 15)) * LDT + n * 8);
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                     : "=r"(b0), "=r"(b1) : "r"(addr));
        mma16816(o[n], pa[kk], b0, b1);
      }
    }

    if (it + 1 < ntiles) cp_async_wait<0>();
    __syncthreads();  // the next tile is visible, and this slot is free to refill
  }

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = n * 8 + t * 2;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(ob + tok_off<SP>(geo, r0, osn) + d) = pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(ob + tok_off<SP>(geo, r1, osn) + d) = pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// f32: the same loop with SIMT products, logits and output in shared memory
// ---------------------------------------------------------------------------
constexpr int LDSS = KT + 4;

template <int HD>
__host__ __device__ constexpr size_t f32_head(void) {
  return align128(sizeof(float) * (3 * 64 * (HD + 8) + 2 * QT * LDSS + QT * (HD + 4)));
}

template <int HD>
__host__ __device__ constexpr size_t f32_smem(int H, int W) {
  return f32_head<HD>() + sizeof(float) * QT * (H + W + 1);
}

// (128, 1): without the minimum of one block an SM, ptxas holds the kernel
// to 72-80 registers and spills at head dims 96 and 128
template <int HD, bool SP>
__global__ void __launch_bounds__(128, 1) relpos_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ rh, const float* __restrict__ rw, float* __restrict__ out,
    int N, int H, int W, long long qsb, long long qsh, long long qsn, long long ksb,
    long long ksh, long long ksn, long long vsb, long long vsh, long long vsn, long long osb,
    long long osh, long long osn, float scale, Geo geo) {
  constexpr int LDT = HD + 8, LDO = HD + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + 64 * LDT;
  float* Vs = Ks + 64 * LDT;
  float* Ss = Vs + 64 * LDT;
  float* Ps = Ss + QT * LDSS;
  float* Os = Ps + QT * LDSS;
  float* U = reinterpret_cast<float*>(smem + f32_head<HD>());
  const int UP = H + W + 1;

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + batch_off<SP>(geo, b, qsb, qsn) + h * qsh;
  const float* kb = k + batch_off<SP>(geo, b, ksb, ksn) + h * ksh;
  const float* vb = v + batch_off<SP>(geo, b, vsb, vsn) + h * vsh;
  float* ob = out + batch_off<SP>(geo, b, osb, osn) + h * osh;

  load_tile<float, HD, 64, SP>(Qs, qb, qsn, q0, N, geo);
  cp_async_commit();
  for (int i = threadIdx.x; i < QT * LDO; i += blockDim.x) Os[i] = 0.f;
  cp_async_wait<0>();
  __syncthreads();
  build_u<float, HD>(U, UP, Qs, rh, rw, q0, N, H, W);

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

  for (int k0 = 0; k0 < N; k0 += KT) {
    __syncthreads();  // previous tile consumed (and U complete on entry)
    load_tile<float, HD, 64, SP>(Ks, kb, ksn, k0, N, geo);
    load_tile<float, HD, 64, SP>(Vs, vb, vsn, k0, N, geo);
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
      if (key0 < N) s0 = Sw[r * LDSS + lane] * scale + Ur[key0 / W] + Ur[H + key0 % W];
      if (key1 < N) s1 = Sw[r * LDSS + lane + 32] * scale + Ur[key1 / W] + Ur[H + key1 % W];
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
      for (int d = lane; d < HD; d += 32) Ow[r * LDO + d] *= alpha;
    }
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      for (int d = lane; d < HD; d += 32) {
        float acc = Ow[r * LDO + d];
        for (int c = 0; c < KT; ++c) acc = fmaf(Pw[r * LDSS + c], Vs[c * LDT + d], acc);
        Ow[r * LDO + d] = acc;
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qi = q0 + warp * 16 + r;
    if (qi < N) {
      const float inv = 1.f / l[r];
      for (int d = lane; d < HD; d += 32) ob[tok_off<SP>(geo, qi, osn) + d] = Ow[r * LDO + d] * inv;
    }
  }
}

template <typename T, typename Kernel>
static int launch(Kernel kern, size_t smem, const void* q, const void* k, const void* v,
                  const void* rh, const void* rw, void* out, int B, int nH, int N, int H, int W,
                  const long long* st, float scale, Geo geo, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + QT - 1) / QT, nH, B);
  kern<<<grid, 128, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)rh, (const T*)rw, (T*)out, N, H, W,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale,
      geo);
  return (int)cudaGetLastError();
}

// strides: 12 element strides, (batch, head, token) for q, k, v, out in turn
// (the batch strides unused in the spatial mode). win > 0: the spatial mode,
// B windows of win x win tokens (H == W == win) of maps of nwy x nwx windows.
MSAM_EXPORT int msam_relpos_attention(const void* q, const void* k, const void* v,
                                      const void* rh, const void* rw, void* out, int B,
                                      int nH, int N, int H, int W, int hd,
                                      const long long* strides, float scale, int win, int nwy,
                                      int nwx, int dtype, void* stream) {
  if (N != H * W || B <= 0 || nH <= 0 || B > 65535 || nH > 65535) return (int)cudaErrorInvalidValue;
  if (win < 0 || (win > 0 && (H != win || W != win || nwy <= 0 || nwx <= 0 || B % (nwy * nwx))))
    return (int)cudaErrorInvalidValue;
  const Geo geo{win, nwy, nwx};
  cudaStream_t s = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
#define MSAM_ARGS q, k, v, rh, rw, out, B, nH, N, H, W, strides, scale, geo, s
#define MSAM_BF16_CASE(D)                                                                    \
  case D:                                                                                    \
    return launch<bf>(win ? relpos_attention_bf16_kernel<D, true> : relpos_attention_bf16_kernel<D, false>, \
                      bf16_smem<D>(H, W), MSAM_ARGS);
#define MSAM_F32_CASE(D)                                                                     \
  case D:                                                                                    \
    return launch<float>(win ? relpos_attention_f32_kernel<D, true> : relpos_attention_f32_kernel<D, false>, \
                         f32_smem<D>(H, W), MSAM_ARGS);
  if (dtype == MSAM_BF16) {
    switch (hd) {
      MSAM_BF16_CASE(32) MSAM_BF16_CASE(64) MSAM_BF16_CASE(80) MSAM_BF16_CASE(96)
      MSAM_BF16_CASE(128)
    }
  } else if (dtype == MSAM_F32) {
    switch (hd) {
      MSAM_F32_CASE(32) MSAM_F32_CASE(64) MSAM_F32_CASE(80) MSAM_F32_CASE(96)
      MSAM_F32_CASE(128)
    }
  }
#undef MSAM_F32_CASE
#undef MSAM_BF16_CASE
#undef MSAM_ARGS
  return (int)cudaErrorInvalidValue;
}

MSAM_ERROR_STRING(msam_relpos_attention)
