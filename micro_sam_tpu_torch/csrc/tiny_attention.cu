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
// offsets in exactly that order); no N x N bias is read.
//
// Bound on the H100: bytes at these sizes (hd 32 gives 4 N hd flops per head
// and token against 4 hd values moved: 49- or 196-token windows are well
// below the card's 295 flops per byte). One block of 4 warps per (window,
// head) brings q, k and v (N rows each, zero-filled to NP = 64 / 208) into
// shared memory with cp.async; each warp takes 16 q rows at a time and keeps
// the whole row of logits in registers (mma.sync m16n8k16 on bf16, f32
// accumulators), so the softmax is exact (per-row max, f32 sums) without an
// online rescale; the probabilities are rounded to bf16 and repacked in
// registers as the A fragments of the product with v. The f32 kernel is a
// plain SIMT version (one warp per query row, lane = head dim), kept for
// holding the kernel path against the plain one at a tight tolerance.
#include "relpos_common.cuh"

constexpr int TA_HD = 32;

template <int WS>
struct Win {
  static constexpr int N = WS * WS;
  static constexpr int NP = (N + 15) / 16 * 16;  // q rows and keys padded for mma
};

// first row of window `win` (windows numbered b, wy, wx row-major) of the map
__device__ __forceinline__ long long window_row0(long long win, int Hp, int Wp, int WS) {
  const int nWx = Wp / WS, nWy = Hp / WS;
  const int wx = (int)(win % nWx);
  const long long r = win / nWx;
  const int wy = (int)(r % nWy);
  const long long b = r / nWy;
  return (b * Hp + (long long)wy * WS) * Wp + (long long)wx * WS;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync, a whole row of logits in registers
// ---------------------------------------------------------------------------

template <int WS>
__host__ __device__ constexpr size_t bf16_smem() {
  return align128(sizeof(__nv_bfloat16) * 3 * Win<WS>::NP * (TA_HD + 8)) +
         sizeof(float) * Win<WS>::N;
}

template <int WS>
__global__ void __launch_bounds__(128) tiny_attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ table,
    __nv_bfloat16* __restrict__ out, int Hp, int Wp, int nH, float scale) {
  constexpr int N = Win<WS>::N, NP = Win<WS>::NP, HD = TA_HD;
  constexpr int LDT = HD + 8;   // 80-byte smem rows: conflict-free fragment loads
  constexpr int KS = HD / 16;   // k steps of q k^T
  constexpr int NT = HD / 8;    // n8 tiles of the output
  constexpr int JT = NP / 8;    // n8 tiles of keys
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + NP * LDT;
  __nv_bfloat16* Vs = Ks + NP * LDT;
  float* tab = reinterpret_cast<float*>(smem + align128(sizeof(__nv_bfloat16) * 3 * NP * LDT));

  const int h = blockIdx.y;
  const long long row0 = window_row0(blockIdx.x, Hp, Wp, WS);
  const long long ld_in = 3LL * nH * HD, ld_out = (long long)nH * HD;
  const __nv_bfloat16* src = qkv + (long long)h * 3 * HD;

  // q, k, v of every token: 3 x 4 chunks of 16 bytes; rows past N zero-filled
  for (int c = threadIdx.x; c < NP * 12; c += blockDim.x) {
    const int t = c / 12, part = c % 12, which = part >> 2, ch = part & 3;
    __nv_bfloat16* dst = (which == 0 ? Qs : which == 1 ? Ks : Vs) + t * LDT + ch * 8;
    const bool ok = t < N;
    const __nv_bfloat16* g =
        ok ? src + (row0 + (long long)(t / WS) * Wp + t % WS) * ld_in + which * HD + ch * 8 : src;
    cp_async16(dst, g, ok);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < N; i += blockDim.x) tab[i] = table[(long long)h * N + i];
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int rg = warp; rg < NP / 16; rg += 4) {
    uint32_t qa[KS][4];
    load_a_frags<HD, LDT>(qa, Qs + rg * 16 * LDT, g, t);
    float s[JT][4];
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const __nv_bfloat16* kr = Ks + (j * 8 + g) * LDT + kk * 16 + t * 2;
        mma16816(s[j], qa[kk], lds32(kr), lds32(kr + 8));
      }
    }

    // scale, bias and key mask; rows g and g + 8 of the group (a padded row
    // takes the last token's position: its result is never stored)
    const int r0 = min(rg * 16 + g, N - 1), r1 = min(rg * 16 + g + 8, N - 1);
    const int y0 = r0 / WS, x0 = r0 % WS, y1 = r1 / WS, x1 = r1 % WS;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < JT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j * 8 + t * 2 + e;
        if (key < N) {
          const int ky = key / WS, kx = key % WS;
          s[j][e] = s[j][e] * scale + tab[abs(y0 - ky) * WS + abs(x0 - kx)];
          s[j][2 + e] = s[j][2 + e] * scale + tab[abs(y1 - ky) * WS + abs(x1 - kx)];
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

    // p = exp(s - max), rounded to bf16, 16 keys at a time into A fragments
    // of p v; v's B fragments come transposed out of shared memory
    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* sj = s[2 * kk + half];
        const float p0 = round_to<__nv_bfloat16>(expf(sj[0] - mx0));
        const float p1 = round_to<__nv_bfloat16>(expf(sj[1] - mx0));
        const float p2 = round_to<__nv_bfloat16>(expf(sj[2] - mx1));
        const float p3 = round_to<__nv_bfloat16>(expf(sj[3] - mx1));
        l0 += p0 + p1;
        l1 += p2 + p3;
        pa[half * 2] = pack_bf16(p0, p1);
        pa[half * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, Vs + (kk * 16 + (lane & 15)) * LDT + n * 8);
        mma16816(o[n], pa, b0, b1);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }

    const int q0 = rg * 16 + g, q1 = q0 + 8;
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    __nv_bfloat16* dst = out + (long long)h * HD + t * 2;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (q0 < N)
        *reinterpret_cast<uint32_t*>(dst + (row0 + (long long)(q0 / WS) * Wp + q0 % WS) * ld_out +
                                     n * 8) = pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
      if (q1 < N)
        *reinterpret_cast<uint32_t*>(dst + (row0 + (long long)(q1 / WS) * Wp + q1 % WS) * ld_out +
                                     n * 8) = pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: one warp per query row, SIMT
// ---------------------------------------------------------------------------
constexpr int F32_WARPS = 8;

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

template <typename T, typename Kernel>
static int launch(Kernel kern, size_t smem, int threads, const void* qkv, const void* table,
                  void* out, long long windows, int nH, int Hp, int Wp, float scale,
                  cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)windows, nH);
  kern<<<grid, threads, smem, s>>>((const T*)qkv, (const float*)table, (T*)out, Hp, Wp, nH, scale);
  return (int)cudaGetLastError();
}

// qkv (B * Hp * Wp, 3 nH hd) per-head [q | k | v]; table (nH, window^2) f32;
// out (B * Hp * Wp, nH hd)
MSAM_EXPORT int msam_tiny_attention(const void* qkv, const void* table, void* out, int B, int Hp,
                                    int Wp, int nH, int window, int hd, float scale, int dtype,
                                    void* stream) {
  if (hd != TA_HD || B <= 0 || nH <= 0 || nH > 65535 || window <= 0 || Hp % window ||
      Wp % window)
    return (int)cudaErrorInvalidValue;
  const long long windows = (long long)B * (Hp / window) * (Wp / window);
  if (windows == 0) return 0;
  if (windows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
#define MSAM_ARGS qkv, table, out, windows, nH, Hp, Wp, scale, s
  if (dtype == MSAM_BF16) {
    switch (window) {
      case 7: return launch<bf>(tiny_attention_bf16_kernel<7>, bf16_smem<7>(), 128, MSAM_ARGS);
      case 14: return launch<bf>(tiny_attention_bf16_kernel<14>, bf16_smem<14>(), 128, MSAM_ARGS);
    }
  } else if (dtype == MSAM_F32) {
    switch (window) {
      case 7: return launch<float>(tiny_attention_f32_kernel<7>, f32_smem<7>(), F32_WARPS * 32, MSAM_ARGS);
      case 14: return launch<float>(tiny_attention_f32_kernel<14>, f32_smem<14>(), F32_WARPS * 32, MSAM_ARGS);
    }
  }
#undef MSAM_ARGS
  return (int)cudaErrorInvalidValue;
}

MSAM_ERROR_STRING(msam_tiny_attention)
