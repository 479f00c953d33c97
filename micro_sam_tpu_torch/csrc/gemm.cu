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
// Only warpgroup products (wgmma) reach the tensor cores' full rate, so the
// bf16 path is built around them:
//   - a block of three warpgroups: two consumers holding the accumulators in
//     registers (128 floats a thread), and a producer whose one thread issues
//     TMA loads (`setmaxnreg` hands its registers to the consumers);
//   - X and W are both K-major, wgmma's natural layout: each K step of 64
//     (128 bytes) lands by TMA in the 128-byte swizzled layout that the wgmma
//     matrix descriptors name (8-row groups 1024 bytes apart, a k16 step 32
//     bytes further), one A tile of 128 rows and one B tile of BN rows;
//   - the tiles go round a ring of `stages` slots guarded by a full and an
//     empty mbarrier each: the producer waits for a slot to be empty and arms
//     its full barrier with the bytes to come; a consumer waits for full,
//     issues its m64nBNk16 wgmmas, and frees the slot once the next K step's
//     products are in flight (wgmma.wait_group 1);
//   - the grid is persistent: one block an SM walks the output tiles (row
//     tiles outer, column tiles inner, so the blocks in flight share their
//     X rows and every W tile in L2), and the producer loads the next tile
//     while the consumers run the epilogue;
//   - two schedules: the consumers split each 128 x BN tile, 64 rows each
//     (BN 256 or 128), or take whole 128 x 128 tiles in turns, so that one's
//     epilogue runs beside the other's products (an order barrier pair hands
//     the products over; each schedule has a body of its own; no GELU in
//     turns, whose erf is too long to hide);
//   - the epilogue works on the accumulators in registers: bias, GELU and
//     residual with the roundings above, in passes free of branches so that
//     the chains of many columns interleave; each quad of threads transposes
//     its pairs of columns by shuffles so that every thread stores (and reads
//     the residual as) 8 consecutive columns, one 16-byte access;
//   - TMA zero-fills the rows, columns and K steps past the matrices' edges
//     (ragged M, N and K, even a matrix smaller than one tile); the epilogue
//     masks rows past M and columns past N.
// The plan (BN, stages, grid, schedule) is chosen per shape by
// ops/gemm.py::gemm_plan. Each output's sum runs over K in one order
// whatever the tile or the plan: no split-K. Tensor maps are encoded on the
// host through the driver's cuTensorMapEncodeTiled, reached with
// cudaGetDriverEntryPoint (no -lcuda), and cached on their full key. The f32
// path is a plain SIMT tile kernel (64 x 64 tile, 4 x 4 per thread), kept for
// holding the kernel path against the plain one at a tight tolerance.
#include <mutex>

#include "common.cuh"
#include "tma.cuh"

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
// bf16: warp-specialised wgmma products fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------------
constexpr int BM = 128, BK = 64;   // BK: 64 bf16 = 128 bytes, the swizzle's width
constexpr int kThreads = 384;      // warpgroups 0 and 1 consume, 2 produces
constexpr int kSmemLimit = 232448; // dynamic shared memory a block may use

template <int BN> __host__ __device__ constexpr int stage_bytes() { return (BM + BN) * BK * 2; }
// dynamic shared memory of a plan: the ring, its full and empty barriers, two
// order barriers, 1024 for alignment
template <int BN> __host__ __device__ constexpr int smem_bytes(int stages) {
  return stages * stage_bytes<BN>() + stages * 16 + 16 + 1024;
}

// wgmma matrix descriptor of a K-major tile in the 128-byte swizzle: start
// address >> 4, leading offset 1 (unused by this layout), 8-row groups 1024
// bytes apart (>> 4 = 64), layout 1 (128-byte swizzle) in bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads and writes across the
// asynchronous products' issue and wait
template <int R> __device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WGMMA_D64                                                                    \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, " \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WGMMA_D128                                                                    \
  WGMMA_D64                                                                           \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "   \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "   \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "     \
  "%123, %124, %125, %126, %127"
#define ACC8(i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),      \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC64(i)                                                                   \
  ACC8(i), ACC8(i + 8), ACC8(i + 16), ACC8(i + 24), ACC8(i + 32), ACC8(i + 40),    \
      ACC8(i + 48), ACC8(i + 56)

// D (+)= A B^T for a 64 x BN tile, A and B K-major in shared memory: the
// thread's BN / 2 accumulators, 4 for each 8 columns (rows lane / 4 and + 8
// of its warp's 16, columns 2 (lane % 4) and + 1)
template <int BN> struct Wgmma;
template <> struct Wgmma<256> {
  __device__ __forceinline__ static void mma(float (&d)[128], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WGMMA_D128
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : ACC64(0), ACC64(64)
        : "l"(da), "l"(db), "r"(accumulate));
  }
};
template <> struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WGMMA_D64
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : ACC64(0)
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// The residual epilogues on a pair of values already rounded (v = round(acc
// + b)): round(R + v), then round(gelu(.)) for residual_gelu.
template <int EPI> __device__ __forceinline__ uint32_t residual_pair(uint32_t r, uint32_t v) {
  float lo = round_to<__nv_bfloat16>(bf16_lo(r) + bf16_lo(v));
  float hi = round_to<__nv_bfloat16>(bf16_hi(r) + bf16_hi(v));
  if (EPI == EPI_RESIDUAL_GELU) { lo = gelu_erf(lo); hi = gelu_erf(hi); }
  return pack_bf16(lo, hi);
}

// Thread q of a quad holds x[c] = its two columns of chunk c; afterwards it
// holds chunk q whole: x[p] = thread p's two columns of it. Two butterfly
// stages over the bits of q, one shuffle per pair of slots each.
__device__ __forceinline__ void quad_transpose(uint32_t (&x)[4], int q) {
#pragma unroll
  for (int b = 2; b >= 1; b >>= 1) {
    const bool hi = (q & b) != 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c & b) continue;
      const uint32_t send = hi ? x[c] : x[c | b];
      const uint32_t got = __shfl_xor_sync(0xffffffffu, send, b);
      if (hi) x[c] = got;
      else x[c | b] = got;
    }
  }
}

// The epilogue of one consumer warpgroup's 64 x BN accumulators (rows from
// row0, columns from n0), stored as bf16 into Y. In chunks of 16-column
// groups, three passes each with no branch or store inside, so that the
// compiler interleaves the long chains (bias load, rounding, GELU, shuffles)
// of a chunk's groups: the values packed in pairs, the quad transposes, the
// stores. A chunk is the whole tile, but 4 groups (64 columns) where a GELU
// runs: its erf's registers beside a whole tile's would spill.
template <int BN, int EPI>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2],
                                           const float* __restrict__ bias,
                                           const __nv_bfloat16* __restrict__ R,
                                           __nv_bfloat16* __restrict__ Y, int M, int N, int row0,
                                           int n0, int tid) {
  constexpr int kChunk = EPI == EPI_GELU || EPI == EPI_RESIDUAL_GELU ? 4 : BN / 16;
  const int lane = tid & 31, q = lane & 3;
  const int grow = row0 + (tid >> 5) * 16 + (lane >> 2) + 8 * (q & 1);  // after the transpose
  const bool vec = (N & 7) == 0;  // rows start 16-byte aligned
#pragma unroll
  for (int j0 = 0; j0 < BN / 16; j0 += kChunk) {
    uint32_t c[kChunk][4];  // group jp = j0 + i: chunk 2 h + rr = row + 8 rr, 8 columns 2 jp + h
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * (j0 + i) + h;
        const int col = n0 + 8 * j + 2 * q;
        const float b0 = col < N ? __ldg(bias + col) : 0.f;
        const float b1 = col + 1 < N ? __ldg(bias + col + 1) : 0.f;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float v0 = acc[4 * j + 2 * rr] + b0, v1 = acc[4 * j + 2 * rr + 1] + b1;
          if (EPI == EPI_GELU) {
            v0 = gelu_erf(round_to<__nv_bfloat16>(v0));
            v1 = gelu_erf(round_to<__nv_bfloat16>(v1));
          }
          c[i][2 * h + rr] = pack_bf16(v0, v1);  // the one rounding of each value
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) quad_transpose(c[i], q);
    if (grow >= M) continue;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int gcol = n0 + 16 * (j0 + i) + 8 * (q >> 1);
      if (gcol >= N) break;
      const size_t idx = (size_t)grow * N + gcol;
      if (vec && gcol + 8 <= N) {
        uint4 o = make_uint4(c[i][0], c[i][1], c[i][2], c[i][3]);
        if (EPI == EPI_RESIDUAL || EPI == EPI_RESIDUAL_GELU) {
          const uint4 rv = __ldg(reinterpret_cast<const uint4*>(R + idx));
          o.x = residual_pair<EPI>(rv.x, o.x);
          o.y = residual_pair<EPI>(rv.y, o.y);
          o.z = residual_pair<EPI>(rv.z, o.z);
          o.w = residual_pair<EPI>(rv.w, o.w);
        }
        *reinterpret_cast<uint4*>(Y + idx) = o;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (gcol + e >= N) break;
          float v = (e & 1) ? bf16_hi(c[i][e >> 1]) : bf16_lo(c[i][e >> 1]);
          if (EPI == EPI_RESIDUAL || EPI == EPI_RESIDUAL_GELU) {
            v = round_to<__nv_bfloat16>(__bfloat162float(R[idx + e]) + v);
            if (EPI == EPI_RESIDUAL_GELU) v = gelu_erf(v);
          }
          Y[idx + e] = __float2bfloat16(v);
        }
      }
    }
  }
}

// moves a consumer's place in the ring past n K steps
__device__ __forceinline__ void skip_steps(int& stage, uint32_t& phase, int n, int stages) {
  stage += n;
  phase ^= (uint32_t)(stage / stages) & 1u;
  stage %= stages;
}

// What a consumer warpgroup needs of the block: its shared memory and the
// shape of the walk over the output tiles.
struct Ring {
  uint32_t base, full, empty, order;  // the slots; 8 bytes a barrier
  int stages, tiles, tiles_n, nk;
};

// The products and epilogues of consumer warpgroup `wg`. TURNS false: the two
// warpgroups split every tile of the block, rows 64 wg .. 64 wg + 63 (slice
// 0 of acc). TURNS true (128-wide tiles): they take whole tiles in turns, all
// 128 rows (slices 0 and 1), so that one's epilogue runs beside the other's
// products.
template <int BN, int EPI, bool TURNS>
__device__ __forceinline__ void consume(const Ring& g, int wg, const float* __restrict__ bias,
                                        const __nv_bfloat16* __restrict__ R,
                                        __nv_bfloat16* __restrict__ Y, int M, int N) {
  constexpr int kSlices = TURNS ? 2 : 1;
  constexpr uint32_t kA = BM * BK * 2, kStage = stage_bytes<BN>();
  const int tid = threadIdx.x & 127;
  float acc[kSlices][BN / 2];
#pragma unroll
  for (int s = 0; s < kSlices; ++s)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[s][i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  if (TURNS && wg == 1) skip_steps(stage, phase, g.nk, g.stages);  // the block's first tile
  for (int i = TURNS ? wg : 0, j = 0;; i += TURNS ? 2 : 1, ++j) {
    const int t = blockIdx.x + i * gridDim.x;
    if (t >= g.tiles) break;
    const int m0 = (t / g.tiles_n) * BM, n0 = (t % g.tiles_n) * BN;
    // In turns, a warpgroup starts its products once the other has waited
    // for all of its own tile's slots: that keeps every slot's full barrier
    // at most one phase behind the parity its waiter asks for.
    if (TURNS && (wg == 1 || j > 0)) mbar_wait(g.order + 8 * wg, (wg == 1 ? j : j - 1) & 1);
    int prev = 0;
    for (int kb = 0; kb < g.nk; ++kb) {
      mbar_wait(g.full + 8 * stage, phase);
      const uint32_t a = g.base + stage * kStage;
      const uint64_t db = sw128_desc(a + kA);
#pragma unroll
      for (int s = 0; s < kSlices; ++s) fence_regs(acc[s]);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kSlices; ++s) {
        const uint64_t da = sw128_desc(a + (TURNS ? s : wg) * 64 * BK * 2);
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)  // a k16 step: 32 bytes along the swizzled rows
          Wgmma<BN>::mma(acc[s], da + 2 * k, db + 2 * k, kb > 0 || k > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int s = 0; s < kSlices; ++s) fence_regs(acc[s]);
      wgmma_wait<1>();  // the previous K step's products are done: free its slot
      if (kb > 0 && tid == 0) mbar_arrive(g.empty + 8 * prev);
      prev = stage;
      if (++stage == g.stages) { stage = 0; phase ^= 1; }
    }
    if (TURNS && tid == 0) mbar_arrive(g.order + 8 * (wg ^ 1));  // the other's turn
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < kSlices; ++s) fence_regs(acc[s]);
    if (tid == 0) mbar_arrive(g.empty + 8 * prev);
    if (TURNS) skip_steps(stage, phase, g.nk, g.stages);  // the other warpgroup's tile
#pragma unroll
    for (int s = 0; s < kSlices; ++s)
      store_tile<BN, EPI>(acc[s], bias, R, Y, M, N, m0 + 64 * (TURNS ? s : wg), n0, tid);
  }
}

template <int BN, int EPI>
__global__ void __launch_bounds__(kThreads, 1) gemm_wgmma_kernel(
    __grid_constant__ const CUtensorMap map_x, __grid_constant__ const CUtensorMap map_w,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ R,
    __nv_bfloat16* __restrict__ Y, int M, int N, int K, int stages, int turns) {
  extern __shared__ __align__(1024) unsigned char gemm_smem[];
  constexpr uint32_t kA = BM * BK * 2, kStage = stage_bytes<BN>();
  Ring g;
  // the swizzled tiles want 1024-byte aligned slots
  g.base = ((uint32_t)__cvta_generic_to_shared(gemm_smem) + 1023u) & ~1023u;
  g.full = g.base + stages * kStage;
  g.empty = g.full + 8 * stages;
  g.order = g.empty + 8 * stages;  // two barriers: whose turn at the products
  g.stages = stages;
  g.tiles_n = (N + BN - 1) / BN;
  g.tiles = ((M + BM - 1) / BM) * g.tiles_n;
  g.nk = (K + BK - 1) / BK;
  // turns: only for 128-wide tiles and epilogues without a GELU (whose erf
  // is too long to hide beside the other's products; the plan never asks)
  constexpr bool kTurnsBody = BN == 128 && EPI != EPI_GELU && EPI != EPI_RESIDUAL_GELU;
  const bool in_turns = kTurnsBody && turns;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(g.full + 8 * s, 1);                  // the producer's arrive, plus the TMA bytes
      mbar_init(g.empty + 8 * s, in_turns ? 1 : 2);  // an arrive per warpgroup reading it
    }
    mbar_init(g.order, 1);
    mbar_init(g.order + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        const int m0 = (t / g.tiles_n) * BM, n0 = (t % g.tiles_n) * BN;
        for (int kb = 0; kb < g.nk; ++kb) {
          mbar_wait(g.empty + 8 * stage, phase ^ 1);  // the first round passes at once
          const uint32_t bar = g.full + 8 * stage, dst = g.base + stage * kStage;
          mbar_expect_tx(bar, kStage);  // out-of-bounds parts count, zero-filled
          tma_load(dst, &map_x, bar, kb * BK, m0);
          tma_load(dst + kA, &map_w, bar, kb * BK, n0);
          if (++stage == stages) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {  // consumer warpgroups 0 and 1; a body of its own for each schedule
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x >> 7;
    if constexpr (kTurnsBody) {
      if (in_turns) consume<BN, EPI, true>(g, wg, bias, R, Y, M, N);
      else consume<BN, EPI, false>(g, wg, bias, R, Y, M, N);
    } else {
      consume<BN, EPI, false>(g, wg, bias, R, Y, M, N);
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

// ---------------------------------------------------------------------------
// host: tensor maps and launches
// ---------------------------------------------------------------------------
// a (rows, K) bf16 row-major matrix, read in boxes of BK x box_rows into the
// 128-byte swizzle, zeros past its edges
static bool encode_map(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor maps, cached on their whole key (a map is a pure function of it),
// in one direct-mapped table per operand; a collision re-encodes. A weight
// is held once per dtype for the model's life, so its map is made once; an
// activation buffer comes back at the same address, shape and all, with
// every encode of the same size.
struct CachedMap {
  const void* ptr;
  int rows, K, box;
  CUtensorMap map;
};
constexpr int kMapSlots = 4096;
static std::mutex g_map_mu;
static CachedMap g_maps[2][kMapSlots];  // 0: X, 1: W
static int g_maps_encoded[2] = {0, 0};

static bool cached_map(CUtensorMap* out, int operand, const void* ptr, int rows, int K, int box) {
  std::lock_guard<std::mutex> lock(g_map_mu);
  CachedMap& e = g_maps[operand][(((uintptr_t)ptr >> 8) ^ (uintptr_t)box) % kMapSlots];
  if (e.ptr != ptr || e.rows != rows || e.K != K || e.box != box) {
    e.ptr = nullptr;
    if (!encode_map(&e.map, ptr, rows, K, box)) return false;
    e.ptr = ptr;
    e.rows = rows;
    e.K = K;
    e.box = box;
    ++g_maps_encoded[operand];
  }
  *out = e.map;
  return true;
}

template <int BN, int EPI>
static cudaError_t launch_wgmma(const void* x, const void* w, const void* b, const void* r,
                                void* y, int M, int N, int K, int stages, int grid, int turns,
                                cudaStream_t s) {
  static bool opened[64];  // per device: the shared-memory limit raised once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!opened[dev]) {
    e = cudaFuncSetAttribute(gemm_wgmma_kernel<BN, EPI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return e;
    opened[dev] = true;
  }
  CUtensorMap mx, mw;
  if (!cached_map(&mx, 0, x, M, K, BM) || !cached_map(&mw, 1, w, N, K, BN))
    return cudaErrorInvalidValue;
  gemm_wgmma_kernel<BN, EPI><<<grid, kThreads, smem_bytes<BN>(stages), s>>>(
      mx, mw, (const float*)b, (const __nv_bfloat16*)r, (__nv_bfloat16*)y, M, N, K, stages,
      turns);
  return cudaSuccess;
}

template <int EPI>
static cudaError_t launch(const void* x, const void* w, const void* b, const void* r, void* y,
                          int M, int N, int K, int dtype, int bn, int stages, int grid,
                          int turns, cudaStream_t s) {
  if (dtype == MSAM_BF16) {
    if (bn == 256) return launch_wgmma<256, EPI>(x, w, b, r, y, M, N, K, stages, grid, 0, s);
    return launch_wgmma<128, EPI>(x, w, b, r, y, M, N, K, stages, grid, turns, s);
  }
  dim3 g((N + FT - 1) / FT, (M + FT - 1) / FT);
  gemm_f32_kernel<EPI><<<g, 256, 0, s>>>((const float*)x, (const float*)w, (const float*)b,
                                         (const float*)r, (float*)y, M, N, K);
  return cudaSuccess;
}

// bn, stages, grid, turns: the bf16 plan (ops/gemm.py::gemm_plan); the f32
// path ignores them.
MSAM_EXPORT int msam_gemm(const void* x, const void* w, const void* b, const void* r,
                          void* y, int M, int N, int K, int epi, int dtype, int bn, int stages,
                          int grid, int turns, void* stream) {
  if (dtype != MSAM_BF16 && dtype != MSAM_F32) return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return 0;
  if (dtype == MSAM_BF16) {
    const int smem = bn == 256 ? smem_bytes<256>(stages) : smem_bytes<128>(stages);
    const bool gelu = epi == EPI_GELU || epi == EPI_RESIDUAL_GELU;
    if (K <= 0 || (K % 8) != 0 || (bn != 256 && bn != 128) || stages < 2 ||
        smem > kSmemLimit || grid < 1 || (turns && (bn != 128 || gelu)))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  switch (epi) {
    case EPI_NONE:
      e = launch<EPI_NONE>(x, w, b, r, y, M, N, K, dtype, bn, stages, grid, turns, s);
      break;
    case EPI_GELU:
      e = launch<EPI_GELU>(x, w, b, r, y, M, N, K, dtype, bn, stages, grid, turns, s);
      break;
    case EPI_RESIDUAL:
      e = launch<EPI_RESIDUAL>(x, w, b, r, y, M, N, K, dtype, bn, stages, grid, turns, s);
      break;
    case EPI_RESIDUAL_GELU:
      e = launch<EPI_RESIDUAL_GELU>(x, w, b, r, y, M, N, K, dtype, bn, stages, grid, turns, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the tensor maps encoded so far (cache misses) of X (operand 0) or W (1)
MSAM_EXPORT int msam_gemm_maps_encoded(int operand) {
  return operand == 0 || operand == 1 ? g_maps_encoded[operand] : -1;
}

MSAM_ERROR_STRING(msam_gemm)
