// Pieces shared by the rel-pos attention kernels: the forward
// (relpos_attention.cu) and its backward (relpos_attention_bwd.cu).
#pragma once

#include "common.cuh"

constexpr int QT = 64;  // q rows per block (4 warps x 16)
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

// 4-byte asynchronous global -> shared copy; src-size 0 zero-fills
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  int sz = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(sz));
}

// dot product of two HD-long rows (shared or device memory), 16 bytes at a time
template <typename T, int HD>
__device__ __forceinline__ float dot_row(const T* qrow, const T* tab) {
  constexpr int E = 16 / sizeof(T);
  float acc = 0.f;
#pragma unroll
  for (int d0 = 0; d0 < HD; d0 += E) {
    uint4 a = *reinterpret_cast<const uint4*>(qrow + d0);
    uint4 b = __ldg(reinterpret_cast<const uint4*>(tab + d0));
    const T* av = reinterpret_cast<const T*>(&a);
    const T* bv = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int e = 0; e < E; ++e) acc = fmaf(to_f32(av[e]), to_f32(bv[e]), acc);
  }
  return acc;
}

// U[r * up + j] = q_r . Rh[qy, j] (j < H), q_r . Rw[qx, j - H] (j >= H)
template <typename T, int HD>
__device__ __forceinline__ void build_u(float* U, int up, const T* Qs, const T* rh, const T* rw,
                                        int q0, int N, int H, int W) {
  constexpr int LDT = HD + 8;
  const int HW = H + W;
  for (int idx = threadIdx.x; idx < QT * HW; idx += blockDim.x) {
    int r = idx / HW, j = idx % HW, qi = q0 + r;
    float acc = 0.f;
    if (qi < N) {
      const T* tab = j < H ? rh + ((size_t)(qi / W) * H + j) * HD
                           : rw + ((size_t)(qi % W) * W + (j - H)) * HD;
      acc = dot_row<T, HD>(Qs + r * LDT, tab);
    }
    U[r * up + j] = acc;
  }
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
