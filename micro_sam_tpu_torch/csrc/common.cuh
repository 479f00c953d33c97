// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel file is compiled on its own into a shared library with a plain
// C interface (nvcc -gencode arch=compute_90a,code=sm_90a -shared) and loaded
// with ctypes by micro_sam_tpu_torch/ops/_cuda.py. Each exported launcher
// returns the cudaError_t of its launch (0 = success); the Python wrapper
// raises on anything else.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with the Python wrappers
#define MSAM_F32 0
#define MSAM_BF16 1

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// round an f32 value to T's precision and back (rounding points of the plain
// PyTorch composition, which stores every intermediate in the working type)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// 16-byte asynchronous global -> shared copy; src-size 0 zero-fills the 16 bytes
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  int sz = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(sz));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

#define MSAM_EXPORT extern "C" __attribute__((visibility("default")))

#define MSAM_ERROR_STRING(prefix)                                          \
  MSAM_EXPORT const char* prefix##_error_string(int code) {                \
    return cudaGetErrorString(static_cast<cudaError_t>(code));             \
  }
