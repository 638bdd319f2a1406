// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel source exposes a plain C entry point (loaded with ctypes):
// it takes raw device pointers, element strides and a dtype code, launches
// on the caller's stream and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

// dtype codes shared with kernels/build.py
enum DType : int { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

#define NEG_BIG (-1e30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Whether rows of element type T at `p` with the given element strides can
// be read 16 bytes at a time (aligned base, strides and row length).
template <typename T>
inline bool vec16_ok(const void* p, int row_len,
                     std::initializer_list<long long> strides) {
  constexpr int kVec = 16 / sizeof(T);
  if (((uintptr_t)p % 16) != 0 || row_len % kVec != 0) return false;
  for (long long s : strides)
    if (s % kVec != 0) return false;
  return true;
}

// Copy a tile of `rows` rows x `cols` contiguous elements (row r at
// src + r * stride) into shared memory as f32 with row pitch `pitch`; rows
// at or past `valid_rows` are zero-filled.  With `vec` every thread moves
// 16 bytes per load, so a tile takes a few independent loads per thread
// instead of one dependent 2-byte load per element.
template <typename T>
__device__ __forceinline__ void load_tile_f32(float* dst, int pitch,
                                              const T* __restrict__ src,
                                              long long stride, int rows,
                                              int valid_rows, int cols,
                                              bool vec) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    const int nv = cols / kVec;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < rows * nv; idx += blockDim.x) {
      const int r = idx / nv, c = (idx % nv) * kVec;
      float* out = dst + r * pitch + c;
      if (r < valid_rows) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(src + r * stride + c);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < kVec; ++i) out[i] = to_f32(e[i]);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) out[i] = 0.f;
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    const int r = idx / cols, c = idx % cols;
    dst[r * pitch + c] = r < valid_rows ? to_f32(src[r * stride + c]) : 0.f;
  }
}

// Run `body` with T bound to the C++ type of dtype code `code`; an unknown
// code returns cudaErrorInvalidValue from the enclosing entry point.
#define DISPATCH_DTYPE(code, T, ...)          \
  switch (code) {                             \
    case DT_F32: {                            \
      using T = float;                        \
      __VA_ARGS__;                            \
      break;                                  \
    }                                         \
    case DT_BF16: {                           \
      using T = __nv_bfloat16;                \
      __VA_ARGS__;                            \
      break;                                  \
    }                                         \
    case DT_F16: {                            \
      using T = __half;                       \
      __VA_ARGS__;                            \
      break;                                  \
    }                                         \
    default:                                  \
      return (int)cudaErrorInvalidValue;      \
  }
