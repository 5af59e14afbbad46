// Element conversions, 16-byte vector loads and stores, and the warp sum,
// shared by the LayerNorm and attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Load N consecutive values of T at p (N * sizeof(T) a multiple of 16
// bytes, p 16-byte aligned) into f as fp32.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  constexpr int kPer = 16 / (int)sizeof(T);
  static_assert(N % kPer == 0, "whole 16-byte loads");
#pragma unroll
  for (int j = 0; j < N / kPer; ++j) {
    uint4 raw = reinterpret_cast<const uint4*>(p)[j];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) f[j * kPer + i] = to_float(e[i]);
  }
}

// Store N fp32 values as T at p, in 16-byte stores.
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  static_assert((N * sizeof(T)) % 16 == 0, "whole 16-byte stores");
  T tmp[N];
#pragma unroll
  for (int i = 0; i < N; ++i) tmp[i] = from_float<T>(f[i]);
#pragma unroll
  for (int j = 0; j < (int)(N * sizeof(T)) / 16; ++j)
    reinterpret_cast<uint4*>(p)[j] = reinterpret_cast<const uint4*>(tmp)[j];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
