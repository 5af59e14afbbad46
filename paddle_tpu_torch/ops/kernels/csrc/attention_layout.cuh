// Shared by the attention kernels' forward and backward sources: where they
// find a row of one head, and how they set their shared-memory limit.  The
// element offset of row r of head h of batch b is b * batch + h * head +
// r * row.  The two layouts the kernels serve differ only in these strides:
//   packed (batch, seq, heads * head_dim):  (seq * heads * d, d, heads * d);
//   split  (batch, heads, seq, head_dim):   (heads * seq * d, seq * d, d).
// q, k, v, out (and dO, dq, dk, dv) share one layout; the fp32 bias is
// (batch, seq) and the log-sum-exp (batch, heads, seq) in both.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

struct Layout {
  int64_t batch;
  int64_t head;
  int64_t row;

  __device__ __forceinline__ int64_t base(int b, int h) const {
    return (int64_t)b * batch + (int64_t)h * head;
  }
};

// A kernel's dynamic shared-memory limit is an attribute of each device's
// context.  set_smem_limit sets it on the current device the first time
// that device launches `kernel` (`done` is a static of the caller's
// instantiation, one flag per device), so a CUDA graph can capture every
// later launch there.
constexpr int kMaxDevices = 64;

template <typename Kernel>
inline int set_smem_limit(Kernel kernel, size_t smem,
                          bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && done[dev]) return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices) done[dev] = true;
  return 0;
}
