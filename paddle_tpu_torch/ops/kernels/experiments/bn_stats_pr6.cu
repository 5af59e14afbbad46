// Baseline of the batch-statistics kernel (row 11), for the experiments
// only: the design that csrc/bn_act_train.cu's one-launch cluster kernel
// replaced, its kernels unchanged.  Nothing of the port builds or calls it
// (experiments/bn_pool_experiments.py does).
//
// Replaces `_batch_stats` of paddle_tpu/ops/pallas/conv_fused.py (line
// 234): the per-channel fp32 sum and sum of squares of a (rows, C) array
// (fp32 or bf16).  What bounds it on the H100: bytes, one read of x.
//
// Two launches.  bn_stats_partial_kernel: a CTA of 256 threads covers 128
// channels (each thread 16 bytes of one row, the remaining thread index
// walking rows) over a block of rows, sums in registers, then over its
// row lanes in shared memory in a fixed order, and writes one partial per
// channel; the grid is (C / 128, row blocks), about four CTAs on each of
// the 132 SMs.  bn_stats_reduce_kernel sums the partials of each channel
// in a fixed order (8 row-block lanes, then the lanes) on C / 32 CTAs.
// No atomics, so two runs agree bit for bit.
//
// C interface (bound with ctypes): pointers and the stream are `void*`; the
// entry returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec.cuh"

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kThreads = 256;
constexpr int kTileC = 128;  // channels a CTA covers

template <typename T>
struct Lanes {
  static constexpr int kVec = 16 / (int)sizeof(T);  // channels a thread
  static constexpr int kTx = kTileC / kVec;         // threads along C
  static constexpr int kTy = kThreads / kTx;        // row lanes
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_stats_partial_kernel(const T* __restrict__ x,
                            float* __restrict__ part_s,
                            float* __restrict__ part_ss, int64_t rows, int c,
                            int64_t rows_per) {
  using L = Lanes<T>;
  __shared__ float sh_s[L::kTy][kTileC];
  __shared__ float sh_ss[L::kTy][kTileC];
  const int tx = threadIdx.x % L::kTx, ty = threadIdx.x / L::kTx;
  const int ch = blockIdx.x * kTileC + tx * L::kVec;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per;
  const int64_t r1 = r0 + rows_per < rows ? r0 + rows_per : rows;
  float s[L::kVec], ss[L::kVec];
#pragma unroll
  for (int e = 0; e < L::kVec; ++e) s[e] = ss[e] = 0.0f;
#pragma unroll 4
  for (int64_t r = r0 + ty; r < r1; r += L::kTy) {
    float v[L::kVec];
    load_vec<T, L::kVec>(x + r * c + ch, v);
#pragma unroll
    for (int e = 0; e < L::kVec; ++e) {
      s[e] += v[e];
      ss[e] = fmaf(v[e], v[e], ss[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < L::kVec; ++e) {
    sh_s[ty][tx * L::kVec + e] = s[e];
    sh_ss[ty][tx * L::kVec + e] = ss[e];
  }
  __syncthreads();
  if (threadIdx.x < kTileC) {
    float a = 0.0f, b = 0.0f;
#pragma unroll
    for (int y = 0; y < L::kTy; ++y) {
      a += sh_s[y][threadIdx.x];
      b += sh_ss[y][threadIdx.x];
    }
    const int64_t o = (int64_t)blockIdx.y * c + blockIdx.x * kTileC +
                      threadIdx.x;
    part_s[o] = a;
    part_ss[o] = b;
  }
}

// The partials of 32 channels a CTA: thread (tx, ty) sums the row blocks
// ty, ty + 8, ... of channel tx in order (a warp reads 128 contiguous
// bytes), then thread ty == 0 sums the 8 lanes in order.
constexpr int kReduceC = 32;
constexpr int kReduceLanes = kThreads / kReduceC;

__global__ void __launch_bounds__(kThreads)
    bn_stats_reduce_kernel(const float* __restrict__ part_s,
                           const float* __restrict__ part_ss,
                           float* __restrict__ sum, float* __restrict__ sumsq,
                           int parts, int c) {
  __shared__ float sh_s[kReduceLanes][kReduceC];
  __shared__ float sh_ss[kReduceLanes][kReduceC];
  const int tx = threadIdx.x % kReduceC, ty = threadIdx.x / kReduceC;
  const int ch = blockIdx.x * kReduceC + tx;
  float a = 0.0f, b = 0.0f;
#pragma unroll 4
  for (int p = ty; p < parts; p += kReduceLanes) {
    a += part_s[(int64_t)p * c + ch];
    b += part_ss[(int64_t)p * c + ch];
  }
  sh_s[ty][tx] = a;
  sh_ss[ty][tx] = b;
  __syncthreads();
  if (ty == 0) {
#pragma unroll
    for (int y = 1; y < kReduceLanes; ++y) {
      a += sh_s[y][tx];
      b += sh_ss[y][tx];
    }
    sum[ch] = a;
    sumsq[ch] = b;
  }
}

bool bad_grid(int64_t rows, int c, int64_t rows_per, int parts) {
  return rows <= 0 || c <= 0 || c % kTileC != 0 || rows_per <= 0 ||
         parts <= 0 || parts > 65535 ||
         (int64_t)parts * rows_per < rows ||
         (int64_t)(parts - 1) * rows_per >= rows;
}

template <typename T>
int launch_stats(const void* x, float* part_s, float* part_ss, float* sum,
                 float* sumsq, int64_t rows, int c, int64_t rows_per,
                 int parts, cudaStream_t stream) {
  dim3 grid((unsigned)(c / kTileC), (unsigned)parts);
  bn_stats_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), part_s, part_ss, rows, c, rows_per);
  int err = (int)cudaGetLastError();
  if (err) return err;
  bn_stats_reduce_kernel<<<(unsigned)(c / kReduceC), kThreads, 0,
                           stream>>>(part_s, part_ss, sum, sumsq, parts, c);
  return (int)cudaGetLastError();
}

}  // namespace

// part_s / part_ss: (parts, c) fp32 scratch; sum / sumsq: (c,) fp32.
extern "C" int bn_batch_stats(const void* x, void* part_s, void* part_ss,
                              void* sum, void* sumsq, int64_t rows, int c,
                              int64_t rows_per, int parts, int dtype,
                              void* stream) {
  if (bad_grid(rows, c, rows_per, parts)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ps = static_cast<float*>(part_s);
  float* pss = static_cast<float*>(part_ss);
  float* s = static_cast<float*>(sum);
  float* ss = static_cast<float*>(sumsq);
  switch (dtype) {
    case kF32:
      return launch_stats<float>(x, ps, pss, s, ss, rows, c, rows_per, parts,
                                 st);
    case kBF16:
      return launch_stats<__nv_bfloat16>(x, ps, pss, s, ss, rows, c,
                                         rows_per, parts, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
