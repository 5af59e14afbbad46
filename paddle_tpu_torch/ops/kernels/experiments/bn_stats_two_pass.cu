// An alternative combine for the batch-statistics kernel (row 11), for the
// experiments only: the two-pass design with few partials and a wide
// second pass, in place of the shipped kernel's one-launch cluster
// combine.  Nothing of the port builds or calls it
// (experiments/bn_pool_experiments.py does).
//
// Pass 1: the grid is (C / TC channel tiles) x (B row blocks), B <= 64;
// each CTA sums its block of rows as the shipped kernel does
// (`cta_partial`, included from csrc/bn_act_train.cu) and writes its 2 TC
// sums to `part`, (2, B, C) fp32 scratch the caller allocates each call.
// Pass 2: one thread an output (2 C of them, 128 a CTA) brings in its B
// partials together and adds them in block order.  No atomics: two runs
// agree bit for bit.  What bounds it: bytes, one read of x; the second
// launch and its dependent round trip are what the cluster saves.

#include "bn_act_train.cu"

namespace {

constexpr int kMaxBlocks = 64;
constexpr int kReduceThreads = 128;

template <typename T, int TC>
__global__ void __launch_bounds__(kStatsThreads)
    bn_stats_blocks_kernel(const T* __restrict__ x, float* __restrict__ part,
                           int64_t rows, int c, int64_t rows_per) {
  __shared__ float warp_part[kStatsWarps][2][TC];
  const int b = blockIdx.y, B = gridDim.y;
  const int64_t r0 = (int64_t)b * rows_per;
  const int64_t r1 = r0 + rows_per < rows ? r0 + rows_per : rows;
  const int ch0 = blockIdx.x * TC;
  const float mine = cta_partial<T, TC>(x, r0, r1, c, ch0, warp_part);
  if (threadIdx.x < 2 * TC) {
    const int which = threadIdx.x / TC, j = threadIdx.x % TC;
    part[((int64_t)which * B + b) * c + ch0 + j] = mine;
  }
}

__global__ void __launch_bounds__(kReduceThreads)
    bn_stats_wide_reduce_kernel(const float* __restrict__ part,
                                float* __restrict__ sum,
                                float* __restrict__ sumsq, int blocks,
                                int c) {
  const int o = blockIdx.x * kReduceThreads + threadIdx.x;
  if (o >= 2 * c) return;
  const int which = o / c, j = o % c;
  const float* p = part + (int64_t)which * blocks * c + j;
  float v[kMaxBlocks];
#pragma unroll
  for (int q = 0; q < kMaxBlocks; ++q)
    v[q] = q < blocks ? p[(int64_t)q * c] : 0.f;
  float a = v[0];
#pragma unroll
  for (int q = 1; q < kMaxBlocks; ++q)
    if (q < blocks) a += v[q];
  (which ? sumsq : sum)[j] = a;
}

template <typename T, int TC>
struct TwoPassLaunch {
  static int run(const void* x, float* part, float* sum, float* sumsq,
                 int64_t rows, int c, int blocks, int64_t rows_per,
                 cudaStream_t stream) {
    bn_stats_blocks_kernel<T, TC>
        <<<dim3((unsigned)(c / TC), (unsigned)blocks), kStatsThreads, 0,
           stream>>>(static_cast<const T*>(x), part, rows, c, rows_per);
    int err = (int)cudaGetLastError();
    if (err) return err;
    bn_stats_wide_reduce_kernel<<<(unsigned)((2 * c + kReduceThreads - 1) /
                                             kReduceThreads),
                                  kReduceThreads, 0, stream>>>(
        part, sum, sumsq, blocks, c);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// part: (2, blocks, c) fp32 scratch; sum / sumsq: (c,) fp32.
extern "C" int bn_stats_two_pass(const void* x, void* part, void* sum,
                                 void* sumsq, int64_t rows, int c, int tile_c,
                                 int blocks, int64_t rows_per, int dtype,
                                 void* stream) {
  if (rows <= 0 || c <= 0 || tile_c <= 0 || c % tile_c != 0 ||
      rows_per <= 0 || blocks < 1 || blocks > kMaxBlocks ||
      (int64_t)blocks * rows_per < rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* s = static_cast<float*>(sum);
  float* ss = static_cast<float*>(sumsq);
  switch (dtype) {
    case kF32:
      return by_tile<TwoPassLaunch, float>(tile_c, x, p, s, ss, rows, c,
                                           blocks, rows_per, st);
    case kBF16:
      return by_tile<TwoPassLaunch, __nv_bfloat16>(tile_c, x, p, s, ss, rows,
                                                   c, blocks, rows_per, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
