// An alternative combine for the batch-statistics kernel (row 11), for the
// experiments only: one cooperative launch with a grid barrier in place of
// the shipped kernel's cluster and distributed shared memory.  Nothing of
// the port builds or calls it (experiments/bn_pool_experiments.py does).
//
// The grid is (C / TC channel tiles) x (B row blocks), any B (not bound by
// the 16-CTA cluster), launched cooperatively so that every CTA is
// resident.  Each CTA sums its block of rows as the shipped kernel does
// (`cta_partial`, included from csrc/bn_act_train.cu) and writes its 2 TC
// sums to `part`, (2, B, C) fp32 scratch the caller allocates each call.
// After one grid barrier, CTA (tile, b) adds outputs b, b + B, ... of the
// tile's 2 TC sums over the B blocks in block order.  No atomics: two runs
// agree bit for bit.  What bounds it: bytes, one read of x, as the shipped
// kernel; the barrier and the partials' round trip through L2 are what
// the cluster saves.

#include <cooperative_groups.h>

#include "bn_act_train.cu"

namespace {

constexpr int kMaxBlocks = 64;

template <typename T, int TC>
__global__ void __launch_bounds__(kStatsThreads)
    bn_stats_coop_kernel(const T* __restrict__ x, float* __restrict__ part,
                         float* __restrict__ sum, float* __restrict__ sumsq,
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
  cg::this_grid().sync();
  const int o = b + B * (int)threadIdx.x;
  if (o < 2 * TC) {
    const int which = o / TC, j = o % TC;
    const float* p = part + (int64_t)which * B * c + ch0 + j;
    float v[kMaxBlocks];
#pragma unroll
    for (int q = 0; q < kMaxBlocks; ++q)
      v[q] = q < B ? p[(int64_t)q * c] : 0.f;
    float a = v[0];
#pragma unroll
    for (int q = 1; q < kMaxBlocks; ++q)
      if (q < B) a += v[q];
    (which ? sumsq : sum)[ch0 + j] = a;
  }
}

template <typename T, int TC>
struct CoopLaunch {
  static int run(const void* x, float* part, float* sum, float* sumsq,
                 int64_t rows, int c, int blocks, int64_t rows_per,
                 cudaStream_t stream) {
    const T* xt = static_cast<const T*>(x);
    void* args[] = {(void*)&xt, (void*)&part, (void*)&sum, (void*)&sumsq,
                    (void*)&rows, (void*)&c, (void*)&rows_per};
    cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)bn_stats_coop_kernel<T, TC>,
        dim3((unsigned)(c / TC), (unsigned)blocks), dim3(kStatsThreads),
        args, 0, stream);
    return err ? (int)err : (int)cudaGetLastError();
  }
};

}  // namespace

// part: (2, blocks, c) fp32 scratch; sum / sumsq: (c,) fp32.
extern "C" int bn_stats_coop(const void* x, void* part, void* sum,
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
      return by_tile<CoopLaunch, float>(tile_c, x, p, s, ss, rows, c, blocks,
                                        rows_per, st);
    case kBF16:
      return by_tile<CoopLaunch, __nv_bfloat16>(tile_c, x, p, s, ss, rows, c,
                                                blocks, rows_per, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
