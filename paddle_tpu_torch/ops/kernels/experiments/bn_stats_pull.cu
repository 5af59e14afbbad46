// An alternative combine for the batch-statistics kernel (row 11), for the
// experiments only: the shipped kernel's cluster with the partials pulled
// instead of pushed.  Nothing of the port builds or calls it
// (experiments/bn_pool_experiments.py does).
//
// The grid and the clusters are the shipped kernel's: (C / TC channel
// tiles) x (R row blocks), one cluster of R CTAs a tile.  Each CTA sums
// its block of rows as the shipped kernel does (`cta_partial`, included
// from csrc/bn_act_train.cu) into its own shared memory.  After a cluster
// barrier, the CTA of rank r reads outputs r, r + R, ... of the tile's
// 2 TC sums from all R CTAs' shared memory (distributed shared memory
// loads, all in flight), adds them in rank order and writes them; a
// second barrier keeps every CTA's shared memory alive until all have
// read it.  So it waits at two barriers and one remote round trip where
// the shipped kernel waits at one barrier after fire-and-forget stores.
// No atomics: two runs agree bit for bit.  What bounds it: bytes, one
// read of x.

#include "bn_act_train.cu"

namespace {

template <typename T, int TC>
__global__ void __launch_bounds__(kStatsThreads)
    bn_stats_pull_kernel(const T* __restrict__ x, float* __restrict__ sum,
                         float* __restrict__ sumsq, int64_t rows, int c,
                         int64_t rows_per) {
  __shared__ float warp_part[kStatsWarps][2][TC];
  __shared__ float part[2 * TC];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int R = (int)cluster.num_blocks();
  const int64_t r0 = (int64_t)rank * rows_per;
  const int64_t r1 = r0 + rows_per < rows ? r0 + rows_per : rows;
  const int ch0 = blockIdx.x * TC;
  const float mine = cta_partial<T, TC>(x, r0, r1, c, ch0, warp_part);
  if (threadIdx.x < 2 * TC) part[threadIdx.x] = mine;
  cluster.sync();
  const int o = rank + R * (int)threadIdx.x;
  if (o < 2 * TC) {
    float v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      v[q] = q < R ? *cluster.map_shared_rank(&part[o], (unsigned)q) : 0.0f;
    float a = v[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q)
      if (q < R) a += v[q];
    (o < TC ? sum : sumsq)[ch0 + o % TC] = a;
  }
  cluster.sync();
}

template <typename T, int TC>
struct PullLaunch {
  static int run(const void* x, float* sum, float* sumsq, int64_t rows,
                 int c, int cluster, int64_t rows_per, cudaStream_t stream) {
    static bool done[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices || !done[dev]) {
      err = cudaFuncSetAttribute(
          bn_stats_pull_kernel<T, TC>,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
      if (dev < kMaxDevices) done[dev] = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(c / TC), (unsigned)cluster, 1);
    cfg.blockDim = dim3(kStatsThreads, 1, 1);
    cfg.stream = stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 1;
    attr.val.clusterDim.y = (unsigned)cluster;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, bn_stats_pull_kernel<T, TC>,
                             static_cast<const T*>(x), sum, sumsq, rows, c,
                             rows_per);
    return err ? (int)err : (int)cudaGetLastError();
  }
};

}  // namespace

// The shipped entry's arguments: sum / sumsq (c,) fp32, the plan.
extern "C" int bn_stats_pull(const void* x, void* sum, void* sumsq,
                             int64_t rows, int c, int tile_c, int cluster,
                             int64_t rows_per, int dtype, void* stream) {
  if (bad_plan(rows, c, tile_c, cluster, rows_per))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s = static_cast<float*>(sum);
  float* ss = static_cast<float*>(sumsq);
  switch (dtype) {
    case kF32:
      return by_tile<PullLaunch, float>(tile_c, x, s, ss, rows, c, cluster,
                                        rows_per, st);
    case kBF16:
      return by_tile<PullLaunch, __nv_bfloat16>(tile_c, x, s, ss, rows, c,
                                                cluster, rows_per, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
