// Training-mode BatchNorm + activation over a (rows, C) array, for sm_90a:
// two streaming kernels.
//
// Replaces the two Pallas kernels of paddle_tpu/ops/pallas/conv_fused.py
// that `fused_bn_act_train` (line 327) calls:
//
//   `_batch_stats` (line 234): the per-channel fp32 sum and sum of squares
//       of x (fp32 or bf16), sum_r x[r, c] and sum_r x[r, c]^2;
//   `scale_act` (line 251): out[r, c] = act(x[r, c] * a[c] + b[c]) with a,
//       b fp32 (C,), act none or relu, out in x's dtype.
//
// The mean, the variance E[x^2] - mean^2 clamped at 0 and the per-channel
// a = gamma * rsqrt(var + eps), b = beta - mean * a are (C,)-sized and
// computed by the wrapper between the two launches, as the JAX function
// computes them between its two pallas_calls.
//
// What bounds them on the H100: bytes.  Each does ~3 operations per value
// against one read (stats) or one read and one write (scale + act) of the
// array, so the time is those bytes over 3.35 TB/s.  At VGG's shapes the
// arrays are 0.5-17 MB, so a launch's fixed cost and the latency of a
// dependent second pass weigh as much as the bytes.
//
// The statistics are one launch.  The grid is (C / TC channel tiles) x (R
// row blocks), launched as clusters of (1, R, 1): one cluster a channel
// tile, R <= 16 CTAs on neighbouring SMs.  TC (16-128 channels, a row
// segment of 32-512 bytes) and R come from the wrapper's plan
// (`bn_act_train.stats_plan`), which sizes them so that about 128 CTAs
// fill the card.  Each CTA streams its block of rows with kInFlight
// 16-byte loads in flight a thread (a thread holds 16 bytes of one row: 4
// fp32 or 8 bf16 channels; the other threads walk rows), sums in
// registers, then over the row lanes of a warp by shuffles and over the
// warps in shared memory.  Then it stores its partial of each output into
// the shared memory of the output's owner (rank o % R; distributed shared
// memory), and after one cluster barrier each rank adds the R partials of
// its outputs in rank order and writes them.  No partials go to device
// memory and there is no second pass.  Every sum is taken in a fixed
// order with no atomics, so two runs agree bit for bit.
//
// The scale pass lays threads along channels too: a CTA of 256 threads
// covers 128 channels, each thread 16 bytes of one row, the remaining
// thread index walking rows, so a warp reads whole 512- or 256-byte row
// segments; the grid is (C / 128, row blocks), about four CTAs on each of
// the 132 SMs.  It multiplies and adds with __fmul_rn / __fadd_rn (no FMA
// contraction), so it computes the plain version's x * a + b bit for bit.
//
// C interface (bound with ctypes): pointers and the stream are `void*`; each
// entry returns the CUDA error of its launch (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kThreads = 256;
constexpr int kTileC = 128;  // channels a CTA of the scale pass covers

template <typename T>
struct Lanes {
  static constexpr int kVec = 16 / (int)sizeof(T);  // channels a thread
  static constexpr int kTx = kTileC / kVec;         // threads along C
  static constexpr int kTy = kThreads / kTx;        // row lanes
};

// The statistics kernel.
constexpr int kStatsThreads = 256;
constexpr int kStatsWarps = kStatsThreads / 32;
constexpr int kInFlight = 8;     // 16-byte loads a thread keeps in flight
constexpr int kMaxCluster = 16;  // row blocks a cluster (non-portable > 8)
constexpr int kMaxDevices = 64;

template <typename T, int TC>
struct StatLanes {
  static constexpr int kVec = 16 / (int)sizeof(T);   // channels a thread
  static constexpr int kTx = TC / kVec;              // threads along C
  static constexpr int kTy = kStatsThreads / kTx;    // row lanes
  static_assert(kTx >= 1 && kTx <= 32 && 32 % kTx == 0, "lanes of a warp");
  static_assert(2 * TC <= kStatsThreads, "a thread a sum in the combine");
};

// The sums of rows [r0, r1) of the TC channels at ch0 over this CTA, each
// in a fixed order: a thread's rows in order, the row lanes of a warp by a
// butterfly of shuffles, then the warps in order.  Returns output o =
// threadIdx.x of the tile's 2 TC sums to threads o < 2 TC (o < TC: the sum
// of channel ch0 + o, else the sum of squares of channel ch0 + o - TC).
template <typename T, int TC>
__device__ __forceinline__ float cta_partial(
    const T* __restrict__ x, int64_t r0, int64_t r1, int c, int ch0,
    float (&warp_part)[kStatsWarps][2][TC]) {
  using L = StatLanes<T, TC>;
  const int tx = threadIdx.x % L::kTx, ty = threadIdx.x / L::kTx;
  float s[L::kVec], ss[L::kVec];
#pragma unroll
  for (int e = 0; e < L::kVec; ++e) s[e] = ss[e] = 0.0f;
  auto add = [&](const uint4& raw) {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < L::kVec; ++k) {
      const float v = to_float(e[k]);
      s[k] += v;
      ss[k] = fmaf(v, v, ss[k]);
    }
  };
  // Row r0 + ty + u * kTy of round i is the thread's (i * kInFlight + u)-th.
  const int64_t lane_stride = (int64_t)L::kTy * c;
  const T* q = x + (r0 + ty) * c + ch0 + tx * L::kVec;
  int64_t r = r0 + ty;
  // Full rounds: kInFlight rows a thread, all in range, loads first.
  for (; r + (int64_t)(kInFlight - 1) * L::kTy < r1;
       r += (int64_t)L::kTy * kInFlight, q += kInFlight * lane_stride) {
    uint4 raw[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      raw[u] = __ldg(reinterpret_cast<const uint4*>(q + u * lane_stride));
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) add(raw[u]);
  }
  // The last round: the rows left, fewer than kInFlight a thread.
  if (r < r1) {
    uint4 raw[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (r + u * L::kTy < r1)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(q + u * lane_stride));
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (r + u * L::kTy < r1) add(raw[u]);
  }
#pragma unroll
  for (int off = L::kTx; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < L::kVec; ++k) {
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
      ss[k] += __shfl_xor_sync(0xffffffffu, ss[k], off);
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < L::kTx) {
#pragma unroll
    for (int k = 0; k < L::kVec; ++k) {
      warp_part[warp][0][tx * L::kVec + k] = s[k];
      warp_part[warp][1][tx * L::kVec + k] = ss[k];
    }
  }
  __syncthreads();
  float a = 0.0f;
  if (threadIdx.x < 2 * TC) {
    const int which = threadIdx.x / TC, j = threadIdx.x % TC;
    a = warp_part[0][which][j];
#pragma unroll
    for (int w = 1; w < kStatsWarps; ++w) a += warp_part[w][which][j];
  }
  return a;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One launch: a cluster of R CTAs a channel tile, CTA `rank` summing rows
// [rank * rows_per, (rank + 1) * rows_per).  Output o of the tile's 2 TC
// sums belongs to rank o % R: each CTA stores its partial of o into that
// rank's `recv` (row = its own rank, column o / R) in distributed shared
// memory, and after one cluster barrier each rank adds its column of R
// partials in rank order and writes the result.  The barrier arrived at
// on entry and waited for before the stores makes sure every CTA of the
// cluster has started (its shared memory exists) without a second wait.
template <typename T, int TC>
__global__ void __launch_bounds__(kStatsThreads)
    bn_stats_cluster_kernel(const T* __restrict__ x, float* __restrict__ sum,
                            float* __restrict__ sumsq, int64_t rows, int c,
                            int64_t rows_per) {
  __shared__ float warp_part[kStatsWarps][2][TC];
  __shared__ float recv[2 * TC + kMaxCluster];
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int R = (int)cluster.num_blocks();
  const int cols = (2 * TC + R - 1) / R;  // outputs a rank owns, at most
  const int64_t r0 = (int64_t)rank * rows_per;
  const int64_t r1 = r0 + rows_per < rows ? r0 + rows_per : rows;
  const int ch0 = blockIdx.x * TC;
  const float mine = cta_partial<T, TC>(x, r0, r1, c, ch0, warp_part);
  cluster_wait();
  if (threadIdx.x < 2 * TC) {
    const int o = threadIdx.x;
    *cluster.map_shared_rank(&recv[rank * cols + o / R], (unsigned)(o % R)) =
        mine;
  }
  cluster.sync();
  const int o = rank + R * (int)threadIdx.x;
  if (o < 2 * TC) {
    float v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      v[q] = q < R ? recv[q * cols + threadIdx.x] : 0.0f;
    float a = v[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q)
      if (q < R) a += v[q];
    (o < TC ? sum : sumsq)[ch0 + o % TC] = a;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_scale_act_kernel(const T* __restrict__ x, const float* __restrict__ a,
                        const float* __restrict__ b, T* __restrict__ out,
                        int64_t rows, int c, int64_t rows_per, int relu) {
  using L = Lanes<T>;
  const int tx = threadIdx.x % L::kTx, ty = threadIdx.x / L::kTx;
  const int ch = blockIdx.x * kTileC + tx * L::kVec;
  float av[L::kVec], bv[L::kVec];
#pragma unroll
  for (int e = 0; e < L::kVec; ++e) {
    av[e] = a[ch + e];
    bv[e] = b[ch + e];
  }
  const int64_t r0 = (int64_t)blockIdx.y * rows_per;
  const int64_t r1 = r0 + rows_per < rows ? r0 + rows_per : rows;
#pragma unroll 4
  for (int64_t r = r0 + ty; r < r1; r += L::kTy) {
    float v[L::kVec];
    load_vec<T, L::kVec>(x + r * c + ch, v);
#pragma unroll
    for (int e = 0; e < L::kVec; ++e) {
      const float y = __fadd_rn(__fmul_rn(v[e], av[e]), bv[e]);
      v[e] = relu ? fmaxf(y, 0.0f) : y;
    }
    store_vec<T, L::kVec>(out + r * c + ch, v);
  }
}

bool bad_grid(int64_t rows, int c, int64_t rows_per, int parts) {
  return rows <= 0 || c <= 0 || c % kTileC != 0 || rows_per <= 0 ||
         parts <= 0 || parts > 65535 ||
         (int64_t)parts * rows_per < rows ||
         (int64_t)(parts - 1) * rows_per >= rows;
}

bool bad_plan(int64_t rows, int c, int tile_c, int cluster,
              int64_t rows_per) {
  return rows <= 0 || c <= 0 || tile_c <= 0 || c % tile_c != 0 ||
         cluster < 1 || cluster > kMaxCluster || rows_per <= 0 ||
         (int64_t)cluster * rows_per < rows;
}

// A launch of the statistics kernel for (tile_c, cluster), with the
// non-portable cluster sizes allowed once a device (`done`: a static of
// the instantiation, one flag per device, so a CUDA graph can capture
// every later launch there).
template <typename T, int TC>
struct StatsLaunch {
  static int prepare(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                     int c, int cluster, cudaStream_t stream) {
    static bool done[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices || !done[dev]) {
      err = cudaFuncSetAttribute(
          bn_stats_cluster_kernel<T, TC>,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
      if (dev < kMaxDevices) done[dev] = true;
    }
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3((unsigned)(c / TC), (unsigned)cluster, 1);
    cfg->blockDim = dim3(kStatsThreads, 1, 1);
    cfg->dynamicSmemBytes = 0;
    cfg->stream = stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = 1;
    attr->val.clusterDim.y = (unsigned)cluster;
    attr->val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    return 0;
  }

  static int run(const void* x, float* sum, float* sumsq, int64_t rows,
                 int c, int cluster, int64_t rows_per, cudaStream_t stream) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int err = prepare(&cfg, &attr, c, cluster, stream);
    if (err) return err;
    err = (int)cudaLaunchKernelEx(&cfg, bn_stats_cluster_kernel<T, TC>,
                                  static_cast<const T*>(x), sum, sumsq, rows,
                                  c, rows_per);
    return err ? err : (int)cudaGetLastError();
  }

  static int max_clusters(int c, int cluster, int* out) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int err = prepare(&cfg, &attr, c, cluster, nullptr);
    if (err) return err;
    return (int)cudaOccupancyMaxActiveClusters(
        out, bn_stats_cluster_kernel<T, TC>, &cfg);
  }
};

// F<T, TC>::run(args...) for the channel tile.
template <template <typename, int> class F, typename T, typename... A>
int by_tile(int tile_c, A... args) {
  switch (tile_c) {
    case 16: return F<T, 16>::run(args...);
    case 32: return F<T, 32>::run(args...);
    case 64: return F<T, 64>::run(args...);
    case 128: return F<T, 128>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int TC>
struct MaxClusters {
  static int run(int c, int cluster, int* out) {
    return StatsLaunch<T, TC>::max_clusters(c, cluster, out);
  }
};

template <typename T>
int launch_scale(const void* x, const float* a, const float* b, void* out,
                 int64_t rows, int c, int64_t rows_per, int parts, int relu,
                 cudaStream_t stream) {
  dim3 grid((unsigned)(c / kTileC), (unsigned)parts);
  bn_scale_act_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), a, b, static_cast<T*>(out), rows, c,
      rows_per, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// sum / sumsq: (c,) fp32.  The plan: channel tile tile_c (16, 32, 64 or
// 128, dividing c), cluster = row blocks (1-16), rows_per rows a CTA
// (cluster * rows_per >= rows; a block past the last row sums nothing).
extern "C" int bn_batch_stats(const void* x, void* sum, void* sumsq,
                              int64_t rows, int c, int tile_c, int cluster,
                              int64_t rows_per, int dtype, void* stream) {
  if (bad_plan(rows, c, tile_c, cluster, rows_per))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s = static_cast<float*>(sum);
  float* ss = static_cast<float*>(sumsq);
  switch (dtype) {
    case kF32:
      return by_tile<StatsLaunch, float>(tile_c, x, s, ss, rows, c, cluster,
                                         rows_per, st);
    case kBF16:
      return by_tile<StatsLaunch, __nv_bfloat16>(tile_c, x, s, ss, rows, c,
                                                 cluster, rows_per, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// cudaOccupancyMaxActiveClusters of the statistics kernel for a plan's
// (tile_c, cluster) on the current device, into *out.
extern "C" int bn_stats_max_clusters(int c, int tile_c, int cluster,
                                     int dtype, int* out) {
  if (bad_plan(1, c, tile_c, cluster, 1)) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return by_tile<MaxClusters, float>(tile_c, c, cluster, out);
    case kBF16:
      return by_tile<MaxClusters, __nv_bfloat16>(tile_c, c, cluster, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int bn_scale_act(const void* x, const void* a, const void* b,
                            void* out, int64_t rows, int c, int64_t rows_per,
                            int parts, int relu, int dtype, void* stream) {
  if (bad_grid(rows, c, rows_per, parts) || relu < 0 || relu > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  switch (dtype) {
    case kF32:
      return launch_scale<float>(x, af, bf, out, rows, c, rows_per, parts,
                                 relu, st);
    case kBF16:
      return launch_scale<__nv_bfloat16>(x, af, bf, out, rows, c, rows_per,
                                         parts, relu, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
