// int8 matmul with an fp32 per-column dequant epilogue, for sm_90a.
//
// Replaces the Pallas kernel `int8_matmul_dequant` of
// paddle_tpu/ops/pallas/int8.py (line 92):
//
//   out[m, n] = act(sum_k x_q[m, k] * w_q[k, n] * scale[n] + bias[n])
//
// with x_q (M, K) and w_q int8 (symmetric, zero point 0), the sum exact in
// int32, scale (the input step times the weight step) and bias fp32 (N,)
// (bias may be absent), act none, relu, relu6, sigmoid or tanh, and the
// output fp32 or bf16.  w_q arrives as (N, K), K-major: 8-bit wgmma takes
// no transposed operand, so the wrapper lays the (K, N) weight out once
// per weight version (ops/kernels/int8.py `matmul_weight`).
//
// The GEMM is int8_gemm.cuh's persistent wgmma s8 kernel: A = x_q and B =
// the (N, K) weight, each by a 2-d TMA map in 128 x 128 (A) and kBN x 128
// (B) boxes of 128 K values; K past its end and rows past M read as zeros,
// and the output's TMA store clips rows past M.  K % 64 == 0 and N % kBN ==
// 0 (the JAX
// gate asks K, N % 128); M is free.  ops/kernels/int8.py `matmul_plan`
// mirrors the tiling and the K splits.
//
// What bounds it on the H100: bytes at fp32 out for the shapes of the main
// paths (an ERNIE-base FFN at 4096 x 768 x 3072 does 19.3 G int8
// operations, 9.8 us at the 1979 TOPS peak, against 50 MB of fp32 output,
// 15 us at 3.35 TB/s); at VGG's fc (128 x 512 x 512) neither: the launch.
// The persistent grid and the asynchronous TMA stores of the epilogue let
// one tile's stores run under the next tile's loads and products.
//
// C interface (bound with ctypes): pointers and the stream are `void*`; the
// entry returns cudaGetLastError() after its launches.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_gemm.cuh"

namespace {

using namespace int8_gemm;

struct MatmulLoad {
  const CUtensorMap* amap;
  const CUtensorMap* bmap;

  __device__ __forceinline__ void prefetch() const {
    hopper::prefetch_map(amap);
    hopper::prefetch_map(bmap);
  }

  __device__ __forceinline__ void operator()(uint8_t* a, uint8_t* b,
                                             uint64_t* bar, int64_t m0,
                                             int n0, int u) const {
    hopper::tma_load_2d(a, amap, bar, u * kUnitK, (int)m0);
    hopper::tma_load_2d(b, bmap, bar, u * kUnitK, n0);
  }
};

template <typename T, int kAct>
__global__ void __launch_bounds__(kThreads, 1)
    int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                             const __grid_constant__ CUtensorMap bmap,
                             const __grid_constant__ CUtensorMap omap,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias, Geometry g) {
  gemm<T, kAct>(g, scale, bias, &omap, MatmulLoad{&amap, &bmap});
}

template <typename T, int kAct>
__global__ void __launch_bounds__(256)
    int8_matmul_split_sum_kernel(const int32_t* __restrict__ ws,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ bias,
                                 T* __restrict__ out, int64_t rows, int cols,
                                 int splits) {
  split_sum<T, kAct>(ws, scale, bias, out, rows, cols, splits);
}

template <typename T, int kAct>
int launch(const void* x, const void* wt, const float* scale,
           const float* bias, void* out, int32_t* ws, int k,
           const Geometry& g, int ctas, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  int err = set_smem_limit(int8_matmul_wgmma_kernel<T, kAct>, kSmem, done);
  if (err) return err;
  CUtensorMap am, bm, om;
  if ((err = hopper::make_map_2d(&am, x, k, g.rows, k, kBM,
                                 hopper::Elem::kI8)) ||
      (err = hopper::make_map_2d(&bm, wt, k, g.cols, k, kBN,
                                 hopper::Elem::kI8)) ||
      (err = store_map<T>(&om, out, ws, g)))
    return err;
  const int grid = ctas < g.items ? ctas : g.items;
  int8_matmul_wgmma_kernel<T, kAct><<<grid, kThreads, kSmem, stream>>>(
      am, bm, om, scale, bias, g);
  err = (int)cudaGetLastError();
  if (err || g.splits == 1) return err;
  const int64_t items = g.rows * (g.cols / 4);
  int8_matmul_split_sum_kernel<T, kAct>
      <<<(unsigned)((items + 255) / 256), 256, 0, stream>>>(
          ws, scale, bias, static_cast<T*>(out), g.rows, g.cols, g.splits);
  return (int)cudaGetLastError();
}

}  // namespace

// x_q (m, k) and wt (n, k) int8; scale (n,) fp32; bias (n,) fp32 or null;
// out (m, n) fp32 (out_dtype 0) or bf16 (1); ws int32 (splits, m, n),
// unused (may be null) with one split; ctas the persistent grid (at most
// the work items are launched).
extern "C" int int8_matmul_dequant(const void* x_q, const void* wt,
                                   const void* scale, const void* bias,
                                   void* out, void* ws, int m, int n, int k,
                                   int splits, int ctas, int act,
                                   int out_dtype, void* stream) {
  Geometry g;
  if (k <= 0 || k % 64 != 0 ||
      !make_geometry(g, m, n, (k + kUnitK - 1) / kUnitK, splits) ||
      ctas < 1 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(scale);
  const float* bf = static_cast<const float*>(bias);
  int32_t* wsi = static_cast<int32_t*>(ws);
  return dispatch(act, out_dtype, [&](auto tt, auto at) {
    using T = typename decltype(tt)::type;
    return launch<T, decltype(at)::kAct>(x_q, wt, sf, bf, out, wsi, k, g,
                                         ctas, st);
  });
}
