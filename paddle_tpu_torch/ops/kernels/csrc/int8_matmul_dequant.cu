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
// output fp32 or bf16.  w_q arrives as (N, K), K contiguous: the wrapper
// transposes the (K, N) weight per call, because the s8 mma takes both
// operands K-major and Hopper has no 8-bit ldmatrix .trans.
//
// The tile is int8_gemm.cuh's: a CTA of 4 warps owns 64 rows x 128
// columns, copies 64-byte K tiles of x_q and w_q into shared memory with
// cp.async three stages deep (rows past M zero-filled), multiplies on
// mma.sync m16n8k32 s8 -> s32, and applies the epilogue in registers
// before its one store.  K % 64 == 0 and N % 128 == 0 (the JAX gate asks
// K, N % 128); M has a tail.
//
// What bounds it on the H100: operations for large M, N, K (an ERNIE-base
// FFN at 4096 x 768 x 3072 does 19.3 G int8 operations against 17 MB of
// operands and output); bytes at VGG's fc (128 x 512 x 512).  This first
// kernel uses mma.sync, not wgmma, and no TMA, so it reaches a fraction of
// the 1979 TOPS int8 peak; making it fast is later work.
//
// C interface (bound with ctypes): pointers and the stream are `void*`; the
// entry returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_gemm.cuh"

namespace {

using namespace int8_gemm;

// A tile: rows m0 .. m0 + 63 of x_q, K bytes k0 .. k0 + 63 (zero past M).
__device__ __forceinline__ void load_a_rows(int8_t* As, const int8_t* x,
                                            int64_t m, int k, int64_t m0,
                                            int k0) {
#pragma unroll
  for (int q = 0; q < kBM * kChunks / kThreads; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int r = e / kChunks, ch = e % kChunks;
    const bool ok = m0 + r < m;
    const int8_t* src = ok ? x + (m0 + r) * k + k0 + ch * 16 : x;
    conv_tile::cp_async16(As + r * kLd + ch * 16, src, ok ? 16 : 0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ wt,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ out,
                       int64_t m, int n, int k, int act) {
  __shared__ __align__(16) int8_t smem[kStages * kStage];
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int k_tiles = k / kBK;
  auto load = [&](int8_t* stage, int kt) {
    load_a_rows(stage, x, m, k, m0, kt * kBK);
    load_b(stage + kA, [&](int r) {
      return wt + (int64_t)(n0 + r) * k + kt * kBK;
    });
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < k_tiles) load(smem + st * kStage, st);
    conv_tile::cp_async_commit();
  }
  Acc acc;
  zero(acc);
  for (int kt = 0; kt < k_tiles; ++kt) {
    conv_tile::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < k_tiles) load(smem + (nk % kStages) * kStage, nk);
    conv_tile::cp_async_commit();
    compute_stage(smem + (kt % kStages) * kStage, acc);
  }
  conv_tile::cp_async_wait<0>();
  epilogue<T>(acc, scale, bias, out, m, n, m0, n0, act);
}

template <typename T>
int launch(const int8_t* x, const int8_t* wt, const float* scale,
           const float* bias, void* out, int m, int n, int k, int act,
           cudaStream_t stream) {
  dim3 grid((unsigned)((m + kBM - 1) / kBM), (unsigned)(n / kBN));
  int8_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      x, wt, scale, bias, static_cast<T*>(out), m, n, k, act);
  return (int)cudaGetLastError();
}

}  // namespace

// x_q (m, k) and wt (n, k) int8; scale (n,) fp32; bias (n,) fp32 or null;
// out (m, n) fp32 (out_dtype 0) or bf16 (1).
extern "C" int int8_matmul_dequant(const void* x_q, const void* wt,
                                   const void* scale, const void* bias,
                                   void* out, int m, int n, int k, int act,
                                   int out_dtype, void* stream) {
  if (m <= 0 || n <= 0 || n % kBN != 0 || k <= 0 || k % kBK != 0 ||
      act < kNone || act > kTanh)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x_q);
  const int8_t* wi = static_cast<const int8_t*>(wt);
  const float* sf = static_cast<const float*>(scale);
  const float* bf = static_cast<const float*>(bias);
  switch (out_dtype) {
    case kF32:
      return launch<float>(xi, wi, sf, bf, out, m, n, k, act, st);
    case kBF16:
      return launch<__nv_bfloat16>(xi, wi, sf, bf, out, m, n, k, act, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
