// int8 NHWC convolution with an fp32 per-channel dequant epilogue, for
// sm_90a.
//
// Replaces the Pallas kernel `int8_conv2d_dequant` of
// paddle_tpu/ops/pallas/int8.py (line 166):
//
//   out[n, y, x, o] = act(sum_{i, j, c} xpad[n, y*sh + i, x*sw + j, c]
//                                       * w_q[o, c, i, j] * scale[o]
//                         + bias[o])
//
// with x_q NHWC int8 and the filter int8 (symmetric, zero point 0, so the
// zero padding is the quantized value of a float zero), the sum exact in
// int32, scale and bias fp32 (O,) (bias may be absent), act none, relu,
// relu6, sigmoid or tanh, and the output NHWC fp32 or bf16.  The filter
// arrives as (O, kh, kw, C), K contiguous: the wrapper transposes the OIHW
// weight per call, as the JAX wrapper transposes its own.  The JAX
// wrapper's padded copy of x is not made.
//
// Implicit GEMM over M = n * Ho * Wo output pixels, N = O channels, K = kh
// * kw * C: the pixel addressing and the zero-filled A-tile copies are
// conv_tile.cuh's (shared with conv2d_bn_act.cu), the s8 mma tile and the
// epilogue int8_gemm.cuh's (shared with the int8 matmul).  A K tile is one
// tap and 64 channels; C % 64 == 0 and O % 128 == 0 (the JAX gate asks C,
// O % 128); strides and filter sizes are free (the gate: 1 or 2, up to
// 7 x 7).
//
// What bounds it on the H100: operations.  A 3x3 conv does 18 C int8
// operations per output value against about C + 4 bytes of input and
// output, above the int8 ridge (~590 operations a byte).  mma.sync and
// cp.async, not wgmma and TMA, so it reaches a fraction of the 1979 TOPS
// peak; making it fast is later work.
//
// C interface (bound with ctypes): pointers and the stream are `void*`; the
// entry returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile.cuh"
#include "int8_gemm.cuh"

namespace {

using namespace int8_gemm;
using conv_tile::RowInfo;
using conv_tile::Shape;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ wk,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ out,
                     Shape s, int act) {
  __shared__ __align__(16) int8_t smem[kStages * kStage];
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const RowInfo ri = conv_tile::row_info(s, m0);
  const int taps = s.kh * s.kw;
  const int c_tiles = s.c / kBK;
  const int k_tiles = taps * c_tiles;
  auto load = [&](int8_t* stage, int kt) {
    const int tap = kt / c_tiles;
    const int c0 = (kt - tap * c_tiles) * kBK;
    conv_tile::load_a<int8_t>(stage, kLd, x, s, ri, tap / s.kw,
                              tap - (tap / s.kw) * s.kw, c0);
    load_b(stage + kA, [&](int r) {
      return wk + ((int64_t)(n0 + r) * taps + tap) * s.c + c0;
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
  epilogue<T>(acc, scale, bias, out, s.m, s.o, m0, n0, act);
}

template <typename T>
int launch(const int8_t* x, const int8_t* wk, const float* scale,
           const float* bias, void* out, const Shape& s, int act,
           cudaStream_t stream) {
  dim3 grid((unsigned)((s.m + kBM - 1) / kBM), (unsigned)(s.o / kBN));
  int8_conv_kernel<T><<<grid, kThreads, 0, stream>>>(
      x, wk, scale, bias, static_cast<T*>(out), s, act);
  return (int)cudaGetLastError();
}

}  // namespace

// x_q NHWC int8; wk (o, kh, kw, c) int8; scale (o,) fp32; bias (o,) fp32
// or null; out NHWC fp32 (out_dtype 0) or bf16 (1).
extern "C" int int8_conv2d_dequant(const void* x_q, const void* wk,
                                   const void* scale, const void* bias,
                                   void* out, int n, int h, int w, int c,
                                   int o, int kh, int kw, int sh, int sw,
                                   int ph, int pw, int act, int out_dtype,
                                   void* stream) {
  Shape s;
  if (!conv_tile::make_shape(s, n, h, w, c, o, kh, kw, sh, sw, ph, pw, kBK,
                             kBN) ||
      act < kNone || act > kTanh)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x_q);
  const int8_t* wi = static_cast<const int8_t*>(wk);
  const float* sf = static_cast<const float*>(scale);
  const float* bf = static_cast<const float*>(bias);
  switch (out_dtype) {
    case kF32:
      return launch<float>(xi, wi, sf, bf, out, s, act, st);
    case kBF16:
      return launch<__nv_bfloat16>(xi, wi, sf, bf, out, s, act, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
