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
// arrives as (O, kh, kw, C), K-major: the wrapper lays the OIHW weight out
// once per weight version (ops/kernels/int8.py `conv_weight`).  The JAX
// wrapper's padded copy of x is not made.
//
// Implicit GEMM over M = n * Ho * Wo output pixels, N = O channels, K = kh
// * kw * C, on int8_gemm.cuh's persistent wgmma s8 GEMM.  A K unit is one
// filter tap x 128 channels:
//   * A (the input windows) by TMA in im2col mode, as the bf16 fused conv
//     (conv2d_bn_act.cu): one 4-d map (C, W, H, N) whose bounding box is
//     the positions of the filter's first tap, walked at the conv's
//     strides, so one load gives 128 output pixels in (n, y, x) order at
//     the tap's offset; pixels in the padding or past the last image, and
//     channels past C, read as zeros.
//   * B (the filter) by a 2-d map over (kh * kw * C, O), 128 x kBN boxes.
// With C % 128 == 64 the last unit of a tap reads 64 channels of the next
// tap (or zeros past the last) into B against A's zero-filled channels, so
// the sum is unchanged: C % 64 == 0 and O % kBN == 0; strides and filter
// sizes are free (the JAX gate: C, O % 128, strides 1 or 2, up to 7 x 7).
// ops/kernels/int8.py `conv_plan` mirrors the tiling and the K splits.
//
// What bounds it on the H100: at VGG's layers, bytes (the fp32 output is
// 4 bytes a value against 18 C int8 operations, below the int8 ridge of
// ~590 operations a byte for C <= 128); operations for wide C.  The design
// keeps the tensor cores fed from TMA (no thread spends instructions on a
// copy), lets one tile's stores (asynchronous TMA stores) run under the
// next tile's loads and products (persistent CTAs), and splits K where the
// tiles alone do not fill the card.
//
// C interface (bound with ctypes): pointers and the stream are `void*`; the
// entry returns cudaGetLastError() after its launches.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile.cuh"
#include "int8_gemm.cuh"

namespace {

using namespace int8_gemm;
using conv_tile::Shape;

struct ConvLoad {
  const CUtensorMap* amap;
  const CUtensorMap* bmap;
  Shape s;
  int c_units;  // K units a tap: ceil(C / 128)

  __device__ __forceinline__ void prefetch() const {
    hopper::prefetch_map(amap);
    hopper::prefetch_map(bmap);
  }

  __device__ __forceinline__ void operator()(uint8_t* a, uint8_t* b,
                                             uint64_t* bar, int64_t m0,
                                             int n0, int u) const {
    // the tile's first output pixel, as the first tap's input position
    const int64_t hw = (int64_t)s.ho * s.wo;
    const int img = (int)(m0 / hw);
    const int rem = (int)(m0 - (int64_t)img * hw);
    const int oy = rem / s.wo, ox = rem - (rem / s.wo) * s.wo;
    const int tap = u / c_units;
    const int c0 = (u - tap * c_units) * kUnitK;
    const int i = tap / s.kw, j = tap - i * s.kw;
    hopper::tma_load_im2col_4d(a, amap, bar, c0, ox * s.sw - s.pw,
                               oy * s.sh - s.ph, img, (uint16_t)j,
                               (uint16_t)i);
    hopper::tma_load_2d(b, bmap, bar, tap * s.c + c0, n0);
  }
};

template <typename T, int kAct>
__global__ void __launch_bounds__(kThreads, 1)
    int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                           const __grid_constant__ CUtensorMap bmap,
                           const __grid_constant__ CUtensorMap omap,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias, Shape s,
                           Geometry g) {
  gemm<T, kAct>(g, scale, bias, &omap,
                ConvLoad{&amap, &bmap, s, (s.c + kUnitK - 1) / kUnitK});
}

template <typename T, int kAct>
__global__ void __launch_bounds__(256)
    int8_conv_split_sum_kernel(const int32_t* __restrict__ ws,
                               const float* __restrict__ scale,
                               const float* __restrict__ bias,
                               T* __restrict__ out, int64_t rows, int cols,
                               int splits) {
  split_sum<T, kAct>(ws, scale, bias, out, rows, cols, splits);
}

template <typename T, int kAct>
int launch(const void* x, const void* wk, const float* scale,
           const float* bias, void* out, int32_t* ws, const Shape& s,
           const Geometry& g, int ctas, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  int err = set_smem_limit(int8_conv_wgmma_kernel<T, kAct>, kSmem, done);
  if (err) return err;
  CUtensorMap am, bm, om;
  if ((err = hopper::make_im2col_map(&am, x, s.n, s.h, s.w, s.c, s.kh, s.kw,
                                     s.sh, s.sw, s.ph, s.pw, kBM,
                                     hopper::Elem::kI8)) ||
      (err = hopper::make_map_2d(&bm, wk, (int64_t)s.kh * s.kw * s.c, s.o,
                                 (int64_t)s.kh * s.kw * s.c, kBN,
                                 hopper::Elem::kI8)) ||
      (err = store_map<T>(&om, out, ws, g)))
    return err;
  const int grid = ctas < g.items ? ctas : g.items;
  int8_conv_wgmma_kernel<T, kAct><<<grid, kThreads, kSmem, stream>>>(
      am, bm, om, scale, bias, s, g);
  err = (int)cudaGetLastError();
  if (err || g.splits == 1) return err;
  const int64_t items = g.rows * (g.cols / 4);
  int8_conv_split_sum_kernel<T, kAct>
      <<<(unsigned)((items + 255) / 256), 256, 0, stream>>>(
          ws, scale, bias, static_cast<T*>(out), g.rows, g.cols, g.splits);
  return (int)cudaGetLastError();
}

}  // namespace

// x_q NHWC int8; wk (o, kh, kw, c) int8; scale (o,) fp32; bias (o,) fp32
// or null; out NHWC fp32 (out_dtype 0) or bf16 (1); ws int32 (splits, n *
// ho * wo, o), unused (may be null) with one split; ctas the persistent
// grid (at most the work items are launched).
extern "C" int int8_conv2d_dequant(const void* x_q, const void* wk,
                                   const void* scale, const void* bias,
                                   void* out, void* ws, int n, int h, int w,
                                   int c, int o, int kh, int kw, int sh,
                                   int sw, int ph, int pw, int splits,
                                   int ctas, int act, int out_dtype,
                                   void* stream) {
  Shape s;
  Geometry g;
  if (!conv_tile::make_shape(s, n, h, w, c, o, kh, kw, sh, sw, ph, pw, 64,
                             kBN) ||
      !make_geometry(g, s.m, o, kh * kw * ((c + kUnitK - 1) / kUnitK),
                     splits) ||
      ctas < 1 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(scale);
  const float* bf = static_cast<const float*>(bias);
  int32_t* wsi = static_cast<int32_t*>(ws);
  return dispatch(act, out_dtype, [&](auto tt, auto at) {
    using T = typename decltype(tt)::type;
    return launch<T, decltype(at)::kAct>(x_q, wk, sf, bf, out, wsi, s, g,
                                         ctas, st);
  });
}
