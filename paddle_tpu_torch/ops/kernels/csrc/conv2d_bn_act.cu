// Fused NHWC convolution + per-channel epilogue for sm_90a.
//
// Replaces the Pallas kernel `conv2d_bn_act` of
// paddle_tpu/ops/pallas/conv_fused.py (line 152):
//
//   out[n, y, x, o] = act(sum_{i, j, c} xpad[n, y*sh + i, x*sw + j, c]
//                                       * w[o, c, i, j] * a[o] + b[o])
//
// with x NHWC (fp32 or bf16), the filter given as (kh, kw, C, O) in x's
// dtype (the wrapper transposes the OIHW weight per call, as the JAX
// wrapper does), a and b fp32 (O,), the sum in fp32 and the output NHWC in
// x's dtype.  Acts: none, relu, relu6, sigmoid, tanh, gelu (erf), silu.
// Zero padding is a bounds check on each input row; the JAX wrapper's
// padded copy of x (a TPU block-shape artefact) is not made.  The pixel
// addressing and the A-tile copies are conv_tile.cuh's, shared with the
// int8 convolution.
//
// Implicit GEMM: M = n * Ho * Wo output pixels, N = O channels, K = kh * kw
// * C.  A CTA of 4 warps owns a 64-pixel x 128-channel output tile and
// walks K in tiles of one tap and 64 bytes of channels (32 bf16 or 16
// fp32): the 64 input rows of that tap (zero-filled where the tap falls in
// the padding or past the last pixel) and the filter slice are copied into
// shared memory with cp.async, three stages deep, so the next tiles load
// while one is multiplied.  bf16 multiplies on mma.sync m16n8k16 with fp32
// accumulators (each warp 32 pixels x 64 channels); the products of bf16
// values are exact in fp32, so this is the TPU kernel's fp32 dot in another
// summation order.  fp32 multiplies on FMAs (each thread 8 x 8 outputs).
// The epilogue applies acc * a[o] + b[o] and the activation in fp32 and
// stores in x's dtype.  O is a multiple of 128 and C of 32, so only the
// pixel dimension has a tail.
//
// What bounds it on the H100: operations.  A 3x3 conv does 2 * 9 * C flops
// for each output value against ~2 bytes of activations read and written,
// far above the bf16 ridge (~295 flops a byte).  This first kernel uses
// mma.sync, not wgmma, and no TMA, so it reaches a fraction of the tensor
// cores' rate; making it fast is later work.
//
// C interface (bound with ctypes): pointers and the stream are `void*`; the
// entry returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act.cuh"
#include "conv_tile.cuh"
#include "mma_bf16.cuh"

namespace {

using conv_tile::kBM;       // output pixels per CTA
using conv_tile::kKBytes;   // channel bytes per K tile
using conv_tile::kThreads;  // 4 warps
using conv_tile::RowInfo;
using conv_tile::Shape;
using conv_tile::cp_async16;
using conv_tile::cp_async_commit;
using conv_tile::cp_async_wait;

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

constexpr int kBN = 128;       // output channels per CTA
constexpr int kStages = 3;

using epilogue_act::apply_act;
using epilogue_act::kNone;
using epilogue_act::kSilu;

template <typename T>
struct Tile {
  static constexpr int kBK = kKBytes / (int)sizeof(T);  // channels a K tile
  static constexpr int kPad = 16 / (int)sizeof(T);      // one 16-byte chunk
  static constexpr int kLdA = kBK + kPad;               // A row stride
  static constexpr int kLdB = kBN + kPad;               // B row stride
  static constexpr int kA = kBM * kLdA;
  static constexpr int kB = kBK * kLdB;
  static constexpr int kStage = kA + kB;
};

template <typename T>
__device__ __forceinline__ void load_tile(T* stage, const T* x, const T* wk,
                                          const Shape& s, const RowInfo& ri,
                                          int kt, int n0) {
  using Cfg = Tile<T>;
  const int tid = threadIdx.x;
  const int c_tiles = s.c / Cfg::kBK;
  const int tap = kt / c_tiles;
  const int c0 = (kt - tap * c_tiles) * Cfg::kBK;
  const int i = tap / s.kw, j = tap - (tap / s.kw) * s.kw;
  T* Bs = stage + Cfg::kA;
  conv_tile::load_a<T>(stage, Cfg::kLdA, x, s, ri, i, j, c0);
  constexpr int kChunksB = kBN * (int)sizeof(T) / 16;  // chunks in a B row
  constexpr int kPer = Cfg::kBK * kChunksB / kThreads;
  const T* wrow = wk + ((int64_t)tap * s.c + c0) * s.o + n0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = tid + q * kThreads;
    const int r = e / kChunksB, ch = e % kChunksB;
    cp_async16(Bs + r * Cfg::kLdB + ch * (16 / (int)sizeof(T)),
               wrow + (int64_t)r * s.o + ch * (16 / (int)sizeof(T)), 16);
  }
}

// bf16: warp (wm, wn) of a 2 x 2 grid owns 32 pixels x 64 channels, i.e.
// 2 m16 tiles x 8 n8 tiles of mma accumulators.
struct MmaAcc {
  float v[2][8][4];
};

__device__ __forceinline__ void compute_mma(const __nv_bfloat16* stage,
                                            MmaAcc& acc) {
  using Cfg = Tile<__nv_bfloat16>;
  const __nv_bfloat16* As = stage;
  const __nv_bfloat16* Bs = stage + Cfg::kA;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int kk = 0; kk < Cfg::kBK; kk += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      mma_bf16::load_a(a[mi], As, Cfg::kLdA, wm * 32 + mi * 16, kk, lane);
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      uint32_t b[4];
      mma_bf16::load_b(b, Bs, Cfg::kLdB, kk, wn * 64 + nj * 16, lane);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16::mma(acc.v[mi][2 * nj], a[mi], b[0], b[1]);
        mma_bf16::mma(acc.v[mi][2 * nj + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// fp32: thread (ty, tx) of a 16 x 8 grid owns pixels ty + 8 r (r < 8) and
// channels 8 tx .. 8 tx + 7.
__device__ __forceinline__ void compute_fma(const float* stage,
                                            float (&acc)[8][8]) {
  using Cfg = Tile<float>;
  const float* As = stage;
  const float* Bs = stage + Cfg::kA;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int k = 0; k < Cfg::kBK; ++k) {
    float av[8], bv[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) av[r] = As[(ty + 8 * r) * Cfg::kLdA + k];
    const float4 b0 =
        *reinterpret_cast<const float4*>(Bs + k * Cfg::kLdB + 8 * tx);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + k * Cfg::kLdB + 8 * tx + 4);
    bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
    bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv2d_bn_act_kernel(const T* __restrict__ x, const T* __restrict__ wk,
                         const float* __restrict__ a,
                         const float* __restrict__ b, T* __restrict__ out,
                         Shape s, int act) {
  using Cfg = Tile<T>;
  __shared__ __align__(16) unsigned char smem_raw[kStages * Cfg::kStage *
                                                 sizeof(T)];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;

  const RowInfo ri = conv_tile::row_info(s, m0);

  const int k_tiles = s.kh * s.kw * (s.c / Cfg::kBK);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < k_tiles) load_tile<T>(smem + st * Cfg::kStage, x, wk, s, ri, st,
                                   n0);
    cp_async_commit();
  }

  constexpr bool kMma = sizeof(T) == 2;
  MmaAcc macc;
  float facc[8][8];
  if constexpr (kMma) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) macc.v[mi][ni][e] = 0.0f;
  } else {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) facc[r][c] = 0.0f;
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < k_tiles)
      load_tile<T>(smem + (nk % kStages) * Cfg::kStage, x, wk, s, ri, nk, n0);
    cp_async_commit();
    const T* stage = smem + (kt % kStages) * Cfg::kStage;
    if constexpr (kMma)
      compute_mma(reinterpret_cast<const __nv_bfloat16*>(stage), macc);
    else
      compute_fma(reinterpret_cast<const float*>(stage), facc);
  }
  cp_async_wait<0>();

  if constexpr (kMma) {
    const int lane = tid & 31, warp = tid >> 5;
    const int wm = warp >> 1, wn = warp & 1;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t p = m0 + wm * 32 + mi * 16 + g + half * 8;
        if (p >= s.m) continue;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int o = n0 + wn * 64 + ni * 8 + 2 * t;
          const float v0 = apply_act(
              macc.v[mi][ni][2 * half] * a[o] + b[o], act);
          const float v1 = apply_act(
              macc.v[mi][ni][2 * half + 1] * a[o + 1] + b[o + 1], act);
          *reinterpret_cast<__nv_bfloat162*>(out + p * s.o + o) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  } else {
    const int tx = tid % 16, ty = tid / 16;
    const int o = n0 + 8 * tx;
    float av[8], bv[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      av[c] = a[o + c];
      bv[c] = b[o + c];
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int64_t p = m0 + ty + 8 * r;
      if (p >= s.m) continue;
      float v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        v[c] = apply_act(facc[r][c] * av[c] + bv[c], act);
      float* dst = reinterpret_cast<float*>(out) + p * s.o + o;
      reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* wk, const float* a, const float* b,
           void* out, const Shape& s, int act, cudaStream_t stream) {
  dim3 grid((unsigned)((s.m + kBM - 1) / kBM), (unsigned)(s.o / kBN));
  conv2d_bn_act_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wk), a, b,
      static_cast<T*>(out), s, act);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int conv2d_bn_act(const void* x, const void* wk, const void* a,
                             const void* b, void* out, int n, int h, int w,
                             int c, int o, int kh, int kw, int sh, int sw,
                             int ph, int pw, int act, int dtype,
                             void* stream) {
  const int bk = dtype == kBF16 ? Tile<__nv_bfloat16>::kBK : Tile<float>::kBK;
  Shape s;
  if (!conv_tile::make_shape(s, n, h, w, c, o, kh, kw, sh, sw, ph, pw, bk,
                             kBN) ||
      act < kNone || act > kSilu)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  switch (dtype) {
    case kF32:
      return launch<float>(x, wk, af, bf, out, s, act, st);
    case kBF16:
      return launch<__nv_bfloat16>(x, wk, af, bf, out, s, act, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
