// NHWC max / average pooling for sm_90a.
//
// Replaces the Pallas kernel `_pool2d_nhwc` of
// paddle_tpu/ops/pallas/pooling.py (line 91; entries `max_pool2d_nhwc` and
// `avg_pool2d_nhwc`): for each output pixel and channel, the max or the sum
// over the kh x kw window at (y * sh - ph + i, x * sw - pw + j), in fp32,
// the sum then multiplied by the fp32 value of 1 / (kh * kw) (the
// non-exclusive average; the JAX gate sends exclusive averaging with
// padding elsewhere).  A tap in the padding reads the TPU kernel's padding
// value, -inf for max and +0.0 for the sum, and the taps are combined in
// the same order (i, then j), so the result is the plain version's bit for
// bit (NaN propagates as torch.maximum propagates it).  fp32 or bf16 in,
// the same type out.
//
// What bounds it on the H100: bytes.  A pool does kh * kw compares or adds
// per output value against one read of the input and one write of the
// output, so its time is those bytes over 3.35 TB/s.  At VGG's later
// layers the arrays are 0.1-4 MB, so what sets the time is how many
// loads are in flight across the card, not the bytes.  Hence:
//
// * Compile-time windows.  The kernel is instantiated on (KH, KW, SH, SW)
//   for 2x2/2, 3x3/2 and 3x3/1; each thread issues every tap's 16-byte
//   load (padding taps predicated to the fill value, not skipped by a
//   branch) before it combines any, so one window costs one round trip.
//   Other windows take the generic instantiation (runtime kh, kw, sh, sw),
//   which issues a window row's taps 8 at a time the same way.
// * A grid that fills the card.  A thread owns one 16-byte vector of one
//   output pixel (4 fp32 or 8 bf16 channels); neighbouring threads take
//   neighbouring vectors, then pixels, so a warp reads contiguous NHWC
//   rows.  The wrapper's plan (`pooling.pool_plan`) shrinks the CTA from
//   256 threads down to 32 until the small outputs spread over every SM.
// * 32-bit index arithmetic where the tensors fit (the plan says), with
//   one chain of divisions a thread.
//
// The overlapping windows of a stride-1 pool re-read rows from L1 / L2,
// not device memory.
//
// C interface (bound with ctypes): pointers and the stream are `void*`; the
// entry returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "vec.cuh"

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kMaxThreads = 256;
constexpr int kChunk = 8;  // taps of a window row in flight (generic)

// Window codes of the plan: 0 generic, then the compile-time windows.
constexpr int kGeneric = 0;
constexpr int kWin2x2s2 = 1;
constexpr int kWin3x3s2 = 2;
constexpr int kWin3x3s1 = 3;

struct PoolShape {
  int n, h, w, c, ho, wo, kh, kw, sh, sw, ph, pw;
  int64_t total;  // threads: n * ho * wo * (c / vector)
};

// 16 bytes of the padding value: -inf (max) or +0.0 (sum) in T.
template <typename T, bool kMax>
__device__ __forceinline__ uint4 fill_raw() {
  if (!kMax) return make_uint4(0u, 0u, 0u, 0u);
  const unsigned f = sizeof(T) == 4 ? 0xff800000u : 0xff80ff80u;
  return make_uint4(f, f, f, f);
}

template <typename T, bool kMax, int V>
__device__ __forceinline__ void combine(float (&acc)[V], const uint4& raw) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float v = to_float(e[k]);
    if (kMax)
      acc[k] = (v > acc[k] || v != v) ? v : acc[k];
    else
      acc[k] = acc[k] + v;
  }
}

// KH == 0: the generic window (s.kh, s.kw, s.sh, s.sw at run time).
// I: the index type, int where the tensors fit, else int64_t.
template <typename T, bool kMax, int KH, int KW, int SH, int SW, typename I>
__global__ void __launch_bounds__(kMaxThreads)
    pool2d_nhwc_kernel(const T* __restrict__ x, T* __restrict__ out,
                       PoolShape s, float inv_count) {
  constexpr int V = 16 / (int)sizeof(T);  // channels a thread
  const I idx = (I)blockIdx.x * (I)blockDim.x + (I)threadIdx.x;
  if (idx >= (I)s.total) return;
  const int groups = s.c / V;
  const I pix = idx / groups;
  const int g = (int)(idx - pix * groups);
  const I row = pix / s.wo;  // img * ho + oy
  const int ox = (int)(pix - row * s.wo);
  const I img = row / s.ho;
  const int oy = (int)(row - img * s.ho);
  const T* base = x + img * ((I)s.h * s.w * s.c) + g * V;
  const int y0 = oy * (KH ? SH : s.sh) - s.ph;
  const int x0 = ox * (KH ? SW : s.sw) - s.pw;
  const uint4 fill = fill_raw<T, kMax>();
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = kMax ? -INFINITY : 0.0f;
  if constexpr (KH > 0) {
    uint4 raw[KH * KW];
#pragma unroll
    for (int i = 0; i < KH; ++i) {
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        const int y = y0 + i, xx = x0 + j;
        raw[i * KW + j] = fill;
        if ((unsigned)y < (unsigned)s.h && (unsigned)xx < (unsigned)s.w)
          raw[i * KW + j] = __ldg(reinterpret_cast<const uint4*>(
              base + ((I)y * s.w + xx) * s.c));
      }
    }
#pragma unroll
    for (int t = 0; t < KH * KW; ++t) combine<T, kMax, V>(acc, raw[t]);
  } else {
    for (int i = 0; i < s.kh; ++i) {
      const int y = y0 + i;
      const bool row_in = (unsigned)y < (unsigned)s.h;
      for (int j0 = 0; j0 < s.kw; j0 += kChunk) {
        uint4 raw[kChunk];
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const int xx = x0 + j0 + jj;
          raw[jj] = fill;
          if (row_in && j0 + jj < s.kw && (unsigned)xx < (unsigned)s.w)
            raw[jj] = __ldg(reinterpret_cast<const uint4*>(
                base + ((I)y * s.w + xx) * s.c));
        }
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj)
          if (j0 + jj < s.kw) combine<T, kMax, V>(acc, raw[jj]);
      }
    }
  }
  if (!kMax) {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = acc[k] * inv_count;
  }
  store_vec<T, V>(out + pix * s.c + g * V, acc);
}

template <typename T, bool kMax, typename I>
int launch_window(const void* x, void* out, const PoolShape& s, int window,
                  int threads, float inv_count, cudaStream_t stream) {
  const int64_t blocks = (s.total + threads - 1) / threads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  const dim3 grid((unsigned)blocks);
  switch (window) {
    case kWin2x2s2:
      pool2d_nhwc_kernel<T, kMax, 2, 2, 2, 2, I>
          <<<grid, threads, 0, stream>>>(xi, o, s, inv_count);
      break;
    case kWin3x3s2:
      pool2d_nhwc_kernel<T, kMax, 3, 3, 2, 2, I>
          <<<grid, threads, 0, stream>>>(xi, o, s, inv_count);
      break;
    case kWin3x3s1:
      pool2d_nhwc_kernel<T, kMax, 3, 3, 1, 1, I>
          <<<grid, threads, 0, stream>>>(xi, o, s, inv_count);
      break;
    default:
      pool2d_nhwc_kernel<T, kMax, 0, 0, 0, 0, I>
          <<<grid, threads, 0, stream>>>(xi, o, s, inv_count);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* out, const PoolShape& s, int is_max,
           int window, int threads, int index_bits, float inv_count,
           cudaStream_t stream) {
  if (index_bits == 32)
    return is_max ? launch_window<T, true, int>(x, out, s, window, threads,
                                                inv_count, stream)
                  : launch_window<T, false, int>(x, out, s, window, threads,
                                                 inv_count, stream);
  return is_max ? launch_window<T, true, int64_t>(x, out, s, window, threads,
                                                  inv_count, stream)
                : launch_window<T, false, int64_t>(x, out, s, window,
                                                   threads, inv_count, stream);
}

// The window code fits (kh, kw, sh, sw): a compile-time window only for
// its own shape, the generic one for any.
bool window_fits(int window, int kh, int kw, int sh, int sw) {
  switch (window) {
    case kGeneric: return true;
    case kWin2x2s2: return kh == 2 && kw == 2 && sh == 2 && sw == 2;
    case kWin3x3s2: return kh == 3 && kw == 3 && sh == 2 && sw == 2;
    case kWin3x3s1: return kh == 3 && kw == 3 && sh == 1 && sw == 1;
    default: return false;
  }
}

}  // namespace

// The plan: window code (0 generic, 1 2x2/2, 2 3x3/2, 3 3x3/1), threads a
// CTA (32, 64, 128 or 256), index bits (32 where the input and the output
// have fewer than 2^31 elements, else 64).
extern "C" int pool2d_nhwc(const void* x, void* out, int n, int h, int w,
                           int c, int kh, int kw, int sh, int sw, int ph,
                           int pw, int is_max, float inv_count, int dtype,
                           int window, int threads, int index_bits,
                           void* stream) {
  const int vec = dtype == kBF16 ? 8 : 4;
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c % vec != 0 || kh <= 0 ||
      kw <= 0 || sh <= 0 || sw <= 0 || ph < 0 || pw < 0 ||
      h + 2 * ph < kh || w + 2 * pw < kw ||
      !window_fits(window, kh, kw, sh, sw) ||
      (threads != 32 && threads != 64 && threads != 128 && threads != 256) ||
      (index_bits != 32 && index_bits != 64))
    return (int)cudaErrorInvalidValue;
  PoolShape s;
  s.n = n; s.h = h; s.w = w; s.c = c; s.kh = kh; s.kw = kw;
  s.sh = sh; s.sw = sw; s.ph = ph; s.pw = pw;
  s.ho = (h + 2 * ph - kh) / sh + 1;
  s.wo = (w + 2 * pw - kw) / sw + 1;
  s.total = (int64_t)n * s.ho * s.wo * (c / vec);
  const int64_t limit = (int64_t)1 << 31;
  if (index_bits == 32 && ((int64_t)n * h * w * c >= limit ||
                           (int64_t)n * s.ho * s.wo * c >= limit))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(x, out, s, is_max, window, threads, index_bits,
                           inv_count, st);
    case kBF16:
      return launch<__nv_bfloat16>(x, out, s, is_max, window, threads,
                                   index_bits, inv_count, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
