// Baseline of the NHWC max / average pool (row 13), for the experiments
// only: the design that csrc/pool2d_nhwc.cu's compile-time windows
// replaced, its kernel unchanged.  Nothing of the port builds or calls it
// (experiments/bn_pool_experiments.py does).
//
// Replaces the Pallas kernel `_pool2d_nhwc` of
// paddle_tpu/ops/pallas/pooling.py (line 91; entries `max_pool2d_nhwc` and
// `avg_pool2d_nhwc`): for each output pixel and channel, the max or the sum
// over the kh x kw window at (y * sh - ph + i, x * sw - pw + j), in fp32,
// the sum then multiplied by the fp32 value of 1 / (kh * kw) (the
// non-exclusive average; the JAX gate sends exclusive averaging with
// padding elsewhere).  Taps in the padding are skipped: for max that is the
// TPU kernel's -inf padding, for the sum its zeros (adding +0.0 leaves a
// sum started at +0.0 unchanged), and the taps are visited in the same
// order (i, then j), so the result is the plain version's bit for bit.
// fp32 or bf16 in, the same type out.
//
// What bounds it on the H100: bytes.  A pool does kh * kw compares or adds
// per output value against one read of the input and one write of the
// output, so its time is those bytes over 3.35 TB/s.  Each thread owns 8
// channels of one output pixel, loaded as 16-byte vectors (one for bf16,
// two for fp32); neighbouring threads take neighbouring channel groups and
// then neighbouring pixels, so a warp reads contiguous NHWC rows.  The
// overlapping windows of a stride-1 pool re-read rows from L2, not device
// memory.
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
constexpr int kVec = 8;  // channels per thread
constexpr int kThreads = 256;

struct PoolShape {
  int n, h, w, c, ho, wo, kh, kw, sh, sw, ph, pw;
};

template <typename T, bool kMax>
__global__ void __launch_bounds__(kThreads)
    pool2d_nhwc_kernel(const T* __restrict__ x, T* __restrict__ out,
                       PoolShape s, float inv_count) {
  const int groups = s.c / kVec;
  const int64_t total = (int64_t)s.n * s.ho * s.wo * groups;
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int g = (int)(idx % groups);
  const int64_t pix = idx / groups;
  const int ox = (int)(pix % s.wo);
  const int oy = (int)((pix / s.wo) % s.ho);
  const int img = (int)(pix / ((int64_t)s.wo * s.ho));
  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = kMax ? -INFINITY : 0.0f;
  for (int i = 0; i < s.kh; ++i) {
    const int y = oy * s.sh - s.ph + i;
    if (y < 0 || y >= s.h) continue;
    for (int j = 0; j < s.kw; ++j) {
      const int xx = ox * s.sw - s.pw + j;
      if (xx < 0 || xx >= s.w) continue;
      float v[kVec];
      load_vec<T, kVec>(
          x + (((int64_t)img * s.h + y) * s.w + xx) * s.c + g * kVec, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        if (kMax)
          acc[e] = (v[e] > acc[e] || v[e] != v[e]) ? v[e] : acc[e];
        else
          acc[e] = acc[e] + v[e];
      }
    }
  }
  if (!kMax) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = acc[e] * inv_count;
  }
  store_vec<T, kVec>(out + pix * s.c + g * kVec, acc);
}

template <typename T>
int launch(const void* x, void* out, const PoolShape& s, int is_max,
           float inv_count, cudaStream_t stream) {
  const int64_t total = (int64_t)s.n * s.ho * s.wo * (s.c / kVec);
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (is_max)
    pool2d_nhwc_kernel<T, true>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(xi, o, s, inv_count);
  else
    pool2d_nhwc_kernel<T, false>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(xi, o, s, inv_count);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pool2d_nhwc(const void* x, void* out, int n, int h, int w,
                           int c, int kh, int kw, int sh, int sw, int ph,
                           int pw, int is_max, float inv_count, int dtype,
                           void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c % kVec != 0 || kh <= 0 ||
      kw <= 0 || sh <= 0 || sw <= 0 || ph < 0 || pw < 0 ||
      h + 2 * ph < kh || w + 2 * pw < kw)
    return (int)cudaErrorInvalidValue;
  PoolShape s;
  s.n = n; s.h = h; s.w = w; s.c = c; s.kh = kh; s.kw = kw;
  s.sh = sh; s.sw = sw; s.ph = ph; s.pw = pw;
  s.ho = (h + 2 * ph - kh) / sh + 1;
  s.wo = (w + 2 * pw - kw) / sw + 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(x, out, s, is_max, inv_count, st);
    case kBF16:
      return launch<__nv_bfloat16>(x, out, s, is_max, inv_count, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
