// LayerNorm forward and residual + LayerNorm forward for sm_90a.
//
// Replaces two Pallas kernels of paddle_tpu/ops/pallas/layer_norm.py:
//   * `_fwd` (line 86, kernel `_ln_fwd_kernel`): out = LN(x) * w + b;
//   * `_rdln_fwd` (line 266, kernel `_rdln_fwd_kernel`):
//     out = LN(residual + dropout(x)) * w + b, the dropout in the kernel:
//     x * keep / (1 - rate) with the position hash of dropout_hash.cuh keyed
//     by (0, row, column), so layer_norm_bwd.cu replays the mask.
// Both also write the fp32 per-row mean and rstd the backward reads.
//
// Numerics follow the Pallas kernels: inputs upcast to fp32, the sum
// residual + x taken in fp32, the mean first and then the variance as the
// mean of (h - mean)^2 (two passes over registers, never E[h^2] - E[h]^2,
// which cancels for rows with a large mean), rstd = 1 / sqrt(var + eps),
// out = (h - mean) * rstd * w + b in fp32, rounded once to the output type.
//
// What bounds it on the H100: bytes.  A row of 768 values does ~8 flops per
// value; the card needs ~295 flops per byte before compute matters.  The
// design therefore reads each input byte once and writes each output byte
// once: one warp owns one row, loads it with 16-byte vector loads
// (neighbouring lanes on neighbouring addresses), keeps it in registers for
// both reduction passes and the normalisation, and reduces with warp
// shuffles, so no shared memory and no block barrier is used.  w and b are
// small and stay in L1/L2 across the rows of a block.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; each entry returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "vec.cuh"

namespace {

using dropout_hash::Params;

constexpr int kWarpsPerBlock = 8;

// One warp per row.  T: type of x and residual; TW: type of w and b; TO:
// output type.  MAX_ELEMS: values of one row a lane keeps in registers, so
// dim <= 32 * MAX_ELEMS.  dim % VEC == 0 (checked by the wrapper).
template <typename T, typename TW, typename TO, int MAX_ELEMS, bool RESIDUAL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
              const TW* __restrict__ w, const TW* __restrict__ b,
              TO* __restrict__ out, float* __restrict__ mean_out,
              float* __restrict__ rstd_out, int64_t n, int dim, float eps,
              Params drop) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = MAX_ELEMS / VEC;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;

  const T* xr = x + row * dim;
  const T* rr = RESIDUAL ? res + row * dim : nullptr;
  float v[CHUNKS][VEC];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (col < dim) {
      load_vec<T, VEC>(xr + col, v[c]);
      if (RESIDUAL) {
        float r[VEC];
        load_vec<T, VEC>(rr + col, r);
        if (drop.on) {
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            v[c][i] = dropout_hash::keep(drop.seed, 0u, (uint32_t)row,
                                         (uint32_t)(col + i), drop.threshold)
                          ? v[c][i] * drop.scale
                          : 0.f;
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[c][i] = r[i] + v[c][i];
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) sum += v[c][i];
    }
  }
  const float mean = warp_sum(sum) / (float)dim;

  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (col < dim) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = v[c][i] - mean;
        sq += d * d;
      }
    }
  }
  const float var = warp_sum(sq) / (float)dim;
  const float rstd = 1.0f / sqrtf(var + eps);

  TO* orow = out + row * dim;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (col < dim) {
      float o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        o[i] = (v[c][i] - mean) * rstd * to_float(w[col + i]) +
               to_float(b[col + i]);
      store_vec<TO, VEC>(orow + col, o);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// dtype codes shared with the Python wrapper.
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

template <typename T, typename TW, typename TO, bool RESIDUAL>
int launch_dim(const void* x, const void* res, const void* w, const void* b,
               void* out, float* mean, float* rstd, int64_t n, int dim,
               float eps, Params drop, cudaStream_t stream) {
  const dim3 grid((unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
  const auto* xp = static_cast<const T*>(x);
  const auto* rp = static_cast<const T*>(res);
  const auto* wp = static_cast<const TW*>(w);
  const auto* bp = static_cast<const TW*>(b);
  auto* op = static_cast<TO*>(out);
  if (dim <= 32 * 32) {
    ln_fwd_kernel<T, TW, TO, 32, RESIDUAL><<<grid, block, 0, stream>>>(
        xp, rp, wp, bp, op, mean, rstd, n, dim, eps, drop);
  } else if (dim <= 32 * 64) {
    ln_fwd_kernel<T, TW, TO, 64, RESIDUAL><<<grid, block, 0, stream>>>(
        xp, rp, wp, bp, op, mean, rstd, n, dim, eps, drop);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool RESIDUAL>
int launch(const void* x, const void* res, const void* w, const void* b,
           void* out, float* mean, float* rstd, int64_t n, int dim, float eps,
           Params drop, int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The output type is the promotion of x's and w's types (bf16 only when
  // both are bf16), as result_type does in the Pallas wrapper.
  if (x_dtype == kF32 && w_dtype == kF32)
    return launch_dim<float, float, float, RESIDUAL>(
        x, res, w, b, out, mean, rstd, n, dim, eps, drop, s);
  if (x_dtype == kF32 && w_dtype == kBF16)
    return launch_dim<float, __nv_bfloat16, float, RESIDUAL>(
        x, res, w, b, out, mean, rstd, n, dim, eps, drop, s);
  if (x_dtype == kBF16 && w_dtype == kBF16)
    return launch_dim<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16, RESIDUAL>(
        x, res, w, b, out, mean, rstd, n, dim, eps, drop, s);
  if (x_dtype == kBF16 && w_dtype == kF32)
    return launch_dim<__nv_bfloat16, float, float, RESIDUAL>(
        x, res, w, b, out, mean, rstd, n, dim, eps, drop, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int layer_norm_fwd(const void* x, const void* w, const void* b,
                              void* out, void* mean, void* rstd, int64_t n,
                              int dim, float eps, int x_dtype, int w_dtype,
                              void* stream) {
  return launch<false>(x, nullptr, w, b, out, static_cast<float*>(mean),
                       static_cast<float*>(rstd), n, dim, eps, Params{},
                       x_dtype, w_dtype, stream);
}

extern "C" int residual_layer_norm_fwd(const void* x, const void* residual,
                                       const void* w, const void* b, void* out,
                                       void* mean, void* rstd, int64_t n,
                                       int dim, float eps, uint32_t seed,
                                       uint32_t threshold, float keep_scale,
                                       int dropout, int x_dtype, int w_dtype,
                                       void* stream) {
  return launch<true>(x, residual, w, b, out, static_cast<float*>(mean),
                      static_cast<float*>(rstd), n, dim, eps,
                      Params{seed, threshold, keep_scale, dropout}, x_dtype,
                      w_dtype, stream);
}
