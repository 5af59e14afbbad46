// LayerNorm backward and residual + dropout + LayerNorm backward for sm_90a.
//
// Replaces two Pallas kernels of paddle_tpu/ops/pallas/layer_norm.py:
//   * `_bwd` (line 111, kernel `_ln_bwd_kernel`): dx of out = LN(x) * w + b;
//   * `_rdln_bwd` (line 292, kernel `_rdln_bwd_kernel`): dx and dresidual of
//     out = LN(residual + dropout(x)) * w + b, with the forward's keep mask
//     replayed from the position hash of dropout_hash.cuh keyed by
//     (0, row, column): nothing of the mask or of the sum h is stored.
// Both also give dw = sum over rows of dy * x_hat and db = sum of dy.
//
// Numerics follow the Pallas kernels: x, residual and dy upcast to fp32;
// h = residual + x * keep / (1 - rate) (or x); x_hat = (h - mean) * rstd from
// the forward's fp32 mean and rstd; g = dy * w;
//   dh = rstd * (g - mean(g) - x_hat * mean(g * x_hat));
// dresidual = dh, dx = dh * keep / (1 - rate) (or dh), each rounded once to
// its input's type.  dw and db are fp32 sums cast to w's type at the end.
//
// What bounds it on the H100: bytes.  At 4096 x 768 in bf16 it must read x
// and dy (and the residual) and write dx (and dresidual): 18.9 MB (31.5 MB),
// 5.6 us (9.4 us) at 3.35 TB/s, against ~15 flops a value.  The design keeps
// to one read of each input and one write of each output:
//   1. ln_bwd_kernel: one warp per row as in the forward (16-byte loads, the
//      row in registers, warp-shuffle reductions).  Each warp walks a run of
//      consecutive rows and keeps its lanes' dw/db partials in registers; the
//      8 warps of a block then add theirs into shared memory one warp after
//      another, and the block writes one fp32 partial row of dw and of db.
//   2. ln_partials_reduce_kernel: sums the per-block partials column by
//      column in a fixed order (32 threads a column, then their 32 sums) and
//      casts to w's type.
// No atomics, so dw and db are the same from run to run.  The wrapper picks
// the rows per warp so that about 256 blocks run, which keeps the partials
// (256 x dim x 8 bytes) small beside the rows.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; each entry returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "vec.cuh"

namespace {

using dropout_hash::Params;

constexpr int kWarpsPerBlock = 8;

// T: type of x, residual, dx, dresidual; TW: type of w; TO: type of dy (the
// forward's output type).  Lane l of a warp owns columns (32 c + l) * VEC ..
// + VEC of a row, c < CHUNKS, so dim <= 32 * MAX_ELEMS.
template <typename T, typename TW, typename TO, int MAX_ELEMS, bool RESIDUAL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
              const TW* __restrict__ w, const float* __restrict__ mean,
              const float* __restrict__ rstd, const TO* __restrict__ dy,
              T* __restrict__ dx, T* __restrict__ dres,
              float* __restrict__ dw_part, float* __restrict__ db_part,
              int64_t n, int dim, int rows_per_warp, Params drop) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = MAX_ELEMS / VEC;
  __shared__ float red_w[32 * MAX_ELEMS];
  __shared__ float red_b[32 * MAX_ELEMS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float inv_dim = 1.0f / (float)dim;

  float aw[CHUNKS][VEC], ab[CHUNKS][VEC];  // this lane's dw / db partials
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < VEC; ++i) aw[c][i] = ab[c][i] = 0.f;

  const int64_t row0 =
      ((int64_t)blockIdx.x * kWarpsPerBlock + warp) * rows_per_warp;
  for (int rr = 0; rr < rows_per_warp; ++rr) {
    const int64_t row = row0 + rr;
    if (row >= n) break;
    const float mu = mean[row];
    const float rs = rstd[row];
    float xh[CHUNKS][VEC], g[CHUNKS][VEC];
    float sum_g = 0.f, sum_gx = 0.f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int col = (c * 32 + lane) * VEC;
      if (col < dim) {
        float h[VEC], d[VEC];
        load_vec<T, VEC>(x + row * dim + col, h);
        if (RESIDUAL) {
          float r[VEC];
          load_vec<T, VEC>(res + row * dim + col, r);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            if (drop.on)
              h[i] = dropout_hash::keep(drop.seed, 0u, (uint32_t)row,
                                        (uint32_t)(col + i), drop.threshold)
                         ? h[i] * drop.scale
                         : 0.f;
            h[i] = r[i] + h[i];
          }
        }
        load_vec<TO, VEC>(dy + row * dim + col, d);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          xh[c][i] = (h[i] - mu) * rs;
          g[c][i] = d[i] * to_float(w[col + i]);
          sum_g += g[c][i];
          sum_gx += g[c][i] * xh[c][i];
          aw[c][i] += d[i] * xh[c][i];
          ab[c][i] += d[i];
        }
      }
    }
    const float g_mean = warp_sum(sum_g) * inv_dim;
    const float gx_mean = warp_sum(sum_gx) * inv_dim;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int col = (c * 32 + lane) * VEC;
      if (col < dim) {
        float dh[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          dh[i] = rs * (g[c][i] - g_mean - xh[c][i] * gx_mean);
        if (RESIDUAL) {
          store_vec<T, VEC>(dres + row * dim + col, dh);
          if (drop.on) {
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              dh[i] = dropout_hash::keep(drop.seed, 0u, (uint32_t)row,
                                         (uint32_t)(col + i), drop.threshold)
                          ? dh[i] * drop.scale
                          : 0.f;
          }
        }
        store_vec<T, VEC>(dx + row * dim + col, dh);
      }
    }
  }

  // The block's partials: warps add theirs in a fixed order.
  for (int wi = 0; wi < kWarpsPerBlock; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const int col = (c * 32 + lane) * VEC;
        if (col < dim) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            red_w[col + i] = (wi == 0 ? 0.f : red_w[col + i]) + aw[c][i];
            red_b[col + i] = (wi == 0 ? 0.f : red_b[col + i]) + ab[c][i];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int col = threadIdx.x; col < dim; col += kWarpsPerBlock * 32) {
    dw_part[(int64_t)blockIdx.x * dim + col] = red_w[col];
    db_part[(int64_t)blockIdx.x * dim + col] = red_b[col];
  }
}

// dw[col] = sum over blocks of dw_part[block][col] (and db), in a fixed
// order: thread (x, y) of a 32 x 32 block sums blocks y, y + 32, ... of
// column 32 bx + x (unrolled, so several loads are in flight), then the 32
// sums are added in order of y.
constexpr int kReduceRows = 32;

template <typename TW>
__global__ void __launch_bounds__(32 * kReduceRows)
ln_partials_reduce_kernel(const float* __restrict__ dw_part,
              const float* __restrict__ db_part, int nblocks, int dim,
              TW* __restrict__ dw, TW* __restrict__ db) {
  __shared__ float sw[kReduceRows][32], sb[kReduceRows][32];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float aw = 0.f, ab = 0.f;
  if (col < dim) {
#pragma unroll 4
    for (int r = threadIdx.y; r < nblocks; r += kReduceRows) {
      aw += dw_part[(int64_t)r * dim + col];
      ab += db_part[(int64_t)r * dim + col];
    }
  }
  sw[threadIdx.y][threadIdx.x] = aw;
  sb[threadIdx.y][threadIdx.x] = ab;
  __syncthreads();
  if (threadIdx.y == 0 && col < dim) {
    float tw = 0.f, tb = 0.f;
#pragma unroll
    for (int y = 0; y < kReduceRows; ++y) {
      tw += sw[y][threadIdx.x];
      tb += sb[y][threadIdx.x];
    }
    dw[col] = from_float<TW>(tw);
    db[col] = from_float<TW>(tb);
  }
}

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

struct Ptrs {
  const void* x;
  const void* res;
  const void* w;
  const float* mean;
  const float* rstd;
  const void* dy;
  void* dx;
  void* dres;
  float* dw_part;
  float* db_part;
  void* dw;
  void* db;
};

template <typename T, typename TW, typename TO, bool RESIDUAL>
int launch_types(const Ptrs& p, int64_t n, int dim, int rows_per_warp,
                 Params drop, cudaStream_t stream) {
  const int64_t rows_per_block = (int64_t)kWarpsPerBlock * rows_per_warp;
  const int nblocks = (int)((n + rows_per_block - 1) / rows_per_block);
  const dim3 block(kWarpsPerBlock * 32);
  const auto* xp = static_cast<const T*>(p.x);
  const auto* rp = static_cast<const T*>(p.res);
  const auto* wp = static_cast<const TW*>(p.w);
  const auto* dyp = static_cast<const TO*>(p.dy);
  auto* dxp = static_cast<T*>(p.dx);
  auto* drp = static_cast<T*>(p.dres);
  if (dim <= 32 * 32) {
    ln_bwd_kernel<T, TW, TO, 32, RESIDUAL><<<nblocks, block, 0, stream>>>(
        xp, rp, wp, p.mean, p.rstd, dyp, dxp, drp, p.dw_part, p.db_part, n,
        dim, rows_per_warp, drop);
  } else if (dim <= 32 * 64) {
    ln_bwd_kernel<T, TW, TO, 64, RESIDUAL><<<nblocks, block, 0, stream>>>(
        xp, rp, wp, p.mean, p.rstd, dyp, dxp, drp, p.dw_part, p.db_part, n,
        dim, rows_per_warp, drop);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 reduce_block(32, kReduceRows);
  ln_partials_reduce_kernel<TW><<<(dim + 31) / 32, reduce_block, 0,
                                  stream>>>(p.dw_part, p.db_part, nblocks,
                                            dim, static_cast<TW*>(p.dw),
                                            static_cast<TW*>(p.db));
  return (int)cudaGetLastError();
}

// dy's type is the forward's output type: the promotion of x's and w's.
template <bool RESIDUAL>
int launch(const Ptrs& p, int64_t n, int dim, int rows_per_warp, Params drop,
           int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dtype == kF32 && w_dtype == kF32)
    return launch_types<float, float, float, RESIDUAL>(p, n, dim,
                                                       rows_per_warp, drop, s);
  if (x_dtype == kF32 && w_dtype == kBF16)
    return launch_types<float, bf16, float, RESIDUAL>(p, n, dim,
                                                      rows_per_warp, drop, s);
  if (x_dtype == kBF16 && w_dtype == kBF16)
    return launch_types<bf16, bf16, bf16, RESIDUAL>(p, n, dim, rows_per_warp,
                                                    drop, s);
  if (x_dtype == kBF16 && w_dtype == kF32)
    return launch_types<bf16, float, float, RESIDUAL>(p, n, dim,
                                                      rows_per_warp, drop, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int layer_norm_bwd(const void* x, const void* w, const void* mean,
                              const void* rstd, const void* dy, void* dx,
                              void* dw_part, void* db_part, void* dw,
                              void* db, int64_t n, int dim, int rows_per_warp,
                              int x_dtype, int w_dtype, void* stream) {
  const Ptrs p{x, nullptr, w, static_cast<const float*>(mean),
               static_cast<const float*>(rstd), dy, dx, nullptr,
               static_cast<float*>(dw_part), static_cast<float*>(db_part), dw,
               db};
  return launch<false>(p, n, dim, rows_per_warp, Params{}, x_dtype, w_dtype,
                       stream);
}

extern "C" int residual_layer_norm_bwd(
    const void* x, const void* residual, const void* w, const void* mean,
    const void* rstd, const void* dy, void* dx, void* dres, void* dw_part,
    void* db_part, void* dw, void* db, int64_t n, int dim, int rows_per_warp,
    uint32_t seed, uint32_t threshold, float keep_scale, int dropout,
    int x_dtype, int w_dtype, void* stream) {
  const Ptrs p{x, residual, w, static_cast<const float*>(mean),
               static_cast<const float*>(rstd), dy, dx, dres,
               static_cast<float*>(dw_part), static_cast<float*>(db_part), dw,
               db};
  return launch<true>(p, n, dim, rows_per_warp,
                      Params{seed, threshold, keep_scale, dropout}, x_dtype,
                      w_dtype, stream);
}
