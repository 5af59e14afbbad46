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
// to one read of each input and one write of each output, and keeps enough
// rows in flight to cover the memory latency:
//   1. ln_bwd_kernel: one warp per row, 16-byte loads; lane l holds chunks
//      c * 32 + l of the row (NCH chunks, instantiated on the row's width:
//      768 and 1024 exactly, a bounds-checked route up to 2048).  Where it
//      takes at most 48 registers the row stays in registers as raw 16-byte
//      chunks and is decoded twice (the two sums, then dx); wider rows are
//      read again for dx (from L1/L2).  Where it takes at most 36 (bf16 up
//      to 768 columns, 1024 without the residual) the warp issues the next
//      row's loads before it reduces the current one.  dw/db partials live in shared memory, one slice per
//      warp laid out [chunk][lane] so each lane's float4 read-modify-write
//      is conflict-free; w is staged there once, as fp32.  The grid is one
//      wave of persistent CTAs (the occupancy this build reaches, queried
//      by the entry layer_norm_bwd_resident), warps walking rows gw, gw +
//      warps, ... in a fixed order.  At the end each CTA adds its 8 warps'
//      slices in one fixed-order tree and writes one fp32 partial row of dw
//      and of db.  At bf16 768 the two rows in flight take 130 registers
//      (row 6) and 178 (row 8), so one CTA of 8 warps fits an SM (16 rows
//      in flight, ~74 KB of loads with the residual); capping the registers
//      for 2-3 CTAs an SM spills and was not faster on the card (PERF.md,
//      section 6; experiments/layer_norm_bwd_experiments.py).
//   2. ln_partials_reduce_kernel: sums the per-CTA partials column by
//      column in a fixed order (16 columns a CTA: 48 CTAs at dim 768) and
//      casts to w's type.
// Row 8 hashes each element once: the keep bits of a row are kept in
// registers and serve both h and dx.  No atomics, so dw and db are the same
// from run to run on one device.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; each entry returns cudaGetLastError() after its launches, or a
// CUDA error code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_layout.cuh"
#include "dropout_hash.cuh"
#include "vec.cuh"

namespace {

using dropout_hash::Params;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Decode one 16-byte chunk of T into fp32.
template <typename T>
__device__ __forceinline__ void decode(const uint4& raw, float* f) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) f[i] = to_float(e[i]);
}

// One 16-byte chunk of x (and residual) and the dy values beside it.
template <typename T, typename TO, bool RESIDUAL>
struct Chunk {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int DYV = VEC * sizeof(TO) / 16;  // dy chunks a chunk
  uint4 x;
  uint4 r[1];  // the residual's chunk (unused without one)
  uint4 d[DYV];
};

// A row as a lane holds it: its chunks (HOLD: all NCH in registers; else
// none, and each pass reads them again, from L1/L2) and its stats.
template <typename T, typename TO, int NCH, bool RESIDUAL, bool HOLD>
struct RowData {
  Chunk<T, TO, RESIDUAL> ch[HOLD ? NCH : 1];
  float mu, rs;
};

// Shared-memory float offset of float4 q of chunk c of `lane`, in one
// NCH * 32 * VEC slice.
template <int VEC>
__device__ __forceinline__ int slot(int c, int q, int lane) {
  return ((c * (VEC / 4) + q) * 32 + lane) * 4;
}

// Dynamic shared memory of a CTA: w and the 8 warps' dw and db slices.
template <typename T, int NCH>
constexpr int smem_bytes() {
  return (1 + 2 * kWarps) * NCH * 32 * (16 / (int)sizeof(T)) * 4;
}

// T: type of x, residual, dx, dresidual; TW: type of w; TO: type of dy (the
// forward's output type).  EXACT: dim == NCH * 32 * VEC (no bounds checks).
template <typename T, typename TW, typename TO, int NCH, bool EXACT,
          bool RESIDUAL>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
              const TW* __restrict__ w, const float* __restrict__ mean,
              const float* __restrict__ rstd, const TO* __restrict__ dy,
              T* __restrict__ dx, T* __restrict__ dres,
              float* __restrict__ dw_part, float* __restrict__ db_part,
              int64_t n, int dim, Params drop) {
  using Ch = Chunk<T, TO, RESIDUAL>;
  constexpr int VEC = Ch::VEC;
  constexpr int DYV = Ch::DYV;
  constexpr int L = NCH * 32 * VEC;  // floats in one slice
  // 16-byte registers of row a lane holds: all of it up to 12 (48
  // registers); a second row in flight up to 9.
  constexpr int kRowRegs = NCH * (1 + (RESIDUAL ? 1 : 0) + DYV);
  constexpr bool HOLD = kRowRegs <= 12;
  constexpr bool PREFETCH = kRowRegs <= 9;
  using Row = RowData<T, TO, NCH, RESIDUAL, HOLD>;
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* pw = w_s + L * (1 + warp);            // this warp's dw slice
  float* pb = w_s + L * (1 + kWarps + warp);   // and db slice
  const float inv_dim = 1.0f / (float)dim;

  // Stage w as fp32; zero this warp's partials.
  for (int p4 = threadIdx.x; p4 < L / 4; p4 += kThreads) {
    const int ln = p4 % 32, rest = p4 / 32;
    const int q = rest % (VEC / 4), c = rest / (VEC / 4);
    const int col = (c * 32 + ln) * VEC + q * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col < dim)
      v = make_float4(to_float(w[col]), to_float(w[col + 1]),
                      to_float(w[col + 2]), to_float(w[col + 3]));
    smem4[p4] = v;
  }
  for (int p4 = lane; p4 < L / 4; p4 += 32) {
    reinterpret_cast<float4*>(pw)[p4] = make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(pb)[p4] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  auto active = [&](int c) {
    return EXACT || (c * 32 + lane) * VEC < dim;
  };
  auto load_chunk = [&](Ch& ch, int64_t row, int c) {
    const int64_t off = row * dim + (c * 32 + lane) * VEC;
    ch.x = *reinterpret_cast<const uint4*>(x + off);
    if constexpr (RESIDUAL)
      ch.r[0] = *reinterpret_cast<const uint4*>(res + off);
#pragma unroll
    for (int v = 0; v < DYV; ++v)
      ch.d[v] = reinterpret_cast<const uint4*>(dy + off)[v];
  };
  auto load = [&](Row& rd, int64_t row) {
    rd.mu = mean[row];
    rd.rs = rstd[row];
    if constexpr (HOLD) {
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        if (active(c)) load_chunk(rd.ch[c], row, c);
    }
  };
  auto chunk = [&](const Row& rd, int64_t row, int c) {
    if constexpr (HOLD) {
      return rd.ch[c];
    } else {
      Ch ch;
      load_chunk(ch, row, c);
      return ch;
    }
  };
  // h of a chunk with its keep bits (bit i: element i kept).
  auto h_of = [&](const Ch& ch, uint32_t kb, float* h) {
    decode<T>(ch.x, h);
    if constexpr (RESIDUAL) {
      float r[VEC];
      decode<T>(ch.r[0], r);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (drop.on) h[i] = (kb >> i) & 1u ? h[i] * drop.scale : 0.f;
        h[i] = r[i] + h[i];
      }
    }
  };
  auto dy_of = [&](const Ch& ch, float* d) {
    constexpr int kPer = 16 / (int)sizeof(TO);
#pragma unroll
    for (int v = 0; v < DYV; ++v) decode<TO>(ch.d[v], d + v * kPer);
  };

  auto process = [&](const Row& rd, int64_t row) {
    uint32_t kb[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      kb[c] = 0u;
      if (RESIDUAL && drop.on && active(c)) {
        const int col = (c * 32 + lane) * VEC;
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          kb[c] |= (uint32_t)dropout_hash::keep(drop.seed, 0u, (uint32_t)row,
                                                (uint32_t)(col + i),
                                                drop.threshold)
                   << i;
      }
    }
    float sum_g = 0.f, sum_gx = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (!active(c)) continue;
      float h[VEC], d[VEC];
      const Ch ch = chunk(rd, row, c);
      h_of(ch, kb[c], h);
      dy_of(ch, d);
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {
        const int o = slot<VEC>(c, q, lane);
        const float4 wv = *reinterpret_cast<const float4*>(w_s + o);
        float4 aw = *reinterpret_cast<float4*>(pw + o);
        float4 ab = *reinterpret_cast<float4*>(pb + o);
        const float wq[4] = {wv.x, wv.y, wv.z, wv.w};
        float awq[4] = {aw.x, aw.y, aw.z, aw.w};
        float abq[4] = {ab.x, ab.y, ab.z, ab.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          const float xh = (h[i] - rd.mu) * rd.rs;
          const float g = d[i] * wq[e];
          sum_g += g;
          sum_gx += g * xh;
          awq[e] += d[i] * xh;
          abq[e] += d[i];
        }
        *reinterpret_cast<float4*>(pw + o) =
            make_float4(awq[0], awq[1], awq[2], awq[3]);
        *reinterpret_cast<float4*>(pb + o) =
            make_float4(abq[0], abq[1], abq[2], abq[3]);
      }
    }
    const float g_mean = warp_sum(sum_g) * inv_dim;
    const float gx_mean = warp_sum(sum_gx) * inv_dim;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (!active(c)) continue;
      const int64_t off = row * dim + (c * 32 + lane) * VEC;
      float h[VEC], d[VEC], dh[VEC];
      const Ch ch = chunk(rd, row, c);
      h_of(ch, kb[c], h);
      dy_of(ch, d);
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {
        const float4 wv =
            *reinterpret_cast<const float4*>(w_s + slot<VEC>(c, q, lane));
        const float wq[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          const float xh = (h[i] - rd.mu) * rd.rs;
          dh[i] = rd.rs * (d[i] * wq[e] - g_mean - xh * gx_mean);
        }
      }
      if constexpr (RESIDUAL) {
        store_vec<T, VEC>(dres + off, dh);
        if (drop.on) {
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            dh[i] = (kb[c] >> i) & 1u ? dh[i] * drop.scale : 0.f;
        }
      }
      store_vec<T, VEC>(dx + off, dh);
    }
  };

  const int64_t stride = (int64_t)gridDim.x * kWarps;
  int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  Row cur;
  if (row < n) load(cur, row);
  while (row < n) {
    const int64_t next = row + stride;
    Row nxt;
    if (PREFETCH && next < n) load(nxt, next);
    process(cur, row);
    row = next;
    if (row < n) {
      if (PREFETCH)
        cur = nxt;
      else
        load(cur, row);
    }
  }
  __syncthreads();

  // The CTA's partials: its warps' slices added in one fixed-order tree.
  for (int p4 = threadIdx.x; p4 < L / 4; p4 += kThreads) {
    const int ln = p4 % 32, rest = p4 / 32;
    const int q = rest % (VEC / 4), c = rest / (VEC / 4);
    const int col = (c * 32 + ln) * VEC + q * 4;
    if (col >= dim) continue;
    float4 sw[kWarps], sb[kWarps];
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) {
      sw[wi] = smem4[L / 4 * (1 + wi) + p4];
      sb[wi] = smem4[L / 4 * (1 + kWarps + wi) + p4];
    }
#pragma unroll
    for (int span = 1; span < kWarps; span *= 2)
#pragma unroll
      for (int wi = 0; wi + span < kWarps; wi += 2 * span) {
        sw[wi].x += sw[wi + span].x; sw[wi].y += sw[wi + span].y;
        sw[wi].z += sw[wi + span].z; sw[wi].w += sw[wi + span].w;
        sb[wi].x += sb[wi + span].x; sb[wi].y += sb[wi + span].y;
        sb[wi].z += sb[wi + span].z; sb[wi].w += sb[wi + span].w;
      }
    *reinterpret_cast<float4*>(dw_part + (int64_t)blockIdx.x * dim + col) =
        sw[0];
    *reinterpret_cast<float4*>(db_part + (int64_t)blockIdx.x * dim + col) =
        sb[0];
  }
}

// dw[col] = sum over CTAs of dw_part[cta][col] (and db), in a fixed order:
// thread (x, y) of a 16 x 16 block sums partial rows y, y + 16, ... of
// column 16 bx + x, then thread y = 0 adds the 16 sums in order of y.
constexpr int kReduceCols = 16;
constexpr int kReduceRows = 16;

template <typename TW>
__global__ void __launch_bounds__(kReduceCols * kReduceRows)
ln_partials_reduce_kernel(const float* __restrict__ dw_part,
                          const float* __restrict__ db_part, int nparts,
                          int dim, TW* __restrict__ dw, TW* __restrict__ db) {
  __shared__ float sw[kReduceRows][kReduceCols], sb[kReduceRows][kReduceCols];
  const int col = blockIdx.x * kReduceCols + threadIdx.x;
  float aw = 0.f, ab = 0.f;
  if (col < dim) {
#pragma unroll 4
    for (int r = threadIdx.y; r < nparts; r += kReduceRows) {
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

// Set the kernel's shared-memory limit and carve-out once per device.
template <typename Kernel>
int prepare(Kernel kernel, int smem, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && done[dev]) return 0;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
           (int)cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
    return (int)err;
  if (dev < kMaxDevices) done[dev] = true;
  return 0;
}

// One instantiation: `resident` (non-null) receives the CTAs one wave holds
// on this device; otherwise launch `nparts` CTAs and the column sums.
template <typename T, typename TW, typename TO, int NCH, bool EXACT,
          bool RESIDUAL>
int run(const Ptrs& p, int64_t n, int dim, int nparts, Params drop,
        cudaStream_t stream, int* resident) {
  static bool done[kMaxDevices] = {};
  auto kernel = ln_bwd_kernel<T, TW, TO, NCH, EXACT, RESIDUAL>;
  constexpr int smem = smem_bytes<T, NCH>();
  int err = prepare(kernel, smem, done);
  if (err) return err;
  if (resident) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    *resident = per_sm * sms;
    return per_sm > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
  }
  kernel<<<nparts, kThreads, smem, stream>>>(
      static_cast<const T*>(p.x), static_cast<const T*>(p.res),
      static_cast<const TW*>(p.w), p.mean, p.rstd,
      static_cast<const TO*>(p.dy), static_cast<T*>(p.dx),
      static_cast<T*>(p.dres), p.dw_part, p.db_part, n, dim, drop);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 reduce_block(kReduceCols, kReduceRows);
  ln_partials_reduce_kernel<TW><<<(dim + kReduceCols - 1) / kReduceCols,
                                  reduce_block, 0, stream>>>(
      p.dw_part, p.db_part, nparts, dim, static_cast<TW*>(p.dw),
      static_cast<TW*>(p.db));
  return (int)cudaGetLastError();
}

// The instantiation for dim: the rows of 768 and 1024 exactly, others up
// to 2048 with bounds checks.
template <typename T, typename TW, typename TO, bool RESIDUAL>
int dispatch_dim(const Ptrs& p, int64_t n, int dim, int nparts, Params drop,
                 cudaStream_t s, int* resident) {
  constexpr int VEC = 16 / sizeof(T);
  if (dim % VEC || dim <= 0 || dim > 2048) return (int)cudaErrorInvalidValue;
  if (dim == 768)
    return run<T, TW, TO, 768 / (32 * VEC), true, RESIDUAL>(p, n, dim, nparts,
                                                           drop, s, resident);
  if (dim == 1024)
    return run<T, TW, TO, 1024 / (32 * VEC), true, RESIDUAL>(
        p, n, dim, nparts, drop, s, resident);
  return run<T, TW, TO, 2048 / (32 * VEC), false, RESIDUAL>(
      p, n, dim, nparts, drop, s, resident);
}

// dy's type is the forward's output type: the promotion of x's and w's.
template <bool RESIDUAL>
int dispatch(const Ptrs& p, int64_t n, int dim, int nparts, Params drop,
             int x_dtype, int w_dtype, void* stream, int* resident) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dtype == kF32 && w_dtype == kF32)
    return dispatch_dim<float, float, float, RESIDUAL>(p, n, dim, nparts,
                                                       drop, s, resident);
  if (x_dtype == kF32 && w_dtype == kBF16)
    return dispatch_dim<float, bf16, float, RESIDUAL>(p, n, dim, nparts,
                                                      drop, s, resident);
  if (x_dtype == kBF16 && w_dtype == kBF16)
    return dispatch_dim<bf16, bf16, bf16, RESIDUAL>(p, n, dim, nparts, drop,
                                                    s, resident);
  if (x_dtype == kBF16 && w_dtype == kF32)
    return dispatch_dim<bf16, float, float, RESIDUAL>(p, n, dim, nparts,
                                                      drop, s, resident);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The CTAs one wave of the backward kernel holds on the current device
// (its blocks per SM at this build's registers and shared memory, times
// the SMs), written to *out; returns a CUDA error code.
extern "C" int layer_norm_bwd_resident(int dim, int residual, int x_dtype,
                                       int w_dtype, int* out) {
  const Ptrs p{};
  return residual ? dispatch<true>(p, 0, dim, 0, Params{}, x_dtype, w_dtype,
                                   nullptr, out)
                  : dispatch<false>(p, 0, dim, 0, Params{}, x_dtype, w_dtype,
                                    nullptr, out);
}

extern "C" int layer_norm_bwd(const void* x, const void* w, const void* mean,
                              const void* rstd, const void* dy, void* dx,
                              void* dw_part, void* db_part, void* dw,
                              void* db, int64_t n, int dim, int nparts,
                              int x_dtype, int w_dtype, void* stream) {
  const Ptrs p{x, nullptr, w, static_cast<const float*>(mean),
               static_cast<const float*>(rstd), dy, dx, nullptr,
               static_cast<float*>(dw_part), static_cast<float*>(db_part), dw,
               db};
  if (nparts <= 0) return (int)cudaErrorInvalidValue;
  return dispatch<false>(p, n, dim, nparts, Params{}, x_dtype, w_dtype,
                         stream, nullptr);
}

extern "C" int residual_layer_norm_bwd(
    const void* x, const void* residual, const void* w, const void* mean,
    const void* rstd, const void* dy, void* dx, void* dres, void* dw_part,
    void* db_part, void* dw, void* db, int64_t n, int dim, int nparts,
    uint32_t seed, uint32_t threshold, float keep_scale, int dropout,
    int x_dtype, int w_dtype, void* stream) {
  const Ptrs p{x, residual, w, static_cast<const float*>(mean),
               static_cast<const float*>(rstd), dy, dx, dres,
               static_cast<float*>(dw_part), static_cast<float*>(db_part), dw,
               db};
  if (nparts <= 0) return (int)cudaErrorInvalidValue;
  return dispatch<true>(p, n, dim, nparts,
                        Params{seed, threshold, keep_scale, dropout}, x_dtype,
                        w_dtype, stream, nullptr);
}
