// Paged decode attention for sm_90a.
//
// Replaces the Pallas kernel `paged_attention_kernel` of
// paddle_tpu/ops/pallas/paged_attention.py (line 116): for each query row s
// with one token, out[s] = softmax(q[s] . K[s]^T * sm_scale) . V[s], with K/V
// gathered block by block through block_tables[s, :] and masked to
// positions < context_lens[s].  Caches are fp32, bf16 or int8; int8 blocks
// carry a per-block fp32 (k_scale, v_scale) pair and are dequantised next to
// the dot.
//
// Numerics follow the Pallas kernel: q and K/V values go to fp32, scores
// = dot * sm_scale in fp32, an online softmax over blocks with fp32 running
// max m, sum l and accumulator acc (per block: m' = max(m, block max),
// alpha = exp(m - m'), p = exp(score - m'), l = l alpha + sum p, acc = acc
// alpha + p . V); positions past the context add exactly 0; with bf16
// caches p is rounded to bf16 before p . V while l sums the unrounded p;
// out = acc / max(l, 1e-30), so a row with context_len 0 is exactly 0.
//
// What bounds it on the H100: bytes.  A decode row does ~4 d flops for each
// K/V token it reads (2 d elements), far below the ~20 flops per byte of
// fp32 FMA throughput, so the time is the K/V bytes of the live context over
// 3.35 TB/s.  The design reads only those bytes and reads each once:
//   * one CTA of kWarps warps per query row; warp w takes the row's table
//     entries w, w + kWarps, ... and stops at ceil(context_len / block_size)
//     (the TPU kernel DMAs all max_blocks and masks them);
//   * a token row of d values is covered by a group of G lanes, each lane
//     loading 16 bytes (NPL of them for fp32 rows wider than 128), so a warp
//     reads 32 / G tokens of a block at once with 16-byte loads on
//     neighbouring addresses, and U of those loads are in flight before the
//     first is used;
//   * dot products are fp32 shuffle sums inside the group; scores of the
//     block go through shared memory for the block max and p;
//   * each warp keeps its own (m, l, acc); at the end the warps' states are
//     merged in warp order in shared memory, so results repeat bit for bit.
// No tensor cores: one query row against a stream of K/V rows has no reuse.
// Split-KV for long contexts at small batch is later work.
//
// C interface (bound with ctypes): pointers and the stream are `void*`; the
// entry returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // warps per CTA; one CTA per query row
constexpr int kMaxBlockSize = 64;  // tokens per cache block
constexpr int kMaxDim = 256;
constexpr int kUnroll = 4;         // token loads in flight per group
constexpr float kNegInf = -1e30f;

// dtype codes shared with the Python wrapper.
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kI8 = 2;

// 16 bytes of T as fp32 values (16 / sizeof(T) of them).
__device__ __forceinline__ void unpack16(const uint4& raw, float* f, float) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(const uint4& raw, float* f,
                                         __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack16(const uint4& raw, float* f, int8_t) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = (float)e[i];
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// TKV: cache element type.  G: lanes per token row (a power of two).  NPL:
// 16-byte vectors a lane covers in a row (2 only for fp32 rows wider than
// 128 values).
template <typename TKV, int G, int NPL>
__global__ void __launch_bounds__(kWarps * 32)
paged_attn_kernel(const void* __restrict__ q, int q_dtype,
                  const TKV* __restrict__ kc, const TKV* __restrict__ vc,
                  const int* __restrict__ tables, int64_t table_stride,
                  const int* __restrict__ lens,
                  const float* __restrict__ scales, void* __restrict__ out,
                  int d, int block_size, int max_blocks, float sm_scale) {
  constexpr int VEC = 16 / (int)sizeof(TKV);
  constexpr int TPW = 32 / G;  // tokens a warp reads at once
  constexpr bool kQuant = sizeof(TKV) == 1;
  constexpr bool kRoundP = sizeof(TKV) == 2;

  __shared__ float s_p[kWarps][kMaxBlockSize];
  __shared__ float s_acc[kWarps][kMaxDim];
  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];

  const int row = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / G;  // which token of the TPW in flight
  const int gl = lane % G;   // lane inside the token's group
  const int nv = d / VEC;    // 16-byte vectors in a row

  const int len = min(lens[row], max_blocks * block_size);
  const int nblk = (len + block_size - 1) / block_size;
  const int64_t block_elems = (int64_t)block_size * d;

  // q for this lane's columns, in fp32
  float qf[NPL][VEC];
#pragma unroll
  for (int c = 0; c < NPL; ++c) {
    const int col = (gl + c * G) * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float x = 0.f;
      if (col < d) {
        const int64_t at = (int64_t)row * d + col + i;
        x = q_dtype == kF32
                ? static_cast<const float*>(q)[at]
                : __bfloat162float(static_cast<const __nv_bfloat16*>(q)[at]);
      }
      qf[c][i] = x;
    }
  }

  float m = kNegInf, l = 0.f;
  float acc[NPL][VEC];
#pragma unroll
  for (int c = 0; c < NPL; ++c)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[c][i] = 0.f;

  for (int j = warp; j < nblk; j += kWarps) {
    const int bid = tables[(int64_t)row * table_stride + j];
    const int nt = min(block_size, len - j * block_size);  // live tokens
    const TKV* kb = kc + (int64_t)bid * block_elems;
    const TKV* vb = vc + (int64_t)bid * block_elems;
    float ks = 1.f, vs = 1.f;
    if (kQuant) {
      ks = scales[2 * bid];
      vs = scales[2 * bid + 1];
    }

    // scores of the block's live tokens
    float bmax = kNegInf;
    for (int t0 = 0; t0 < nt; t0 += TPW * kUnroll) {
      uint4 raw[kUnroll][NPL];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * TPW + grp;
#pragma unroll
        for (int c = 0; c < NPL; ++c) {
          const int vi = gl + c * G;
          raw[u][c] = (t < nt && vi < nv)
                          ? *reinterpret_cast<const uint4*>(
                                kb + (int64_t)t * d + vi * VEC)
                          : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < NPL; ++c) {
          float kf[VEC];
          unpack16(raw[u][c], kf, TKV());
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            dot += qf[c][i] * (kQuant ? kf[i] * ks : kf[i]);
        }
        dot = group_sum<G>(dot);
        const int t = t0 + u * TPW + grp;
        if (t < nt) {
          const float sc = dot * sm_scale;
          if (gl == 0) s_p[warp][t] = sc;
          bmax = fmaxf(bmax, sc);
        }
      }
    }
    bmax = warp_max(bmax);
    __syncwarp();

    const float m_new = fmaxf(m, bmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    for (int t = lane; t < nt; t += 32) {
      const float p = expf(s_p[warp][t] - m_new);
      s_p[warp][t] = p;
      psum += p;
    }
    l = l * alpha + warp_sum(psum);
    m = m_new;
    __syncwarp();
#pragma unroll
    for (int c = 0; c < NPL; ++c)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[c][i] *= alpha;

    // acc += p . V over the block's live tokens
    for (int t0 = 0; t0 < nt; t0 += TPW * kUnroll) {
      uint4 raw[kUnroll][NPL];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * TPW + grp;
#pragma unroll
        for (int c = 0; c < NPL; ++c) {
          const int vi = gl + c * G;
          raw[u][c] = (t < nt && vi < nv)
                          ? *reinterpret_cast<const uint4*>(
                                vb + (int64_t)t * d + vi * VEC)
                          : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * TPW + grp;
        if (t < nt) {
          float p = s_p[warp][t];
          if (kRoundP) p = __bfloat162float(__float2bfloat16_rn(p));
#pragma unroll
          for (int c = 0; c < NPL; ++c) {
            float vf[VEC];
            unpack16(raw[u][c], vf, TKV());
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              acc[c][i] += p * (kQuant ? vf[i] * vs : vf[i]);
          }
        }
      }
    }
    __syncwarp();  // s_p is rewritten by the warp's next block
  }

  // sum the groups' partial accumulators (same m, l across the warp)
#pragma unroll
  for (int off = G; off < 32; off <<= 1)
#pragma unroll
    for (int c = 0; c < NPL; ++c)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[c][i] += __shfl_xor_sync(0xffffffffu, acc[c][i], off);
  if (grp == 0) {
#pragma unroll
    for (int c = 0; c < NPL; ++c) {
      const int col = (gl + c * G) * VEC;
      if (col < d) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) s_acc[warp][col + i] = acc[c][i];
      }
    }
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  __syncthreads();

  // merge the warps' states in warp order
  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w]);
  float lt = 0.f;
  float f[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    f[w] = expf(s_m[w] - mx);
    lt += s_l[w] * f[w];
  }
  const float den = fmaxf(lt, 1e-30f);
  for (int e = threadIdx.x; e < d; e += kWarps * 32) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += s_acc[w][e] * f[w];
    const float r = a / den;
    const int64_t at = (int64_t)row * d + e;
    if (q_dtype == kF32)
      static_cast<float*>(out)[at] = r;
    else
      static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(r);
  }
}

template <typename TKV, int G, int NPL>
void launch_one(const void* q, int q_dtype, const void* k, const void* v,
                const int* tables, int64_t table_stride, const int* lens,
                const float* scales, void* out, int num_seqs, int d,
                int block_size, int max_blocks, float sm_scale,
                cudaStream_t stream) {
  paged_attn_kernel<TKV, G, NPL><<<num_seqs, kWarps * 32, 0, stream>>>(
      q, q_dtype, static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      tables, table_stride, lens, scales, out, d, block_size, max_blocks,
      sm_scale);
}

// Pick the lane group for d values of TKV: G lanes of 16 bytes each cover a
// row (the smallest power of two >= d * sizeof(TKV) / 16), two vectors a
// lane past 32 of them.
template <typename TKV>
int launch_kv(const void* q, int q_dtype, const void* k, const void* v,
              const int* tables, int64_t table_stride, const int* lens,
              const float* scales, void* out, int num_seqs, int d,
              int block_size, int max_blocks, float sm_scale,
              cudaStream_t s) {
  const int nv = d * (int)sizeof(TKV) / 16;
#define PA_ARGS q, q_dtype, k, v, tables, table_stride, lens, scales, out, \
                num_seqs, d, block_size, max_blocks, sm_scale, s
  if (nv <= 2)
    launch_one<TKV, 2, 1>(PA_ARGS);
  else if (nv <= 4)
    launch_one<TKV, 4, 1>(PA_ARGS);
  else if (nv <= 8)
    launch_one<TKV, 8, 1>(PA_ARGS);
  else if (nv <= 16)
    launch_one<TKV, 16, 1>(PA_ARGS);
  else if (nv <= 32)
    launch_one<TKV, 32, 1>(PA_ARGS);
  else if (nv <= 64)
    launch_one<TKV, 32, 2>(PA_ARGS);
  else
    return (int)cudaErrorInvalidValue;
#undef PA_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_attention(const void* q, const void* k, const void* v,
                               const void* tables, const void* lens,
                               const void* scales, void* out, int num_seqs,
                               int d, int block_size, int max_blocks,
                               int64_t table_stride, float sm_scale,
                               int q_dtype, int kv_dtype, void* stream) {
  if (num_seqs <= 0 || d <= 0 || d % 32 != 0 || d > kMaxDim ||
      block_size < 1 || block_size > kMaxBlockSize || max_blocks < 0 ||
      (q_dtype != kF32 && q_dtype != kBF16) ||
      (kv_dtype == kI8 && scales == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lens);
  const float* sc = static_cast<const float*>(scales);
  switch (kv_dtype) {
    case kF32:
      return launch_kv<float>(q, q_dtype, k, v, tb, table_stride, ln, sc, out,
                              num_seqs, d, block_size, max_blocks, sm_scale,
                              s);
    case kBF16:
      return launch_kv<__nv_bfloat16>(q, q_dtype, k, v, tb, table_stride, ln,
                                      sc, out, num_seqs, d, block_size,
                                      max_blocks, sm_scale, s);
    case kI8:
      return launch_kv<int8_t>(q, q_dtype, k, v, tb, table_stride, ln, sc,
                               out, num_seqs, d, block_size, max_blocks,
                               sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
