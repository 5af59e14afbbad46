// Packed-layout flash-attention forward for sm_90a.
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas/flash_attention_packed.py
// `_forward` (line 212, kernel `_fwd_kernel`): online-softmax attention read
// straight out of the (batch, seq, heads * head_dim) projection layout, with
// an additive fp32 (batch, seq) key bias, optional causal masking, and the
// per-row log-sum-exp written for the backward.  Dropout is not here yet: the
// wrapper refuses a rate above 0.
//
// Layout change from the TPU kernel: LSE is fp32 (batch, heads, seq), not
// (batch, head_pairs, heads_per_pair, seq).  The 128-lane head pairing was a
// TPU tiling constraint; here a head is found by its column offset h * d.
//
// Numerics follow the Pallas kernel: QK^T and PV take their operands in the
// input type (bf16 products are exact in fp32) and sum in fp32; scores are
// s = (q.k) * sm_scale + bias in fp32; the softmax statistics m and l are
// fp32; P is rounded to the input type before the PV product while l sums
// the unrounded P; out = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30)).
// Masked (causal) scores are -1e30 as in the TPU kernel; key positions past
// the end of a ragged sequence are dropped (exp gives exactly 0).
//
// What bounds it on the H100.  At the ERNIE-base shape (b 8, s 512, h 12,
// d 64) the least time is set by bytes in bf16 (25 MB of q, k, v and o at
// 3.35 TB/s, 7.5 us, against 6.4 GFLOP at 989 TF/s, 6.5 us) and by
// operations in fp32 (67 TF/s outside the tensor cores, 96 us).  Either
// way the kernel has to keep the arithmetic units busy while it streams
// K/V, and re-reads K/V once per 64-row query tile (from L2).
//
// Design: one block of 128 threads per (64-row query tile, head, batch),
// a loop over 64-row K/V tiles with the online softmax, no materialised
// score matrix.  Two paths:
//   * bf16: QK^T and PV on the tensor cores with mma.sync m16n8k16 (see
//     flash_fwd_mma_kernel below);
//   * fp32: register-tiled fp32 FMAs on the CUDA cores (the tensor cores
//     would round fp32 operands to TF32): Q, K, V staged in shared memory
//     as fp32, each thread a 4 x 8 tile of S and a 4 x d/8 tile of O, the
//     score tile through shared memory for the row softmax.
// Not yet done: cp.async/TMA double buffering of K/V and wgmma.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; the entry returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // key rows per K/V tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF

template <int D>
struct Tile {
  static constexpr int kLd = D + 4;        // fp32 row stride of Q/K/V tiles
  static constexpr int kLdS = kBK + 4;     // fp32 row stride of the S tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kLd;
  static constexpr int kV = kK + kBK * kLd;
  static constexpr int kS = kV + kBK * kLd;
  static constexpr int kBias = kS + kBQ * kLdS;
  static constexpr int kAlpha = kBias + kBK;
  static constexpr int kL = kAlpha + kBQ;
  static constexpr int kFloats = kL + kBQ;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// Copy rows [row0, row0 + rows) of head h out of the packed tensor into an
// fp32 shared tile with row stride ld; rows past seq are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int64_t batch_row0, int row0,
                                          int rows, int seq, int packed,
                                          int h) {
  constexpr int kPerRow = D / 4;  // 16-byte chunks per row
  constexpr int ld = Tile<D>::kLd;
  for (int c = threadIdx.x; c < rows * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < seq)
      val = *reinterpret_cast<const float4*>(
          src + (batch_row0 + row0 + r) * packed + h * D + col);
    *reinterpret_cast<float4*>(dst + r * ld + col) = val;
  }
}

// fp32 inputs: grid = (ceil(seq / 64), heads, batch), block = 128 threads.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fp32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ bias,
                      float* __restrict__ out, float* __restrict__ lse,
                      int seq, int heads, float sm_scale, int causal) {
  using L = Tile<D>;
  constexpr int ld = L::kLd;
  constexpr int lds = L::kLdS;
  constexpr int NJ = D / 32;  // float4 column groups of O per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem + L::kQ;
  float* Ks = smem + L::kK;
  float* Vs = smem + L::kV;
  float* Ss = smem + L::kS;
  float* Bs = smem + L::kBias;
  float* As = smem + L::kAlpha;
  float* Ls = smem + L::kL;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int packed = heads * D;
  const int64_t brow = (int64_t)b * seq;

  // Register tiles: rows ty*4 + i of the block; S columns tx + 8*j; O
  // columns tx*4 + 32*j + e.
  const int ty = tid >> 3;
  const int tx = tid & 7;
  // Softmax ownership: row tid/2, columns 2*jj + half.
  const int srow = tid >> 1;
  const int half = tid & 1;
  float m_i = kNegInf;
  float l_i = 0.f;

  float o[4][NJ * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NJ * 4; ++c) o[i][c] = 0.f;

  load_tile<D>(Qs, q, brow, q0, kBQ, seq, packed, h);

  int num_kv = (seq + kBK - 1) / kBK;
  if (causal) {
    const int last = min(q0 + kBQ, seq) - 1;  // last query row of the tile
    num_kv = min(num_kv, last / kBK + 1);
  }

  for (int kt = 0; kt < num_kv; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's PV product is done with Ks/Vs/Ss
    load_tile<D>(Ks, k, brow, k0, kBK, seq, packed, h);
    load_tile<D>(Vs, v, brow, k0, kBK, seq, packed, h);
    if (tid < kBK)
      Bs[tid] = (k0 + tid < seq) ? bias[brow + k0 + tid] : 0.f;
    __syncthreads();

    // S = Q K^T * scale + bias, masked.
    {
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * ld + d);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 kv =
              *reinterpret_cast<const float4*>(Ks + (tx + 8 * j) * ld + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float a = acc[i][j];
            a = fmaf(qv[i].x, kv.x, a);
            a = fmaf(qv[i].y, kv.y, a);
            a = fmaf(qv[i].z, kv.z, a);
            a = fmaf(qv[i].w, kv.w, a);
            acc[i][j] = a;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const int qpos = q0 + r;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tx + 8 * j;
          const int kpos = k0 + c;
          float s = acc[i][j] * sm_scale + Bs[c];
          if (causal && qpos < kpos) s = kNegInf;
          if (kpos >= seq) s = -INFINITY;
          Ss[r * lds + c] = s;
        }
      }
    }
    __syncthreads();

    // Online softmax over the tile's row; P replaces S.
    {
      float* srow_p = Ss + srow * lds;
      float mx = -INFINITY;
#pragma unroll 8
      for (int jj = 0; jj < kBK / 2; ++jj) mx = fmaxf(mx, srow_p[2 * jj + half]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_i, mx);
      const float alpha = expf(m_i - m_new);
      float sum = 0.f;
#pragma unroll 8
      for (int jj = 0; jj < kBK / 2; ++jj) {
        const float p = expf(srow_p[2 * jj + half] - m_new);
        sum += p;
        srow_p[2 * jj + half] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l_i = l_i * alpha + sum;
      m_i = m_new;
      if (half == 0) As[srow] = alpha;
    }
    __syncthreads();

    // O = O * alpha + P V.
    {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty * 4 + i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NJ * 4; ++c) o[i][c] *= a[i];
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = Ss[(ty * 4 + i) * lds + kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 vv =
              *reinterpret_cast<const float4*>(Vs + kk * ld + tx * 4 + 32 * j);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            o[i][4 * j + 0] = fmaf(p[i], vv.x, o[i][4 * j + 0]);
            o[i][4 * j + 1] = fmaf(p[i], vv.y, o[i][4 * j + 1]);
            o[i][4 * j + 2] = fmaf(p[i], vv.z, o[i][4 * j + 2]);
            o[i][4 * j + 3] = fmaf(p[i], vv.w, o[i][4 * j + 3]);
          }
        }
      }
    }
  }

  // Normalise and write O and LSE.
  const float l_safe = fmaxf(l_i, 1e-30f);
  if (half == 0) {
    Ls[srow] = l_safe;
    if (q0 + srow < seq)
      lse[((int64_t)b * heads + h) * seq + q0 + srow] = m_i + logf(l_safe);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= seq) continue;
    const float l = Ls[r];
    float* orow = out + (brow + q0 + r) * packed + h * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      *reinterpret_cast<float4*>(orow + tx * 4 + 32 * j) =
          make_float4(o[i][4 * j] / l, o[i][4 * j + 1] / l,
                      o[i][4 * j + 2] / l, o[i][4 * j + 3] / l);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the products on the tensor cores.
//
// Same block decomposition and numerics; the 64 x 64 score tile and the
// P V product run as mma.sync m16n8k16 (bf16 operands, fp32 accumulators).
// Each of the 4 warps owns 16 query rows, so S, P and O stay in registers
// and the row softmax needs only shuffles within a quad of lanes.  Q, K and
// V tiles sit in shared memory as bf16 rows padded by 16 bytes (conflict-
// free ldmatrix); the operand fragments come through ldmatrix (.trans for
// V).  P is rounded to bf16 when it is packed into the A fragments of the
// P V product; l sums the unrounded fp32 P.

template <int D>
struct MmaTile {
  static constexpr int kLd = D + 8;  // bf16 row stride (16-byte pad)
  static constexpr size_t kBytes =
      sizeof(__nv_bfloat16) * (size_t)(kBQ + 2 * kBK) * kLd +
      sizeof(float) * kBK;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + rows) of head h into a bf16 shared tile with row
// stride ld; rows past seq are zero.
template <int D>
__device__ __forceinline__ void load_tile_bf16(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
    int64_t batch_row0, int row0, int rows, int seq, int packed, int h) {
  constexpr int kPerRow = D / 8;  // 16-byte chunks per row
  constexpr int ld = MmaTile<D>::kLd;
  for (int c = threadIdx.x; c < rows * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq)
      val = *reinterpret_cast<const uint4*>(
          src + (batch_row0 + row0 + r) * packed + h * D + col);
    *reinterpret_cast<uint4*>(dst + r * ld + col) = val;
  }
}

// grid = (ceil(seq / 64), heads, batch), block = 128 threads (4 warps).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int seq, int heads, float sm_scale, int causal) {
  constexpr int ld = MmaTile<D>::kLd;
  constexpr int NT = kBK / 8;  // 8-key n-tiles of S
  constexpr int KD = D / 16;   // 16-wide k-steps over the head dim
  constexpr int ND = D / 8;    // 8-wide n-tiles of O
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Ks = Qs + kBQ * ld;
  __nv_bfloat16* Vs = Ks + kBK * ld;
  float* Bs = reinterpret_cast<float*>(Vs + kBK * ld);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row within 8
  const int t = lane & 3;   // fragment column pair
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int packed = heads * D;
  const int64_t brow = (int64_t)b * seq;
  // This thread's two query rows (fragment rows g and g + 8 of the warp).
  const int qrow0 = q0 + warp * 16 + g;
  const int qrow1 = qrow0 + 8;

  load_tile_bf16<D>(Qs, q, brow, q0, kBQ, seq, packed, h);
  __syncthreads();

  // Q fragments for the warp's 16 rows, kept for every K/V tile.
  uint32_t qf[KD][4];
  {
    const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldmatrix_x4(qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
                  Qs + r * ld + kk * 16 + (lane >> 4) * 8);
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of rows qrow0, qrow1
  float l0 = 0.f, l1 = 0.f;          // this thread's partial row sums

  int num_kv = (seq + kBK - 1) / kBK;
  if (causal) {
    const int last = min(q0 + kBQ, seq) - 1;
    num_kv = min(num_kv, last / kBK + 1);
  }

  for (int kt = 0; kt < num_kv; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D>(Ks, k, brow, k0, kBK, seq, packed, h);
    load_tile_bf16<D>(Vs, v, brow, k0, kBK, seq, packed, h);
    if (tid < kBK) Bs[tid] = (k0 + tid < seq) ? bias[brow + k0 + tid] : 0.f;
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys.
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        // matrices: (keys n*8.., dims lo), (n*8.., hi), (n*8+8.., lo), (hi)
        const int m = lane >> 3;
        const int key = n * 8 + (m >> 1) * 8 + (lane & 7);
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(b0, b1, b2, b3, Ks + key * ld + kk * 16 + (m & 1) * 8);
        mma_bf16(s[n], qf[kk], b0, b1);
        mma_bf16(s[n + 1], qf[kk], b2, b3);
      }
    }

    // Scale, bias, masks; the tile's row max.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        const int kpos = k0 + c;
        const int qpos = (e < 2) ? qrow0 : qrow1;
        float x = s[n][e] * sm_scale + Bs[c];
        if (causal && qpos < kpos) x = kNegInf;
        if (kpos >= seq) x = -INFINITY;
        s[n][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }

    // O += P V, P rounded to bf16 in the A fragments.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        // matrices: (keys lo, dims n*8..), (keys hi, n*8..), (lo, n*8+8..),
        // (hi, n*8+8..), transposed into B fragments
        const int m = lane >> 3;
        const int key = kk * 16 + (m & 1) * 8 + (lane & 7);
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3, Vs + key * ld + (n + (m >> 1)) * 8);
        mma_bf16(o[n], pf, b0, b1);
        mma_bf16(o[n + 1], pf, b2, b3);
      }
    }
  }

  // Row sums across the quad, then O / l and LSE.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
  if (t == 0) {
    float* lrow = lse + ((int64_t)b * heads + h) * seq;
    if (qrow0 < seq) lrow[qrow0] = m0 + logf(ls0);
    if (qrow1 < seq) lrow[qrow1] = m1 + logf(ls1);
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = h * D + n * 8 + 2 * t;
    if (qrow0 < seq)
      *reinterpret_cast<__nv_bfloat162*>(out + (brow + qrow0) * packed + col) =
          __floats2bfloat162_rn(o[n][0] / ls0, o[n][1] / ls0);
    if (qrow1 < seq)
      *reinterpret_cast<__nv_bfloat162*>(out + (brow + qrow1) * packed + col) =
          __floats2bfloat162_rn(o[n][2] / ls1, o[n][3] / ls1);
  }
}

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// Launch `kernel` with `smem` bytes of dynamic shared memory.  The
// attribute is set once per kernel (`smem_set` is a static of the caller's
// instantiation), so a CUDA graph can capture later launches.
template <typename T, typename Kernel>
int launch_with(Kernel kernel, size_t smem, bool& smem_set, const void* q,
                const void* k, const void* v, const void* bias, void* out,
                void* lse, int batch, int seq, int heads, float sm_scale,
                int causal, cudaStream_t stream) {
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid((unsigned)((seq + kBQ - 1) / kBQ), (unsigned)heads,
                  (unsigned)batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(out), static_cast<float*>(lse), seq, heads, sm_scale,
      causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, const void* bias,
                void* out, void* lse, int batch, int seq, int heads,
                float sm_scale, int causal, cudaStream_t stream) {
  static bool smem_set = false;
  return launch_with<float>(flash_fwd_fp32_kernel<D>, Tile<D>::kBytes,
                            smem_set, q, k, v, bias, out, lse, batch, seq,
                            heads, sm_scale, causal, stream);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* bias,
                void* out, void* lse, int batch, int seq, int heads,
                float sm_scale, int causal, cudaStream_t stream) {
  static bool smem_set = false;
  return launch_with<__nv_bfloat16>(flash_fwd_mma_kernel<D>,
                                    MmaTile<D>::kBytes, smem_set, q, k, v,
                                    bias, out, lse, batch, seq, heads,
                                    sm_scale, causal, stream);
}

}  // namespace

extern "C" int flash_attention_packed_fwd(const void* q, const void* k,
                                          const void* v, const void* bias,
                                          void* out, void* lse, int batch,
                                          int seq, int heads, int head_dim,
                                          float sm_scale, int causal,
                                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && head_dim == 64)
    return launch_fp32<64>(q, k, v, bias, out, lse, batch, seq, heads,
                           sm_scale, causal, s);
  if (dtype == kF32 && head_dim == 128)
    return launch_fp32<128>(q, k, v, bias, out, lse, batch, seq, heads,
                            sm_scale, causal, s);
  if (dtype == kBF16 && head_dim == 64)
    return launch_bf16<64>(q, k, v, bias, out, lse, batch, seq, heads,
                           sm_scale, causal, s);
  if (dtype == kBF16 && head_dim == 128)
    return launch_bf16<128>(q, k, v, bias, out, lse, batch, seq, heads,
                            sm_scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
