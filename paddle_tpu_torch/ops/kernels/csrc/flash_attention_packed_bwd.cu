// Packed-layout flash-attention backward for sm_90a.
//
// Replaces the Pallas backward paddle_tpu/ops/pallas/flash_attention_packed.py
// `_backward` (line 246): `_bwd_dkdv_kernel` (dK, dV over key tiles) and
// `_bwd_dq_kernel` (dQ over query tiles).  Inputs are read straight out of
// the (batch, seq, heads * head_dim) projection layout, with the forward's
// fp32 (batch, heads, seq) log-sum-exp and its (batch, seq) key bias.
//
// Numerics follow the Pallas kernels: P = exp(s - lse) with
// s = (q.k) * sm_scale + bias, unrounded; causal and past-the-end positions
// give P = 0.  With dropout (the position hash of dropout_hash.cuh, keyed as
// in the forward, so the mask is replayed exactly):
//   dV += (P * keep / (1 - rate)), rounded to dO's type, times dO;
//   dP  = dO V^T in fp32, then * keep / (1 - rate);
//   dS  = P * (dP - delta) * sm_scale, delta = rowsum(dO * O) in fp32;
//   dK += dS (rounded to q's type) times Q;  dQ += dS (rounded) times K.
// The bias gets no gradient.
//
// What bounds it on the H100.  At the ERNIE-base shape (b 8, s 512, h 12,
// d 64, bf16) the work is at least 10 b h s^2 d = 16.1 GFLOP (S recomputed
// once; this design recomputes it twice, 14 b h s^2 d), 16 us at 989 TF/s,
// against ~50 MB of q, k, v, o, dO read and dq, dk, dv written, 15 us at
// 3.35 TB/s: both bounds are close, so the kernels have to keep the tensor
// cores fed.  In fp32 the CUDA cores bound it (67 TF/s, 0.24 ms).
//
// Design, three launches on one stream:
//   1. delta pre-pass: one warp per (token, head) sums dO * O in fp32 into a
//      (batch, heads, seq) scratch the wrapper allocates;
//   2. dK/dV: one block of 128 threads per (64-key tile, head, batch), a loop
//      over query tiles;
//   3. dQ: one block per (64-query tile, head, batch), a loop over key tiles.
// 2 and 3 are one template: a block owns 64 "rows" (keys, or queries) and
// walks "column" tiles (queries, or keys); both compute S and dP for the
// tile, so each S is recomputed twice in all, as in the Pallas design, and
// no sum crosses blocks (no atomics: the result is the same run to run).
//   * bf16: S, dP and the dV/dK/dQ products on the tensor cores with
//     mma.sync m16n8k16; each warp owns 16 rows, so S, P, dP and dS stay in
//     registers and become the A fragments of the next product as they are
//     rounded to bf16; operands come from padded shared tiles by ldmatrix.
//     Column tiles are 64 wide for d 64 and 32 for d 128 (registers).
//   * fp32: register-tiled FMAs on the CUDA cores (the tensor cores would
//     round fp32 to TF32), dropped P and dS through shared memory.
// Not yet done: one fused kernel that recomputes S once (FA2 with a dQ
// reduction), cp.async/TMA double buffering, wgmma.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; the entry returns cudaGetLastError() after the last launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "mma_bf16.cuh"
#include "vec.cuh"

namespace {

using dropout_hash::Params;

constexpr int kThreads = 128;
constexpr int kBR = 64;  // rows per block: keys (dK/dV) or queries (dQ)

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;   // (batch, seq)
  const void* o;
  const void* dout;
  const float* lse;    // (batch, heads, seq)
  float* delta;        // (batch, heads, seq), written by the pre-pass
  void* dq;
  void* dk;
  void* dv;
  int seq;
  int heads;
  float sm_scale;
  int causal;
  Params drop;
};

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O) per (batch, head, position), in fp32.

template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(BwdArgs a, int64_t rows) {
  const int64_t w = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= rows) return;
  const int h = (int)(w % a.heads);
  const int64_t tok = w / a.heads;  // batch * seq + position
  const int64_t off = tok * a.heads * D + (int64_t)h * D;
  const T* o = static_cast<const T*>(a.o) + off;
  const T* d = static_cast<const T*>(a.dout) + off;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc += to_float(o[c]) * to_float(d[c]);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int64_t b = tok / a.seq;
    a.delta[(b * a.heads + h) * a.seq + tok % a.seq] = acc;
  }
}

// Where a block's column tiles start and end: dK/dV (rows = keys) skips the
// query tiles wholly before its first key when causal; dQ (rows = queries)
// stops after the key tile of its last query.
template <bool KV>
__device__ __forceinline__ void column_range(int r0, int bc, int seq,
                                             int causal, int& begin,
                                             int& end) {
  const int n = (seq + bc - 1) / bc;
  begin = 0;
  end = n;
  if (!causal) return;
  if (KV) {
    begin = r0 / bc;
  } else {
    const int last = min(r0 + kBR, seq) - 1;
    end = min(n, last / bc + 1);
  }
}

// P, dropped P and dS of one score element.  `row`/`col` are the block's
// global row and column indices; KV: row = key, col = query.
template <bool KV>
__device__ __forceinline__ void grad_element(const BwdArgs& a, uint32_t bh,
                                             int row, int col, float s,
                                             float dp, float bias_v,
                                             float lse_v, float delta_v,
                                             float& pd, float& ds) {
  const int key = KV ? row : col;
  const int query = KV ? col : row;
  float p = expf(s * a.sm_scale + bias_v - lse_v);
  if ((a.causal && query < key) || query >= a.seq || key >= a.seq) p = 0.f;
  pd = p;
  if (a.drop.on) {
    const bool kept = dropout_hash::keep(a.drop.seed, bh, query, key,
                                         a.drop.threshold);
    pd = kept ? p * a.drop.scale : 0.f;
    dp = kept ? dp * a.drop.scale : 0.f;
  }
  ds = p * (dp - delta_v) * a.sm_scale;
}

// Per-row and per-column fp32 values of the tiles: the key bias on the key
// side, lse and delta on the query side.
__device__ __forceinline__ void load_side_values(const BwdArgs& a, int b,
                                                 int h, int i0, int n,
                                                 bool key_side, float* v1,
                                                 float* v2) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int pos = i0 + i;
    const bool in = pos < a.seq;
    if (key_side) {
      v1[i] = in ? a.bias[(int64_t)b * a.seq + pos] : 0.f;
    } else {
      const int64_t idx = ((int64_t)b * a.heads + h) * a.seq + pos;
      v1[i] = in ? a.lse[idx] : 0.f;
      v2[i] = in ? a.delta[idx] : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// 2/3, fp32: register-tiled FMAs.  Thread (ty, tx) = (tid / 8, tid % 8) owns
// rows 4 ty + i of the 64-row block; S/dP columns tx + 8 j; output columns
// 4 tx + 32 j + e.

constexpr int kBC32 = 64;  // column tile of the fp32 kernels

template <int D>
struct Fp32Tile {
  static constexpr int kLd = D + 4;        // row stride of q/k/v/dO tiles
  static constexpr int kLdS = kBC32 + 4;   // row stride of the P / dS tiles
  static constexpr int kFloats =
      (2 * kBR + 2 * kBC32) * kLd + 2 * kBR * kLdS + 2 * kBR + 2 * kBC32;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int64_t brow, int row0, int rows,
                                              int seq, int packed, int h) {
  constexpr int kPerRow = D / 4;
  constexpr int ld = Fp32Tile<D>::kLd;
  for (int c = threadIdx.x; c < rows * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < seq)
      val = *reinterpret_cast<const float4*>(
          src + (brow + row0 + r) * packed + h * D + col);
    *reinterpret_cast<float4*>(dst + r * ld + col) = val;
  }
}

// grid = (ceil(seq / 64), heads, batch).  KV: rows = keys (K, V), columns =
// queries (Q, dO); else rows = queries (Q, dO), columns = keys (K, V).
template <int D, bool KV>
__global__ void __launch_bounds__(kThreads) flash_bwd_fp32_kernel(BwdArgs a) {
  using L = Fp32Tile<D>;
  constexpr int ld = L::kLd;
  constexpr int lds = L::kLdS;
  constexpr int NJ = D / 32;
  extern __shared__ float4 smem4[];
  float* RA = reinterpret_cast<float*>(smem4);  // K or Q
  float* RC = RA + kBR * ld;                     // V or dO
  float* CB = RC + kBR * ld;                     // Q or K
  float* CD = CB + kBC32 * ld;                   // dO or V
  float* PS = CD + kBC32 * ld;                   // dropped P (KV)
  float* DS = PS + kBR * lds;                    // dS
  float* rv1 = DS + kBR * lds;                   // bias (KV) or lse
  float* rv2 = rv1 + kBR;                        // delta (dQ)
  float* cv1 = rv2 + kBR;                        // lse (KV) or bias
  float* cv2 = cv1 + kBC32;                      // delta (KV)

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int r0 = blockIdx.x * kBR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int packed = a.heads * D;
  const int64_t brow = (int64_t)b * a.seq;
  const uint32_t bh = (uint32_t)(b * a.heads + h);

  load_tile_f32<D>(RA, KV ? k : q, brow, r0, kBR, a.seq, packed, h);
  load_tile_f32<D>(RC, KV ? v : dout, brow, r0, kBR, a.seq, packed, h);
  load_side_values(a, b, h, r0, kBR, KV, rv1, rv2);

  float acc1[4][NJ * 4];  // dK or dQ
  float acc2[4][NJ * 4];  // dV
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NJ * 4; ++c) acc1[i][c] = acc2[i][c] = 0.f;

  int begin, end;
  column_range<KV>(r0, kBC32, a.seq, a.causal, begin, end);
  for (int ct = begin; ct < end; ++ct) {
    const int c0 = ct * kBC32;
    __syncthreads();  // the previous tile's products are done
    load_tile_f32<D>(CB, KV ? q : k, brow, c0, kBC32, a.seq, packed, h);
    load_tile_f32<D>(CD, KV ? dout : v, brow, c0, kBC32, a.seq, packed, h);
    load_side_values(a, b, h, c0, kBC32, !KV, cv1, cv2);
    __syncthreads();

    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 ra[4], rc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ra[i] = *reinterpret_cast<const float4*>(RA + (ty * 4 + i) * ld + d);
        rc[i] = *reinterpret_cast<const float4*>(RC + (ty * 4 + i) * ld + d);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 cb =
            *reinterpret_cast<const float4*>(CB + (tx + 8 * j) * ld + d);
        const float4 cd =
            *reinterpret_cast<const float4*>(CD + (tx + 8 * j) * ld + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(ra[i].x, cb.x, s[i][j]);
          s[i][j] = fmaf(ra[i].y, cb.y, s[i][j]);
          s[i][j] = fmaf(ra[i].z, cb.z, s[i][j]);
          s[i][j] = fmaf(ra[i].w, cb.w, s[i][j]);
          dp[i][j] = fmaf(rc[i].x, cd.x, dp[i][j]);
          dp[i][j] = fmaf(rc[i].y, cd.y, dp[i][j]);
          dp[i][j] = fmaf(rc[i].z, cd.z, dp[i][j]);
          dp[i][j] = fmaf(rc[i].w, cd.w, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 8 * j;
        float pd, ds;
        grad_element<KV>(a, bh, r0 + r, c0 + c, s[i][j], dp[i][j],
                         KV ? rv1[r] : cv1[c], KV ? cv1[c] : rv1[r],
                         KV ? cv2[c] : rv2[r], pd, ds);
        if (KV) PS[r * lds + c] = pd;
        DS[r * lds + c] = ds;
      }
    }
    __syncthreads();

    // acc1 += dS . CB (dK += dS^T Q, dQ += dS K); acc2 += P_d . CD (dV).
#pragma unroll 4
    for (int cc = 0; cc < kBC32; ++cc) {
      float dsv[4], pdv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dsv[i] = DS[(ty * 4 + i) * lds + cc];
        pdv[i] = KV ? PS[(ty * 4 + i) * lds + cc] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 cb =
            *reinterpret_cast<const float4*>(CB + cc * ld + tx * 4 + 32 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc1[i][4 * j + 0] = fmaf(dsv[i], cb.x, acc1[i][4 * j + 0]);
          acc1[i][4 * j + 1] = fmaf(dsv[i], cb.y, acc1[i][4 * j + 1]);
          acc1[i][4 * j + 2] = fmaf(dsv[i], cb.z, acc1[i][4 * j + 2]);
          acc1[i][4 * j + 3] = fmaf(dsv[i], cb.w, acc1[i][4 * j + 3]);
        }
        if (KV) {
          const float4 cd =
              *reinterpret_cast<const float4*>(CD + cc * ld + tx * 4 + 32 * j);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc2[i][4 * j + 0] = fmaf(pdv[i], cd.x, acc2[i][4 * j + 0]);
            acc2[i][4 * j + 1] = fmaf(pdv[i], cd.y, acc2[i][4 * j + 1]);
            acc2[i][4 * j + 2] = fmaf(pdv[i], cd.z, acc2[i][4 * j + 2]);
            acc2[i][4 * j + 3] = fmaf(pdv[i], cd.w, acc2[i][4 * j + 3]);
          }
        }
      }
    }
  }

  float* out1 = static_cast<float*>(KV ? a.dk : a.dq);
  float* out2 = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= a.seq) continue;
    const int64_t base = (brow + r) * packed + h * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx * 4 + 32 * j;
      *reinterpret_cast<float4*>(out1 + base + col) =
          make_float4(acc1[i][4 * j], acc1[i][4 * j + 1], acc1[i][4 * j + 2],
                      acc1[i][4 * j + 3]);
      if (KV)
        *reinterpret_cast<float4*>(out2 + base + col) =
            make_float4(acc2[i][4 * j], acc2[i][4 * j + 1],
                        acc2[i][4 * j + 2], acc2[i][4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 2/3, bf16: mma.sync m16n8k16.  Warp w owns rows 16 w .. 16 w + 15; a lane
// holds rows g and g + 8 of them (g = lane / 4) and columns 2 t, 2 t + 1 of
// each 8-column n-tile (t = lane % 4).

template <int D>
struct MmaTile {
  static constexpr int kBC = D <= 64 ? 64 : 32;  // column tile
  static constexpr int kLd = D + 8;              // bf16 row stride (pad 16 B)
  static constexpr size_t kBytes =
      sizeof(__nv_bfloat16) * (size_t)(2 * kBR + 2 * kBC) * kLd +
      sizeof(float) * (2 * kBR + 2 * kBC);
};

template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int64_t brow, int row0,
                                               int rows, int seq, int packed,
                                               int h) {
  constexpr int kPerRow = D / 8;
  constexpr int ld = MmaTile<D>::kLd;
  for (int c = threadIdx.x; c < rows * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq)
      val = *reinterpret_cast<const uint4*>(
          src + (brow + row0 + r) * packed + h * D + col);
    *reinterpret_cast<uint4*>(dst + r * ld + col) = val;
  }
}

// acc (16 rows x D) += X (16 rows x BC, fp32 C fragments, rounded to bf16
// here) times the BC x D shared tile `tile`.
template <int D, int BC>
__device__ __forceinline__ void acc_product(float (*acc)[4], float (*x)[4],
                                            const __nv_bfloat16* tile,
                                            int lane) {
  constexpr int ld = MmaTile<D>::kLd;
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk) {
    uint32_t af[4];
    af[0] = mma_bf16::pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    af[1] = mma_bf16::pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    af[2] = mma_bf16::pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    af[3] = mma_bf16::pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t bf[4];
      mma_bf16::load_b(bf, tile, ld, kk * 16, n * 8, lane);
      mma_bf16::mma(acc[n], af, bf[0], bf[1]);
      mma_bf16::mma(acc[n + 1], af, bf[2], bf[3]);
    }
  }
}

template <int D, bool KV>
__global__ void __launch_bounds__(kThreads) flash_bwd_mma_kernel(BwdArgs a) {
  using L = MmaTile<D>;
  constexpr int BC = L::kBC;
  constexpr int ld = L::kLd;
  constexpr int NT = BC / 8;  // 8-column n-tiles of S and dP
  constexpr int KD = D / 16;  // 16-deep k-steps over the head dim
  constexpr int ND = D / 8;   // 8-column n-tiles of the outputs
  extern __shared__ float4 smem4[];
  __nv_bfloat16* RA = reinterpret_cast<__nv_bfloat16*>(smem4);  // K or Q
  __nv_bfloat16* RC = RA + kBR * ld;                             // V or dO
  __nv_bfloat16* CB = RC + kBR * ld;                             // Q or K
  __nv_bfloat16* CD = CB + BC * ld;                              // dO or V
  float* rv1 = reinterpret_cast<float*>(CD + BC * ld);
  float* rv2 = rv1 + kBR;
  float* cv1 = rv2 + kBR;
  float* cv2 = cv1 + BC;

  using T = __nv_bfloat16;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = blockIdx.x * kBR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int packed = a.heads * D;
  const int64_t brow = (int64_t)b * a.seq;
  const uint32_t bh = (uint32_t)(b * a.heads + h);

  load_tile_bf16<D>(RA, KV ? k : q, brow, r0, kBR, a.seq, packed, h);
  load_tile_bf16<D>(RC, KV ? v : dout, brow, r0, kBR, a.seq, packed, h);
  load_side_values(a, b, h, r0, kBR, KV, rv1, rv2);

  float acc1[ND][4];  // dK or dQ
  float acc2[ND][4];  // dV
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[n][e] = acc2[n][e] = 0.f;

  int begin, end;
  column_range<KV>(r0, BC, a.seq, a.causal, begin, end);
  for (int ct = begin; ct < end; ++ct) {
    const int c0 = ct * BC;
    __syncthreads();  // every warp is done with the previous column tile
    load_tile_bf16<D>(CB, KV ? q : k, brow, c0, BC, a.seq, packed, h);
    load_tile_bf16<D>(CD, KV ? dout : v, brow, c0, BC, a.seq, packed, h);
    load_side_values(a, b, h, c0, BC, !KV, cv1, cv2);
    __syncthreads();

    // S = RA CB^T and dP = RC CD^T for the warp's 16 rows.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t af[4], cf[4];
      mma_bf16::load_a(af, RA, ld, warp * 16, kk * 16, lane);
      mma_bf16::load_a(cf, RC, ld, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bf[4];
        mma_bf16::load_b_t(bf, CB, ld, n * 8, kk * 16, lane);
        mma_bf16::mma(s[n], af, bf[0], bf[1]);
        mma_bf16::mma(s[n + 1], af, bf[2], bf[3]);
        mma_bf16::load_b_t(bf, CD, ld, n * 8, kk * 16, lane);
        mma_bf16::mma(dp[n], cf, bf[0], bf[1]);
        mma_bf16::mma(dp[n + 1], cf, bf[2], bf[3]);
      }
    }

    // s becomes the dropped P, dp becomes dS.
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = warp * 16 + g + (e >> 1) * 8;
        const int c = n * 8 + 2 * t + (e & 1);
        float pd, ds;
        grad_element<KV>(a, bh, r0 + r, c0 + c, s[n][e], dp[n][e],
                         KV ? rv1[r] : cv1[c], KV ? cv1[c] : rv1[r],
                         KV ? cv2[c] : rv2[r], pd, ds);
        s[n][e] = pd;
        dp[n][e] = ds;
      }
    }
    acc_product<D, BC>(acc1, dp, CB, lane);        // dK += dS^T Q / dQ += dS K
    if (KV) acc_product<D, BC>(acc2, s, CD, lane);  // dV += P_d^T dO
  }

  T* out1 = static_cast<T*>(KV ? a.dk : a.dq);
  T* out2 = static_cast<T*>(a.dv);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + warp * 16 + g + half * 8;
    if (r >= a.seq) continue;
    const int64_t base = (brow + r) * packed + h * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(out1 + base + n * 8) =
          __floats2bfloat162_rn(acc1[n][2 * half], acc1[n][2 * half + 1]);
      if (KV)
        *reinterpret_cast<__nv_bfloat162*>(out2 + base + n * 8) =
            __floats2bfloat162_rn(acc2[n][2 * half], acc2[n][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// Set `kernel`'s dynamic shared-memory limit once (`done` is a static of the
// caller's instantiation, so a CUDA graph can capture later launches), then
// launch it on the (row tile, head, batch) grid.
template <typename Kernel>
int launch_grid(Kernel kernel, size_t smem, bool& done, const BwdArgs& a,
                int batch, cudaStream_t stream) {
  if (!done) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    done = true;
  }
  const dim3 grid((unsigned)((a.seq + kBR - 1) / kBR), (unsigned)a.heads,
                  (unsigned)batch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const BwdArgs& a, int batch, cudaStream_t stream) {
  const int64_t rows = (int64_t)batch * a.seq * a.heads;
  flash_bwd_delta_kernel<T, D>
      <<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(a, rows);
  int err = (int)cudaGetLastError();
  if (err) return err;
  static bool kv_done = false, dq_done = false;
  if constexpr (sizeof(T) == 4) {
    err = launch_grid(flash_bwd_fp32_kernel<D, true>, Fp32Tile<D>::kBytes,
                      kv_done, a, batch, stream);
    if (err) return err;
    return launch_grid(flash_bwd_fp32_kernel<D, false>, Fp32Tile<D>::kBytes,
                       dq_done, a, batch, stream);
  }
  err = launch_grid(flash_bwd_mma_kernel<D, true>, MmaTile<D>::kBytes,
                    kv_done, a, batch, stream);
  if (err) return err;
  return launch_grid(flash_bwd_mma_kernel<D, false>, MmaTile<D>::kBytes,
                     dq_done, a, batch, stream);
}

}  // namespace

extern "C" int flash_attention_packed_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* out, const void* dout, const void* lse, void* delta, void* dq,
    void* dk, void* dv, int batch, int seq, int heads, int head_dim,
    float sm_scale, int causal, uint32_t seed, uint32_t threshold,
    float keep_scale, int dropout, int dtype, void* stream) {
  const BwdArgs a{q, k, v, static_cast<const float*>(bias), out, dout,
                  static_cast<const float*>(lse), static_cast<float*>(delta),
                  dq, dk, dv, seq, heads, sm_scale, causal,
                  Params{seed, threshold, keep_scale, dropout}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && head_dim == 64) return launch<float, 64>(a, batch, s);
  if (dtype == kF32 && head_dim == 128) return launch<float, 128>(a, batch, s);
  if (dtype == kBF16 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(a, batch, s);
  if (dtype == kBF16 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}
