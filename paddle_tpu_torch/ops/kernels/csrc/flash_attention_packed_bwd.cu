// Flash-attention backward for sm_90a, in either head layout.
//
// Replaces two Pallas backwards that compute the same function on two
// layouts:
//   * paddle_tpu/ops/pallas/flash_attention_packed.py `_backward` (line
//     246): `_bwd_dkdv_kernel` (dK, dV over key tiles) and `_bwd_dq_kernel`
//     (dQ over query tiles), on the (batch, seq, heads * head_dim)
//     projection layout;
//   * paddle_tpu/ops/pallas/flash_attention.py `_flash_backward` (line 295):
//     delta = rowsum(dO * O), `_flash_bwd_dkdv_kernel` and
//     `_flash_bwd_dq_kernel`, on the (batch * heads, seq, head_dim) layout.
// The layouts differ only in their (batch, head, row) strides
// (attention_layout.cuh); the forward's fp32 (batch, heads, seq) log-sum-exp
// and its (batch, seq) key bias are the same in both.
//
// Numerics follow the Pallas kernels: P = exp(s - lse) with
// s = (q.k) * sm_scale + bias, unrounded; causal and past-the-end positions
// give P = 0.  With dropout (the position hash of dropout_hash.cuh, keyed as
// in the forward, so the mask is replayed exactly):
//   dV += (P * keep / (1 - rate)), rounded to dO's type, times dO;
//   dP  = dO V^T in fp32, then * keep / (1 - rate);
//   dS  = P * (dP - delta) * sm_scale, delta = rowsum(dO * O) in fp32;
//   dK += dS (rounded to q's type) times Q;  dQ += dS (rounded) times K.
// The bias gets no gradient.  The bf16 kernels take the exponential in base
// 2 (scores and LSE pre-multiplied by log2 e) with ex2.approx.ftz.
//
// What bounds it on the H100.  With S recomputed once the work is
// 10 b h s^2 d operations: 16.1 GFLOP at the ERNIE-base shape (b 8, s 512,
// h 12, d 64), 16 us at 989 TF/s, against ~50 MB of q, k, v, o, dO read and
// dq, dk, dv written, 15 us at 3.35 TB/s; at LLaMA-2-7B's causal s 4096
// d 128, 344 GFLOP, 0.35 ms.  Operations bound it.  In fp32 the CUDA cores
// bound it (67 TF/s, 0.24 ms at ERNIE-base).
//
// Design, three launches on one stream:
//   1. delta pre-pass: dO * O summed in fp32 over each (token, head) row,
//      read in 16-byte vectors (up to 32 / (d / 8) rows a warp in bf16),
//      into a (batch, heads, seq) scratch the wrapper allocates.
//   2. bf16: two warp-specialised wgmma kernels fed by TMA, like the
//      forward (flash_attention_packed_fwd.cu): CTAs of 384 threads,
//      warpgroup 0 the producer (TMA from 4-d tensor maps over (head_dim,
//      seq, heads, batch) built by the C entry from the layout's strides,
//      a ring of stages with mbarrier full/empty pairs, the per-row LSE and
//      delta or the key bias written beside each stage), warpgroups 1 and
//      2 the consumers.  No sum crosses CTAs (no atomics, no scratch): the
//      result is the same run to run.
//      a. flash_bwd_dkdv_wgmma_kernel: a CTA owns a key tile, keeps K and V
//         resident and dK, dV in fp32 registers, and walks the 64-row query
//         tiles: S^T = K Q^T and dP^T = V dO^T (wgmma, both operands
//         K-major in shared memory), P^T = exp(S^T - lse), the dropout mask
//         replayed, dS^T = P^T (dP^T - delta) sm_scale, then dV += P^T dO
//         and dK += dS^T Q (wgmma, P^T and dS^T as register A fragments,
//         dO and Q MN-major).  d 64 and 128: 128 keys a CTA, 64 per
//         consumer; d 192 and 256: 64 keys, both consumers compute S^T and
//         dP^T and each writes 128 columns (dK and dV of 64 keys x d take d
//         fp32 registers a thread); above d 256 as d 256 over 256 output
//         columns a CTA, with K, V, Q and dO of the whole head streaming
//         through the ring box by box for S^T and dP^T.
//      b. flash_bwd_dq_wgmma_kernel: the forward's shape -- a CTA owns 128
//         query rows (64 a consumer), keeps Q and dO resident, and walks
//         the key tiles (K and V through the ring): S = Q K^T and
//         dP = dO V^T, dS as above, dQ += dS K (K MN-major); above d 256
//         Q, dO, K and V stream box by box and a CTA writes 256 columns.
//      So S and dP are computed twice, 14 b h s^2 d operations against 10.
//      The single-kernel design with one recompute -- dQ partials summed
//      across key tiles in a fixed order through an fp32 scratch and
//      per-query-tile turn counters (FlashAttention-3's deterministic
//      mode) -- was built and measured first: its ordered read-modify-write
//      of the fp32 dQ sums (2.2 GB of L2 traffic at LLaMA-2-7B) and the
//      ring stalls it caused made it slower than this design at every
//      shape measured (PERF.md, section 6), so it is not shipped.
//   2'. fp32 (flash_bwd_fp32_kernel, twice: dK/dV over key tiles, then dQ
//      over query tiles): register-tiled FMAs on the CUDA cores (the tensor
//      cores would round fp32 to TF32), dropped P and dS through shared
//      memory.  Above d 128 a block writes a slice of the head's output
//      columns (d / 2 up to d 256, 128 above) and the grid has one block
//      per slice and row tile; each computes S and dP over the whole head,
//      loading it 128 columns at a time above d 256.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; the entry returns cudaGetLastError() after the last launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_layout.cuh"
#include "dropout_hash.cuh"
#include "hopper.cuh"
#include "vec.cuh"

namespace {

using dropout_hash::Params;

constexpr int kThreads = 128;
constexpr int kBR = 64;  // rows per fp32 block: keys (dK/dV) or queries (dQ)
constexpr int kBQ = 64;  // query rows per bf16 query tile
constexpr int kWideChunk = 128;   // fp32 chunk width above d 256
constexpr int kSliceCols = 256;   // bf16 output columns a CTA above d 128
constexpr float kLog2e = 1.4426950408889634f;

// Output columns an fp32 block writes: the whole head up to d 128, half
// up to d 256 (D is the head width), D above (D is the chunk width).
template <int D>
__host__ __device__ constexpr int out_cols() {
  return D <= 128 ? D : D / 2;
}

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;   // (batch, seq)
  const void* o;
  const void* dout;
  const float* lse;    // (batch, heads, seq)
  float* delta;        // written by the pre-pass: fp32, (batch, heads,
                       // seq); bf16, per 64-row query tile of each (batch,
                       // head) 64 LSE * log2 e then 64 delta, zero past seq
  void* dq;
  void* dk;
  void* dv;
  int seq;
  int heads;
  int head_dim;
  Layout lay;
  float sm_scale;
  int causal;
  Params drop;
};

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O) per (batch, head, position), in fp32.

// A row of head_dim values is read as 16-byte vectors by `lanes` lanes of
// a warp (the largest power of two up to 32 that divides the vector count),
// so a warp sums 32 / lanes rows at once.
__host__ __device__ inline int delta_lanes(int vectors) {
  int lanes = 32;
  while (vectors % lanes) lanes >>= 1;
  return lanes;
}

template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(BwdArgs a, int64_t rows) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const int vectors = a.head_dim / kVec;
  const int lanes = delta_lanes(vectors);
  const int lane = threadIdx.x & 31;
  const int64_t w = ((int64_t)blockIdx.x * 8 + (threadIdx.x >> 5)) *
                        (32 / lanes) + lane / lanes;
  const int sub = lane % lanes;
  constexpr bool kTiled = sizeof(T) == 2;  // bf16: per query tile, padded
  const int span = kTiled ? (a.seq + kBQ - 1) / kBQ * kBQ : a.seq;
  float acc = 0.f;
  int h = 0, b = 0, pos = 0;
  if (w < rows) {
    h = (int)(w % a.heads);
    const int64_t tok = w / a.heads;  // batch * span + position
    b = (int)(tok / span);
    pos = (int)(tok % span);
  }
  if (w < rows && pos < a.seq) {
    const int64_t off = a.lay.base(b, h) + (int64_t)pos * a.lay.row;
    const T* o = static_cast<const T*>(a.o) + off;
    const T* d = static_cast<const T*>(a.dout) + off;
    for (int c = sub; c < vectors; c += lanes) {
      float fo[kVec], fd[kVec];
      load_vec<T, kVec>(o + c * kVec, fo);
      load_vec<T, kVec>(d + c * kVec, fd);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc += fo[i] * fd[i];
    }
  }
  for (int off = lanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (w >= rows || sub) return;
  const int64_t bh = (int64_t)b * a.heads + h;
  if (kTiled) {
    float* tile = a.delta + (bh * (span / kBQ) + pos / kBQ) * 2 * kBQ;
    tile[pos % kBQ] = pos < a.seq ? a.lse[bh * a.seq + pos] * kLog2e : 0.f;
    tile[kBQ + pos % kBQ] = acc;
  } else {
    a.delta[bh * a.seq + pos] = acc;
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
// 2'. fp32: register-tiled FMAs.  Thread (ty, tx) = (tid / 8, tid % 8) owns
// rows 4 ty + i of the 64-row block; S/dP columns tx + 8 j; output columns
// col0 + 4 tx + 32 j + e.

template <int D>
struct Fp32Tile {
  static constexpr int kBC = D <= 128 ? 64 : 32;  // column tile
  static constexpr int kLd = D + 4;          // row stride of q/k/v/dO tiles
  static constexpr int kLdS = kBC + 4;       // row stride of the P / dS tiles
  static constexpr int kFloats =
      (2 * kBR + 2 * kBC) * kLd + 2 * kBR * kLdS + 2 * kBR + 2 * kBC;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// Columns [col0, col0 + D) of rows [row0, row0 + rows); rows past seq and
// (WIDE) columns past head_dim are zero.
template <int D, bool WIDE>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int64_t base, int64_t row_stride,
                                              int row0, int rows, int seq,
                                              int col0, int head_dim) {
  constexpr int kPerRow = D / 4;
  constexpr int ld = Fp32Tile<D>::kLd;
  for (int c = threadIdx.x; c < rows * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < seq && (!WIDE || col0 + col < head_dim))
      val = *reinterpret_cast<const float4*>(
          src + base + (int64_t)(row0 + r) * row_stride + col0 + col);
    *reinterpret_cast<float4*>(dst + r * ld + col) = val;
  }
}

// grid = (ceil(seq / 64) * slices, heads, batch), slices = ceil(head_dim /
// out_cols<D>()).  KV: rows = keys (K, V), columns = queries (Q, dO); else
// rows = queries (Q, dO), columns = keys (K, V).  D is the head width, or
// the chunk width of a wider head (WIDE: then chunk = slice, and the block
// walks the chunks ending with its own slice's, which stays in shared
// memory for the output products).
template <int D, bool KV, bool WIDE>
__global__ void __launch_bounds__(kThreads) flash_bwd_fp32_kernel(BwdArgs a) {
  using L = Fp32Tile<D>;
  constexpr int BC = L::kBC;
  constexpr int NS = BC / 8;             // S/dP columns per thread
  constexpr int DO = out_cols<D>();
  constexpr int ld = L::kLd;
  constexpr int lds = L::kLdS;
  constexpr int NJ = DO / 32;
  extern __shared__ float4 smem4[];
  float* RA = reinterpret_cast<float*>(smem4);  // K or Q
  float* RC = RA + kBR * ld;                     // V or dO
  float* CB = RC + kBR * ld;                     // Q or K
  float* CD = CB + BC * ld;                      // dO or V
  float* PS = CD + BC * ld;                      // dropped P (KV)
  float* DS = PS + kBR * lds;                    // dS
  float* rv1 = DS + kBR * lds;                   // bias (KV) or lse
  float* rv2 = rv1 + kBR;                        // delta (dQ)
  float* cv1 = rv2 + kBR;                        // lse (KV) or bias
  float* cv2 = cv1 + BC;                         // delta (KV)

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  const int nchunks = WIDE ? (a.head_dim + D - 1) / D : 1;
  const int nslices = (a.head_dim + DO - 1) / DO;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int r0 = (blockIdx.x / nslices) * kBR;
  const int slice = blockIdx.x % nslices;
  const int col0 = slice * DO;                  // first output column
  const int cofs = nchunks > 1 ? 0 : col0;      // its column in the tiles
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t base = a.lay.base(b, h);
  const int64_t rs = a.lay.row;
  const uint32_t bh = (uint32_t)(b * a.heads + h);

  if (nchunks == 1) {
    load_tile_f32<D, WIDE>(RA, KV ? k : q, base, rs, r0, kBR, a.seq, 0,
                           a.head_dim);
    load_tile_f32<D, WIDE>(RC, KV ? v : dout, base, rs, r0, kBR, a.seq, 0,
                           a.head_dim);
  }
  load_side_values(a, b, h, r0, kBR, KV, rv1, rv2);

  float acc1[4][NJ * 4];  // dK or dQ
  float acc2[4][NJ * 4];  // dV
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NJ * 4; ++c) acc1[i][c] = acc2[i][c] = 0.f;

  int begin, end;
  column_range<KV>(r0, BC, a.seq, a.causal, begin, end);
  for (int ct = begin; ct < end; ++ct) {
    const int c0 = ct * BC;
    float s[4][NS], dp[4][NS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int n = 0; n < nchunks; ++n) {
      const int ch = (slice + 1 + n) % nchunks;  // the slice's chunk last
      __syncthreads();  // the previous products are done with the tiles
      if (nchunks > 1) {
        load_tile_f32<D, WIDE>(RA, KV ? k : q, base, rs, r0, kBR, a.seq,
                               ch * D, a.head_dim);
        load_tile_f32<D, WIDE>(RC, KV ? v : dout, base, rs, r0, kBR, a.seq,
                               ch * D, a.head_dim);
      }
      load_tile_f32<D, WIDE>(CB, KV ? q : k, base, rs, c0, BC, a.seq, ch * D,
                             a.head_dim);
      load_tile_f32<D, WIDE>(CD, KV ? dout : v, base, rs, c0, BC, a.seq,
                             ch * D, a.head_dim);
      if (n == 0) load_side_values(a, b, h, c0, BC, !KV, cv1, cv2);
      __syncthreads();

#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float4 ra[4], rc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ra[i] = *reinterpret_cast<const float4*>(RA + (ty * 4 + i) * ld + d);
          rc[i] = *reinterpret_cast<const float4*>(RC + (ty * 4 + i) * ld + d);
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) {
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
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
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

    // acc1 += dS . CB (dK += dS^T Q, dQ += dS K); acc2 += P_d . CD (dV),
    // over this block's output columns.
#pragma unroll 4
    for (int cc = 0; cc < BC; ++cc) {
      float dsv[4], pdv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dsv[i] = DS[(ty * 4 + i) * lds + cc];
        pdv[i] = KV ? PS[(ty * 4 + i) * lds + cc] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = cofs + tx * 4 + 32 * j;
        const float4 cb = *reinterpret_cast<const float4*>(CB + cc * ld + col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc1[i][4 * j + 0] = fmaf(dsv[i], cb.x, acc1[i][4 * j + 0]);
          acc1[i][4 * j + 1] = fmaf(dsv[i], cb.y, acc1[i][4 * j + 1]);
          acc1[i][4 * j + 2] = fmaf(dsv[i], cb.z, acc1[i][4 * j + 2]);
          acc1[i][4 * j + 3] = fmaf(dsv[i], cb.w, acc1[i][4 * j + 3]);
        }
        if (KV) {
          const float4 cd =
              *reinterpret_cast<const float4*>(CD + cc * ld + col);
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
    const int64_t row = base + (int64_t)r * rs + col0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx * 4 + 32 * j;
      if (WIDE && col0 + col >= a.head_dim) continue;
      *reinterpret_cast<float4*>(out1 + row + col) =
          make_float4(acc1[i][4 * j], acc1[i][4 * j + 1], acc1[i][4 * j + 2],
                      acc1[i][4 * j + 3]);
      if (KV)
        *reinterpret_cast<float4*>(out2 + row + col) =
            make_float4(acc2[i][4 * j], acc2[i][4 * j + 1],
                        acc2[i][4 * j + 2], acc2[i][4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. bf16: warp-specialised wgmma + TMA (header note).

constexpr int kWgThreads = 384;
constexpr int kBox = kBQ * hopper::kBoxRowBytes;  // one 64-row box, 8 KB
constexpr int kWgBQ = 128;                        // query rows a dQ CTA
constexpr int kSmemBudget = 200 * 1024;

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// 2a. dK, dV.  KG: 64-key groups a CTA (2: one per consumer, all columns;
// 1: both consumers on the same keys, 128 output columns each); NCH:
// 64-column boxes of K and V resident (the head up to d 256); STREAM: K,
// V, Q and dO of the whole head stream box by box for S^T and dP^T, and
// the CTA writes 256 of the output columns.
template <int KG, int NCH, bool STREAM>
struct KvPlan {
  static constexpr int kKeys = 64 * KG;
  static constexpr int kOut = KG == 2 ? NCH : 2;  // output boxes a consumer
  static constexpr int kKRes = 0;
  static constexpr int kVRes = STREAM ? 0 : NCH * KG * kBox;
  static constexpr int kRing = kVRes + (STREAM ? 0 : NCH * KG * kBox);
  static constexpr int kStageBytes =
      STREAM ? cmax(4 * kBox, 2 * NCH * kBox) : 2 * NCH * kBox;
  static constexpr int kStages =
      cmin(4, (kSmemBudget - kRing) / (kStageBytes + 2 * kBQ * 4));
  static constexpr int kStats = kRing + kStages * kStageBytes;
  static constexpr int kBars = kStats + kStages * 2 * kBQ * 4;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;
  static_assert(kStages >= 2, "the ring needs two stages");
};

// grid = (key tiles, heads * slices, batch), block = 384 threads.
template <int KG, int NCH, bool STREAM>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap dmap,
                            BwdArgs a) {
  using P = KvPlan<KG, NCH, STREAM>;
  constexpr int ST = P::kStages;
  constexpr int NO = P::kOut;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  float* stats = reinterpret_cast<float*>(smem + P::kStats);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + P::kBars);
  uint64_t* kbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + ST;

  const int seq = a.seq;
  const int nslices =
      KG == 2 ? 1 : (a.head_dim + kSliceCols - 1) / kSliceCols;
  const int u = blockIdx.x;                 // key tile
  const int h = blockIdx.y / nslices;
  const int slice = blockIdx.y % nslices;
  const int b = blockIdx.z;
  const int kb = u * P::kKeys;              // first key
  const int col0 = slice * kSliceCols;      // first output column
  const int nspan = STREAM ? cmin(NCH, (a.head_dim - col0) / 64) : NCH;
  const int nc = a.head_dim / 64;           // boxes of the whole head
  const int nq = (seq + kBQ - 1) / kBQ;
  const int i0 = a.causal ? kb / kBQ : 0;   // first query tile it touches
  const uint32_t bh = (uint32_t)(b * a.heads + h);

  if (threadIdx.x == 0) {
    hopper::mbar_init(kbar, 1);
    for (int i = 0; i < ST; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, 2);  // one arrival per consumer
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: warp 0 issues the loads and writes LSE and delta ----
    hopper::reg_dealloc<40>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      hopper::prefetch_map(&qmap);
      hopper::prefetch_map(&kmap);
      hopper::prefetch_map(&vmap);
      hopper::prefetch_map(&dmap);
      if (!STREAM) {  // K and V of the CTA's keys stay resident
        hopper::mbar_expect_tx(kbar, 2 * NCH * KG * kBox);
        for (int c = 0; c < NCH; ++c)
          for (int g = 0; g < KG; ++g) {
            hopper::tma_load_4d(smem + P::kKRes + (c * KG + g) * kBox, &kmap,
                                kbar, c * 64, kb + 64 * g, h, b);
            hopper::tma_load_4d(smem + P::kVRes + (c * KG + g) * kBox, &vmap,
                                kbar, c * 64, kb + 64 * g, h, b);
          }
      }
    }
    int st = 0;
    uint32_t ph = 0;
    for (int i = i0; i < nq; ++i) {
      const int q0 = i * kBQ;
      if constexpr (STREAM) {
        for (int c = 0; c < nc; ++c) {
          hopper::mbar_wait(empty + st, ph ^ 1);
          if (lane == 0) {
            uint8_t* s = smem + P::kRing + st * P::kStageBytes;
            hopper::mbar_expect_tx(full + st, 4 * kBox);
            hopper::tma_load_4d(s, &kmap, full + st, c * 64, kb, h, b);
            hopper::tma_load_4d(s + kBox, &vmap, full + st, c * 64, kb, h, b);
            hopper::tma_load_4d(s + 2 * kBox, &qmap, full + st, c * 64, q0, h,
                                b);
            hopper::tma_load_4d(s + 3 * kBox, &dmap, full + st, c * 64, q0, h,
                                b);
          }
          if (++st == ST) { st = 0; ph ^= 1; }
        }
      }
      // Q and dO of the query tile (the slice's columns), LSE and delta
      hopper::mbar_wait(empty + st, ph ^ 1);
      if (lane == 0) {
        uint8_t* s = smem + P::kRing + st * P::kStageBytes;
        hopper::mbar_expect_tx(full + st, 2 * nspan * kBox + 2 * kBQ * 4);
        hopper::bulk_load(stats + st * 2 * kBQ,
                          a.delta + ((int64_t)bh * nq + i) * 2 * kBQ,
                          2 * kBQ * 4, full + st);
        for (int c = 0; c < nspan; ++c) {
          hopper::tma_load_4d(s + c * kBox, &qmap, full + st, col0 + c * 64,
                              q0, h, b);
          hopper::tma_load_4d(s + (NCH + c) * kBox, &dmap, full + st,
                              col0 + c * 64, q0, h, b);
        }
      }
      if (++st == ST) { st = 0; ph ^= 1; }
    }
    return;
  }

  // ---- consumers: 64 keys each (KG 2) or 128 columns each (KG 1) ----
  hopper::reg_alloc<232>();
  const int ct = threadIdx.x - 128;
  const int cw = ct >> 7;
  const int lt = ct & 127;
  const int warp = lt >> 5;
  const int lane = lt & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kg = KG == 2 ? cw : 0;               // the consumer's key group
  const int kr0 = kb + 64 * kg + 16 * warp + g;  // its two key rows
  const int kr1 = kr0 + 8;
  const int ob = KG == 2 ? 0 : 2 * cw;           // its first output box
  const int nout = KG == 2 ? NCH : max(0, min(2, nspan - ob));
  const uint32_t sbase = hopper::smem_u32(smem);
  const float bias0 =
      kr0 < seq ? a.bias[(int64_t)b * seq + kr0] * kLog2e : 0.f;
  const float bias1 =
      kr1 < seq ? a.bias[(int64_t)b * seq + kr1] * kLog2e : 0.f;
  const float scale2 = a.sm_scale * kLog2e;

  float dk[NO][32], dv[NO][32];
#pragma unroll
  for (int v = 0; v < NO; ++v)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[v][e] = dv[v][e] = 0.f;

  if (!STREAM) hopper::mbar_wait(kbar, 0);
  int st = 0;
  uint32_t ph = 0;
  for (int i = i0; i < nq; ++i) {
    const int q0 = i * kBQ;
    float sT[32], dpT[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sT[e] = dpT[e] = 0.f;
    if constexpr (!STREAM) {
      hopper::mbar_wait(full + st, ph);
      const uint32_t qs = sbase + P::kRing + st * P::kStageBytes;
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t row = (c * KG + kg) * kBox + kk * 32;
          hopper::wgmma_ss<64>(sT, sbase + P::kKRes + row,
                               qs + c * kBox + kk * 32);
          hopper::wgmma_ss<64>(dpT, sbase + P::kVRes + row,
                               qs + (NCH + c) * kBox + kk * 32);
        }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
    } else {
      for (int c = 0; c < nc; ++c) {
        hopper::mbar_wait(full + st, ph);
        const uint32_t s = sbase + P::kRing + st * P::kStageBytes;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hopper::wgmma_ss<64>(sT, s + kk * 32, s + 2 * kBox + kk * 32);
          hopper::wgmma_ss<64>(dpT, s + kBox + kk * 32,
                               s + 3 * kBox + kk * 32);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sT);
        hopper::fence_regs(dpT);
        if (lt == 0) hopper::mbar_arrive(empty + st);
        if (++st == ST) { st = 0; ph ^= 1; }
      }
      hopper::mbar_wait(full + st, ph);
    }
    hopper::fence_regs(sT);
    hopper::fence_regs(dpT);

    // P^T (dropped) into sT, dS^T into dpT; rows = keys, columns = queries.
    const float* sv = stats + st * 2 * kBQ;
    const bool masked = q0 + kBQ > seq || kb + P::kKeys > seq ||
                        (a.causal && q0 < kb + P::kKeys - 1);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(sv + 8 * n + 2 * t);
      const float2 dl =
          *reinterpret_cast<const float2*>(sv + kBQ + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = q0 + 8 * n + 2 * t + (e & 1);
        const int kpos = (e < 2) ? kr0 : kr1;
        float p = hopper::exp2_ftz(
            fmaf(sT[4 * n + e], scale2, (e < 2) ? bias0 : bias1) -
            ((e & 1) ? l2.y : l2.x));
        if (masked &&
            ((a.causal && qpos < kpos) || qpos >= seq || kpos >= seq))
          p = 0.f;
        float dp = dpT[4 * n + e];
        float pd = p;
        if (a.drop.on) {
          const bool kept = dropout_hash::keep(a.drop.seed, bh, qpos, kpos,
                                               a.drop.threshold);
          pd = kept ? p * a.drop.scale : 0.f;
          dp = kept ? dp * a.drop.scale : 0.f;
        }
        sT[4 * n + e] = pd;
        dpT[4 * n + e] = p * (dp - ((e & 1) ? dl.y : dl.x)) * a.sm_scale;
      }
    }
    uint32_t pf[4][4], df[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::a_fragment(pf[kk], sT, kk);
      hopper::a_fragment(df[kk], dpT, kk);
    }

    // dV += P^T dO, dK += dS^T Q over the consumer's output boxes.
    const uint32_t qs = sbase + P::kRing + st * P::kStageBytes;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int v = 0; v < NO; ++v)
        if (KG == 2 || v < nout) {
          const uint32_t off = (ob + v) * kBox + kk * 16 * 128;
          hopper::wgmma_rs64(dv[v], pf[kk],
                             hopper::desc_sw128(qs + NCH * kBox + off));
          hopper::wgmma_rs64(dk[v], df[kk], hopper::desc_sw128(qs + off));
        }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int v = 0; v < NO; ++v) {
      hopper::fence_regs(dk[v]);
      hopper::fence_regs(dv[v]);
    }
    if (lt == 0) hopper::mbar_arrive(empty + st);
    if (++st == ST) { st = 0; ph ^= 1; }
  }

  // dK and dV of the consumer's keys and output boxes, staged in the ring
  // (both consumers are done with it) and written in 16-byte rows.
  hopper::bar_sync(1, 256);
  {
    constexpr int kTile = 64 * (NO * 64 + 8);  // bf16 of one staged tile
    __nv_bfloat16* buf =
        reinterpret_cast<__nv_bfloat16*>(smem + P::kRing) + 2 * cw * kTile;
    const int64_t row = a.lay.base(b, h) +
                        (int64_t)(kb + 64 * kg) * a.lay.row + col0 + 64 * ob;
    const int rows = seq - (kb + 64 * kg);
    const int boxes = KG == 2 ? NCH : nout;
    hopper::store_tile_bf16<NO>(dk, boxes, buf,
                                static_cast<__nv_bfloat16*>(a.dk) + row,
                                a.lay.row, rows, 2 + cw, lt);
    hopper::store_tile_bf16<NO>(dv, boxes, buf + kTile,
                                static_cast<__nv_bfloat16*>(a.dv) + row,
                                a.lay.row, rows, 2 + cw, lt);
  }
}

// 2b. dQ.  The forward's shape: BK keys a tile, NC 64-column boxes of Q
// and dO resident (0: they stream with K and V, above d 256), NV boxes of
// dQ a CTA.
template <int BK, int NC, int NV>
struct DqPlan {
  static constexpr bool kStream = NC == 0;
  static constexpr int kKBox = BK * hopper::kBoxRowBytes;     // K or V box
  static constexpr int kQBox = kWgBQ * hopper::kBoxRowBytes;  // Q or dO box
  static constexpr int kRes = kStream ? 0 : 2 * NC * kQBox;
  static constexpr int kStage =
      kStream ? cmax(2 * kQBox + 2 * kKBox, NV * kKBox) : 2 * NC * kKBox;
  static constexpr int kStages =
      cmin(4, (kSmemBudget - kRes) / (kStage + BK * 4));
  static constexpr int kBias = kRes + kStages * kStage;
  static constexpr int kBars = kBias + kStages * BK * 4;
  static constexpr int kBytes = kBars + (2 * kStages) * 8 + 1024 + 8;
  static_assert(kStages >= 2, "the ring needs two stages");
};

// grid = (heads * slices, ceil(seq / 128), batch), block = 384 threads.
template <int BK, int NC, int NV>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap dmap,
                          BwdArgs a) {
  using P = DqPlan<BK, NC, NV>;
  constexpr int ST = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  float* bias_s = reinterpret_cast<float*>(smem + P::kBias);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + P::kBars);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + ST;

  const int seq = a.seq;
  const int nsplit =
      P::kStream ? (a.head_dim + kSliceCols - 1) / kSliceCols : 1;
  const int h = blockIdx.x / nsplit;
  const int split = blockIdx.x % nsplit;
  const int b = blockIdx.z;
  const int nqt = (seq + kWgBQ - 1) / kWgBQ;
  const int q0 =
      (a.causal ? nqt - 1 - (int)blockIdx.y : (int)blockIdx.y) * kWgBQ;
  const int col0 = split * kSliceCols;
  const int nc = P::kStream ? a.head_dim / 64 : NC;
  const int nv = P::kStream ? cmin(NV, (a.head_dim - col0) / 64) : NV;
  const int kend = a.causal ? min(seq, q0 + kWgBQ) : seq;
  const int ntiles = (kend + BK - 1) / BK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(qbar, 1);
    for (int i = 0; i < ST; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, 2);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: warp 0 issues the loads and writes the key bias ----
    hopper::reg_dealloc<40>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      hopper::prefetch_map(&qmap);
      hopper::prefetch_map(&kmap);
      hopper::prefetch_map(&vmap);
      hopper::prefetch_map(&dmap);
      if constexpr (!P::kStream) {
        hopper::mbar_expect_tx(qbar, 2 * NC * P::kQBox);
        for (int c = 0; c < NC; ++c) {
          hopper::tma_load_4d(smem + c * P::kQBox, &qmap, qbar, c * 64, q0,
                              h, b);
          hopper::tma_load_4d(smem + (NC + c) * P::kQBox, &dmap, qbar,
                              c * 64, q0, h, b);
        }
      }
    }
    int st = 0;
    uint32_t ph = 0;
    // A tile's key bias, read one tile ahead of its stage.
    constexpr int NB = (BK + 31) / 32;
    auto load_bias = [&](float (&bv)[NB], int k0) {
#pragma unroll
      for (int x = 0; x < NB; ++x) {
        const int i = lane + 32 * x;
        bv[x] = i < BK && k0 + i < seq
                    ? a.bias[(int64_t)b * seq + k0 + i] * kLog2e
                    : 0.f;
      }
    };
    float bv[NB], bnext[NB] = {};
    load_bias(bv, 0);
    for (int j = 0; j < ntiles; ++j) {
      const int k0 = j * BK;
      if (j + 1 < ntiles) load_bias(bnext, k0 + BK);
      if constexpr (P::kStream) {
        for (int c = 0; c < nc; ++c) {
          hopper::mbar_wait(empty + st, ph ^ 1);
          if (lane == 0) {
            uint8_t* s = smem + st * P::kStage;
            hopper::mbar_expect_tx(full + st, 2 * P::kQBox + 2 * P::kKBox);
            hopper::tma_load_4d(s, &qmap, full + st, c * 64, q0, h, b);
            hopper::tma_load_4d(s + P::kQBox, &dmap, full + st, c * 64, q0,
                                h, b);
            hopper::tma_load_4d(s + 2 * P::kQBox, &kmap, full + st, c * 64,
                                k0, h, b);
            hopper::tma_load_4d(s + 2 * P::kQBox + P::kKBox, &vmap,
                                full + st, c * 64, k0, h, b);
          }
          if (++st == ST) { st = 0; ph ^= 1; }
        }
      }
      // K (and, Q resident, V) of the key tile with its bias
      hopper::mbar_wait(empty + st, ph ^ 1);
      float* bs = bias_s + st * BK;
#pragma unroll
      for (int x = 0; x < NB; ++x) {
        if (lane + 32 * x < BK) bs[lane + 32 * x] = bv[x];
        bv[x] = bnext[x];
      }
      __syncwarp();
      if (lane == 0) {
        uint8_t* s = smem + P::kRes + st * P::kStage;
        if constexpr (P::kStream) {
          hopper::mbar_expect_tx(full + st, nv * P::kKBox);
          for (int c = 0; c < nv; ++c)
            hopper::tma_load_4d(s + c * P::kKBox, &kmap, full + st,
                                col0 + c * 64, k0, h, b);
        } else {
          hopper::mbar_expect_tx(full + st, 2 * NC * P::kKBox);
          for (int c = 0; c < NC; ++c) {
            hopper::tma_load_4d(s + c * P::kKBox, &kmap, full + st, c * 64,
                                k0, h, b);
            hopper::tma_load_4d(s + (NC + c) * P::kKBox, &vmap, full + st,
                                c * 64, k0, h, b);
          }
        }
      }
      if (++st == ST) { st = 0; ph ^= 1; }
    }
    return;
  }

  // ---- consumers: 64 query rows each ----
  hopper::reg_alloc<232>();
  const int ct = threadIdx.x - 128;
  const int cw = ct >> 7;
  const int lt = ct & 127;
  const int warp = lt >> 5;
  const int lane = lt & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wq0 = q0 + cw * 64;
  const int r0 = wq0 + warp * 16 + g;
  const int r1 = r0 + 8;
  const uint32_t bh = (uint32_t)(b * a.heads + h);
  const uint32_t sbase = hopper::smem_u32(smem);
  const float scale2 = a.sm_scale * kLog2e;
  // LSE * log2 e and delta of the two rows (zero past seq; r0 and r1 share
  // a 64-row query tile)
  float lse0 = 0.f, dl0 = 0.f, lse1 = 0.f, dl1 = 0.f;
  if (r0 < seq) {
    const float* st0 = a.delta + ((int64_t)bh * ((seq + kBQ - 1) / kBQ) +
                                  r0 / kBQ) * 2 * kBQ + r0 % kBQ;
    lse0 = st0[0];
    dl0 = st0[kBQ];
    lse1 = st0[8];
    dl1 = st0[kBQ + 8];
  }

  float dq[NV][32];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[v][e] = 0.f;

  if constexpr (!P::kStream) hopper::mbar_wait(qbar, 0);
  int st = 0;
  uint32_t ph = 0;
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK;
    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) s[e] = dp[e] = 0.f;
    if constexpr (!P::kStream) {
      hopper::mbar_wait(full + st, ph);
      const uint32_t ks = sbase + P::kRes + st * P::kStage;
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t qa = sbase + c * P::kQBox + cw * 64 * 128 + kk * 32;
          hopper::wgmma_ss<BK>(s, qa, ks + c * P::kKBox + kk * 32);
          hopper::wgmma_ss<BK>(dp, qa + NC * P::kQBox,
                               ks + (NC + c) * P::kKBox + kk * 32);
        }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
    } else {
      for (int c = 0; c < nc; ++c) {
        hopper::mbar_wait(full + st, ph);
        const uint32_t s0 = sbase + st * P::kStage;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t qa = s0 + cw * 64 * 128 + kk * 32;
          hopper::wgmma_ss<BK>(s, qa, s0 + 2 * P::kQBox + kk * 32);
          hopper::wgmma_ss<BK>(dp, qa + P::kQBox,
                               s0 + 2 * P::kQBox + P::kKBox + kk * 32);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        if (lt == 0) hopper::mbar_arrive(empty + st);
        if (++st == ST) { st = 0; ph ^= 1; }
      }
      hopper::mbar_wait(full + st, ph);
    }
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    // dS into s; rows = queries, columns = keys.
    const float* bsm = bias_s + st * BK;
    const bool masked = k0 + BK > seq || (a.causal && k0 + BK - 1 > wq0);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float2 bv = *reinterpret_cast<const float2*>(bsm + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * n + 2 * t + (e & 1);
        const int qpos = (e < 2) ? r0 : r1;
        float p = hopper::exp2_ftz(
            fmaf(s[4 * n + e], scale2, (e & 1) ? bv.y : bv.x) -
            ((e < 2) ? lse0 : lse1));
        if (masked && ((a.causal && qpos < kpos) || kpos >= seq)) p = 0.f;
        float dpv = dp[4 * n + e];
        if (a.drop.on)
          dpv = dropout_hash::keep(a.drop.seed, bh, qpos, kpos,
                                   a.drop.threshold)
                    ? dpv * a.drop.scale
                    : 0.f;
        s[4 * n + e] = p * (dpv - ((e < 2) ? dl0 : dl1)) * a.sm_scale;
      }
    }
    uint32_t df[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hopper::a_fragment(df[kk], s, kk);

    // dQ += dS K, K MN-major from the stage.
    const uint32_t kst = sbase + P::kRes + st * P::kStage;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int v = 0; v < NV; ++v)
        if (!P::kStream || v < nv)
          hopper::wgmma_rs64(dq[v], df[kk],
                             hopper::desc_sw128(kst + v * P::kKBox +
                                                kk * 16 * 128));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int v = 0; v < NV; ++v) hopper::fence_regs(dq[v]);
    if (lt == 0) hopper::mbar_arrive(empty + st);
    if (++st == ST) { st = 0; ph ^= 1; }
  }

  // dQ of the consumer's rows, staged in shared memory (both consumers are
  // done with it) and written in 16-byte rows.
  hopper::bar_sync(3, 256);
  __nv_bfloat16* buf =
      reinterpret_cast<__nv_bfloat16*>(smem) + cw * 64 * (NV * 64 + 8);
  hopper::store_tile_bf16<NV>(
      dq, P::kStream ? nv : NV, buf,
      static_cast<__nv_bfloat16*>(a.dq) + a.lay.base(b, h) +
          (int64_t)wq0 * a.lay.row + col0,
      a.lay.row, seq - wq0, 4 + cw, lt);
}

// ---------------------------------------------------------------------------

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

template <typename T>
int launch_delta(const BwdArgs& a, int batch, cudaStream_t stream) {
  const int span =
      sizeof(T) == 2 ? (a.seq + kBQ - 1) / kBQ * kBQ : a.seq;  // padded
  const int64_t rows = (int64_t)batch * span * a.heads;
  const int64_t per_block =
      8 * (32 / delta_lanes(a.head_dim / (16 / (int)sizeof(T))));
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + per_block - 1) / per_block),
                              256, 0, stream>>>(a, rows);
  return (int)cudaGetLastError();
}

// Set `kernel`'s dynamic shared-memory limit once per device (`done`, a
// static of the caller's instantiation), then launch it on the (row tile x
// output slice, head, batch) grid.
template <int D, bool KV, bool WIDE>
int launch_fp32_pass(const BwdArgs& a, int batch, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  auto kernel = flash_bwd_fp32_kernel<D, KV, WIDE>;
  const size_t smem = Fp32Tile<D>::kBytes;
  const int err = set_smem_limit(kernel, smem, done);
  if (err) return err;
  const int slices = (a.head_dim + out_cols<D>() - 1) / out_cols<D>();
  const dim3 grid((unsigned)((a.seq + kBR - 1) / kBR * slices),
                  (unsigned)a.heads, (unsigned)batch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D, bool WIDE = false>
int launch_fp32(const BwdArgs& a, int batch, cudaStream_t stream) {
  int err = launch_delta<float>(a, batch, stream);
  if (err) return err;
  err = launch_fp32_pass<D, true, WIDE>(a, batch, stream);
  if (err) return err;
  return launch_fp32_pass<D, false, WIDE>(a, batch, stream);
}

// The bf16 operands' tensor maps, boxes of 64 columns x `rows` rows: q, k,
// v, dO for the dK/dV kernel (64 rows each), or the dQ kernel (q and dO
// 128 rows, k and v `key_rows`).
int bf16_maps(CUtensorMap (&maps)[4], const BwdArgs& a, int batch,
              int q_rows, int key_rows) {
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  const int rows[4] = {q_rows, key_rows, key_rows, q_rows};
  const Layout& l = a.lay;
  for (int i = 0; i < 4; ++i) {
    const int err = hopper::make_map(maps + i, ptrs[i], a.head_dim, a.seq,
                                     a.heads, batch, l.row, l.head, l.batch,
                                     rows[i]);
    if (err) return err;
  }
  return 0;
}

template <int KG, int NCH, bool STREAM>
int launch_dkdv(const BwdArgs& a, int batch, cudaStream_t stream) {
  using P = KvPlan<KG, NCH, STREAM>;
  static bool done[kMaxDevices] = {};
  auto kernel = flash_bwd_dkdv_wgmma_kernel<KG, NCH, STREAM>;
  int err = set_smem_limit(kernel, P::kBytes, done);
  if (err) return err;
  CUtensorMap maps[4];
  if ((err = bf16_maps(maps, a, batch, kBQ, kBQ))) return err;
  const int nslices =
      KG == 2 ? 1 : (a.head_dim + kSliceCols - 1) / kSliceCols;
  const dim3 grid((unsigned)((a.seq + P::kKeys - 1) / P::kKeys),
                  (unsigned)(a.heads * nslices), (unsigned)batch);
  kernel<<<grid, kWgThreads, P::kBytes, stream>>>(maps[0], maps[1], maps[2],
                                                  maps[3], a);
  return (int)cudaGetLastError();
}

template <int BK, int NC, int NV>
int launch_dq(const BwdArgs& a, int batch, cudaStream_t stream) {
  using P = DqPlan<BK, NC, NV>;
  static bool done[kMaxDevices] = {};
  auto kernel = flash_bwd_dq_wgmma_kernel<BK, NC, NV>;
  int err = set_smem_limit(kernel, P::kBytes, done);
  if (err) return err;
  CUtensorMap maps[4];
  if ((err = bf16_maps(maps, a, batch, kWgBQ, BK))) return err;
  const int nsplit =
      P::kStream ? (a.head_dim + kSliceCols - 1) / kSliceCols : 1;
  const dim3 grid((unsigned)(a.heads * nsplit),
                  (unsigned)((a.seq + kWgBQ - 1) / kWgBQ), (unsigned)batch);
  kernel<<<grid, kWgThreads, P::kBytes, stream>>>(maps[0], maps[1], maps[2],
                                                  maps[3], a);
  return (int)cudaGetLastError();
}

// delta, then dK/dV over key tiles, then dQ over query tiles.
template <int KG, int NCH, bool STREAM, int BK, int NC, int NV>
int launch_bf16(const BwdArgs& a, int batch, cudaStream_t stream) {
  int err = launch_delta<__nv_bfloat16>(a, batch, stream);
  if (err) return err;
  if ((err = launch_dkdv<KG, NCH, STREAM>(a, batch, stream))) return err;
  return launch_dq<BK, NC, NV>(a, batch, stream);
}

}  // namespace

extern "C" int flash_attention_packed_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* out, const void* dout, const void* lse, void* delta, void* dq,
    void* dk, void* dv, int batch, int seq, int heads, int head_dim,
    int64_t batch_stride, int64_t head_stride, int64_t row_stride,
    float sm_scale, int causal, uint32_t seed, uint32_t threshold,
    float keep_scale, int dropout, int dtype, void* stream) {
  if (head_dim <= 0 || head_dim % 64) return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, static_cast<const float*>(bias), out, dout,
                  static_cast<const float*>(lse), static_cast<float*>(delta),
                  dq, dk, dv, seq, heads, head_dim,
                  Layout{batch_stride, head_stride, row_stride}, sm_scale,
                  causal, Params{seed, threshold, keep_scale, dropout}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    switch (head_dim) {
      case 64: return launch_fp32<64>(a, batch, s);
      case 128: return launch_fp32<128>(a, batch, s);
      case 192: return launch_fp32<192>(a, batch, s);
      case 256: return launch_fp32<256>(a, batch, s);
      default: return launch_fp32<kWideChunk, true>(a, batch, s);
    }
  }
  if (dtype == kBF16) {
    switch (head_dim) {
      case 64: return launch_bf16<2, 1, false, 128, 1, 1>(a, batch, s);
      case 128: return launch_bf16<2, 2, false, 64, 2, 2>(a, batch, s);
      case 192: return launch_bf16<1, 3, false, 64, 3, 3>(a, batch, s);
      case 256: return launch_bf16<1, 4, false, 32, 4, 4>(a, batch, s);
      default: return launch_bf16<1, 4, true, 64, 0, 4>(a, batch, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
