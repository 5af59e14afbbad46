// Flash-attention forward for sm_90a, in either head layout.
//
// Replaces two Pallas kernels that compute the same function on two layouts:
//   * paddle_tpu/ops/pallas/flash_attention_packed.py `_forward` (line 212,
//     kernel `_fwd_kernel`): heads read straight out of the (batch, seq,
//     heads * head_dim) projection layout;
//   * paddle_tpu/ops/pallas/flash_attention.py `_flash_forward` (line 172,
//     kernel `_flash_fwd_kernel`): (batch * heads, seq, head_dim), the
//     split-head layout.
// The layouts differ only in their (batch, head, row) strides
// (attention_layout.cuh), which the entry takes.  Online-softmax attention
// with an additive fp32 (batch, seq) key bias, optional causal masking, the
// per-row log-sum-exp written for the backward, and in-kernel dropout: the
// keep mask is the position hash of dropout_hash.cuh keyed by (batch * heads
// + head, query, key) -- the key of both Pallas kernels' program ids -- so
// the backward (flash_attention_packed_bwd.cu) replays it without a mask in
// device memory, and both layouts draw the same mask.
//
// Layout change from the TPU kernels: LSE is fp32 (batch, heads, seq), not
// (batch, head_pairs, heads_per_pair, seq) (packed) or (batch * heads, 1,
// seq) (split); the 128-lane head pairing was a TPU tiling constraint.
//
// Numerics follow the Pallas kernels: QK^T and PV take their operands in the
// input type (bf16 products are exact in fp32) and sum in fp32; scores are
// s = (q.k) * sm_scale + bias in fp32; the softmax statistics m and l are
// fp32; P is rounded to the input type before the PV product while l sums
// the unrounded P; out = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30)).
// Masked (causal) scores are -1e30 as in the TPU kernels; key positions past
// the end of a ragged sequence are dropped (exp gives exactly 0).  With
// dropout, l sums the undropped P and P * keep / (1 - rate) enters the PV
// product (softmax-then-dropout, as the Pallas kernels).  The bf16 kernel
// takes the exponentials in base 2 (scores pre-multiplied by log2 e) with
// ex2.approx.ftz, which differs from base e by rounding and by flushing
// values below 2^-126 to zero.
//
// What bounds it on the H100.  At the ERNIE-base shape (b 8, s 512, h 12,
// d 64) the least time is set by bytes in bf16 (25 MB of q, k, v and o at
// 3.35 TB/s, 7.5 us, against 6.4 GFLOP at 989 TF/s, 6.5 us) and by
// operations in fp32 (67 TF/s outside the tensor cores, 96 us); at long
// sequences (s 2048-4096) by operations in both types: LLaMA-2-7B's causal
// s 4096 d 128 is 137 GFLOP, 0.139 ms at the tensor cores' peak.  So the
// bf16 kernel has to keep the tensor cores busy while K/V stream in.
//
// Design, bf16 (flash_fwd_wgmma_kernel): one CTA of 384 threads per
// (128-row query tile, head, batch) -- warpgroup 0 the producer, warpgroups
// 1 and 2 the consumers of 64 query rows each.
//   * Loads: TMA (cp.async.bulk.tensor) from one 4-d tensor map per operand
//     over (head_dim, seq, heads, batch), built by the C entry from the
//     pointers and the layout's strides, so both layouts and ragged ends
//     (rows past seq read as zeros) come from the same map.  The producer's
//     warp 0 loads Q once, then keeps a ring of K/V stages in flight with
//     mbarrier full/empty pairs, and writes each stage's key bias (times
//     log2 e, read a tile ahead) beside it.  setmaxnreg gives the producer
//     40 registers and the consumers 232.
//   * S = Q K^T: wgmma m64nBKk16, both operands in shared memory, K-major
//     (d is contiguous in q and k), 128-byte swizzle; d in 64-wide boxes.
//   * The online softmax runs on the accumulator in registers (the mma.sync
//     C layout per 8 columns, hopper.cuh).
//   * O += P V: wgmma m64n64k16 per 64 output columns with P from registers
//     (rounded to bf16 as the A fragments) and V MN-major from shared memory.
//   * Key tiles: 128 keys up to d 128, 64 above (the 64 x d fp32 O
//     accumulator is d / 2 registers a consumer thread).  Under causal
//     masking the grid launches the longest query tiles first.
//   * Heads wider than 256 stream Q with K in 64-column boxes (Q does not
//     fit in shared memory beside the ring) and split the output columns:
//     each CTA computes S over the whole head and writes 256 of the d
//     output columns; grid x = head * ceil(d / 256) + slice.
//   * With Q resident the two consumers take turns to issue their products
//     (named barriers 1 and 2, FlashAttention-3's ping-pong), so one's
//     softmax runs while the other's products hold the tensor cores.
//   Measured and not kept (PERF.md, section 6): issuing tile j + 1's Q K^T
//   behind tile j's P V within a consumer; 64-key tiles at d 128 and
//   32-key tiles at d 192-256 (deeper rings).  Not done: a persistent grid.
//
// Design, fp32 (flash_fwd_fp32_kernel): register-tiled fp32 FMAs on the
// CUDA cores (the tensor cores would round fp32 operands to TF32), one block
// of 128 threads per (64-row query tile, head, batch): Q, K, V staged in
// shared memory as fp32, each thread a 4 x (tile/8) tile of S and a
// 4 x d/8 tile of O, the score tile through shared memory for the row
// softmax.  Head widths 64-256 in one piece (32-key tiles above d 128);
// wider heads in 128-column chunks: the block reloads Q and K chunk by chunk
// for each key tile and writes 128 output columns (grid x = query tile *
// ceil(d / 128) + slice).  Shared memory above 48 KB is dynamic (set once
// per kernel).
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; the entry returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_layout.cuh"
#include "dropout_hash.cuh"
#include "hopper.cuh"

namespace {

using dropout_hash::Params;

constexpr int kBQ = 64;       // query rows per fp32 block
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Key rows per fp32 K/V tile: 64, or 32 above d 128 (shared memory).
template <int D>
__host__ __device__ constexpr int key_tile() {
  return D <= 128 ? 64 : 32;
}

// fp32 head widths above 256 go in chunks of this many columns.
constexpr int kWideChunk = 128;

template <int D>
struct Tile {
  static constexpr int kBK = key_tile<D>();
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

// Copy columns [col0, col0 + D) of rows [row0, row0 + rows) of one head
// (starting at element `base`) into an fp32 shared tile with row stride ld;
// rows past seq and (WIDE) columns past head_dim are zero.
template <int D, bool WIDE>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int64_t base, int64_t row_stride,
                                          int row0, int rows, int seq,
                                          int col0, int head_dim) {
  constexpr int kPerRow = D / 4;  // 16-byte chunks per row
  constexpr int ld = Tile<D>::kLd;
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

// fp32 inputs: grid = (ceil(seq / 64) * ceil(head_dim / D), heads, batch),
// block = 128 threads.  D is the head width, or the chunk width of a wider
// head (WIDE).
template <int D, bool WIDE>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fp32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ bias,
                      float* __restrict__ out, float* __restrict__ lse,
                      int seq, int heads, int head_dim, Layout lay,
                      float sm_scale, int causal, Params drop) {
  using L = Tile<D>;
  constexpr int BK = L::kBK;
  constexpr int NS = BK / 8;  // S columns per thread
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

  // Chunks of the QK^T reduction = output slices (1 up to d 256).
  const int nchunks = WIDE ? (head_dim + D - 1) / D : 1;
  const int tid = threadIdx.x;
  const int q0 = (blockIdx.x / nchunks) * kBQ;
  const int col0 = (blockIdx.x % nchunks) * D;  // first output column
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t base = lay.base(b, h);
  const int64_t brow = (int64_t)b * seq;           // bias row
  const uint32_t bh = (uint32_t)(b * heads + h);  // dropout stream key

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

  if (nchunks == 1)
    load_tile<D, WIDE>(Qs, q, base, lay.row, q0, kBQ, seq, 0, head_dim);

  int num_kv = (seq + BK - 1) / BK;
  if (causal) {
    const int last = min(q0 + kBQ, seq) - 1;  // last query row of the tile
    num_kv = min(num_kv, last / BK + 1);
  }

  for (int kt = 0; kt < num_kv; ++kt) {
    const int k0 = kt * BK;

    // S = Q K^T * scale + bias, masked.
    {
      float acc[4][NS];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NS; ++j) acc[i][j] = 0.f;
      for (int ch = 0; ch < nchunks; ++ch) {
        __syncthreads();  // the previous products are done with the tiles
        if (nchunks > 1)
          load_tile<D, WIDE>(Qs, q, base, lay.row, q0, kBQ, seq, ch * D,
                             head_dim);
        load_tile<D, WIDE>(Ks, k, base, lay.row, k0, BK, seq, ch * D, head_dim);
        if (ch == 0) {
          load_tile<D, WIDE>(Vs, v, base, lay.row, k0, BK, seq, col0, head_dim);
          if (tid < BK)
            Bs[tid] = (k0 + tid < seq) ? bias[brow + k0 + tid] : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
          float4 qv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            qv[i] =
                *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * ld + d);
#pragma unroll
          for (int j = 0; j < NS; ++j) {
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
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const int qpos = q0 + r;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
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
      for (int jj = 0; jj < BK / 2; ++jj) mx = fmaxf(mx, srow_p[2 * jj + half]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_i, mx);
      const float alpha = expf(m_i - m_new);
      float sum = 0.f;
#pragma unroll 8
      for (int jj = 0; jj < BK / 2; ++jj) {
        const int c = 2 * jj + half;
        const float p = expf(srow_p[c] - m_new);
        sum += p;  // l sums the undropped P
        float pd = p;
        if (drop.on)
          pd = dropout_hash::keep(drop.seed, bh, q0 + srow, k0 + c,
                                  drop.threshold)
                   ? p * drop.scale
                   : 0.f;
        srow_p[c] = pd;
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
      for (int kk = 0; kk < BK; ++kk) {
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
    if (q0 + srow < seq && col0 == 0)
      lse[((int64_t)b * heads + h) * seq + q0 + srow] = m_i + logf(l_safe);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= seq) continue;
    const float l = Ls[r];
    float* orow = out + base + (int64_t)(q0 + r) * lay.row + col0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (WIDE && col0 + tx * 4 + 32 * j >= head_dim) continue;
      *reinterpret_cast<float4*>(orow + tx * 4 + 32 * j) =
          make_float4(o[i][4 * j] / l, o[i][4 * j + 1] / l,
                      o[i][4 * j + 2] / l, o[i][4 * j + 3] / l);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma + TMA (see the header note).

constexpr int kWgThreads = 384;    // producer warpgroup + 2 consumers
constexpr int kWgBQ = 128;         // query rows per CTA (64 per consumer)
constexpr int kSliceCols = 256;    // output columns per CTA above d 256
constexpr int kSmemBudget = 200 * 1024;

// Shared-memory plan of one instantiation: BK keys a tile, NC 64-wide
// boxes of the head held resident for Q (0: Q streams with K, the route
// above d 256), NV 64-column boxes of output (V) a CTA.
template <int BK, int NC, int NV>
struct FwdPlan {
  static constexpr bool kStream = NC == 0;
  static constexpr int kBox = BK * hopper::kBoxRowBytes;     // K or V box
  static constexpr int kQBox = kWgBQ * hopper::kBoxRowBytes;  // Q box
  static constexpr int kQBytes = kStream ? 0 : NC * kQBox;
  static constexpr int kStage =
      kStream ? (kQBox + kBox > NV * kBox ? kQBox + kBox : NV * kBox)
              : (NC + NV) * kBox;
  static constexpr int kStagesFit = (kSmemBudget - kQBytes) / kStage;
  static constexpr int kStages = kStagesFit < 4 ? kStagesFit : 4;
  static constexpr int kBias = kQBytes + kStages * kStage;   // BK floats each
  static constexpr int kBars = kBias + kStages * BK * 4;
  // + the Q barrier, full and empty per stage; + 1024 to align the base
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;
  static_assert(kStages >= 2, "the ring needs two stages");
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~(uintptr_t)1023);
}

// grid = (heads * slices, ceil(seq / 128), batch), block = 384 threads.
template <int BK, int NC, int NV>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int seq, int heads,
                       int head_dim, Layout lay, float scale_log2, int causal,
                       Params drop) {
  using P = FwdPlan<BK, NC, NV>;
  constexpr int ST = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* bias_s = reinterpret_cast<float*>(smem + P::kBias);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + P::kBars);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + ST;

  const int nsplit = P::kStream ? (head_dim + kSliceCols - 1) / kSliceCols : 1;
  const int h = blockIdx.x / nsplit;
  const int split = blockIdx.x % nsplit;
  const int b = blockIdx.z;
  const int nq = (seq + kWgBQ - 1) / kWgBQ;
  const int q0 = (causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y) * kWgBQ;
  const int col0 = split * kSliceCols;
  const int nc = P::kStream ? head_dim / hopper::kBoxCols : NC;
  const int nv = P::kStream ? min(NV, (head_dim - col0) / hopper::kBoxCols)
                            : NV;
  const int kend = causal ? min(seq, q0 + kWgBQ) : seq;
  const int ntiles = (kend + BK - 1) / BK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(qbar, 1);
    for (int i = 0; i < ST; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, 2);  // one arrival per consumer
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: warp 0 issues the loads and writes the key bias ----
    hopper::reg_dealloc<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        hopper::prefetch_map(&qmap);
        hopper::prefetch_map(&kmap);
        hopper::prefetch_map(&vmap);
        if constexpr (!P::kStream) {
          hopper::mbar_expect_tx(qbar, NC * P::kQBox);
          for (int c = 0; c < NC; ++c)
            hopper::tma_load_4d(smem + c * P::kQBox, &qmap, qbar, c * 64, q0,
                                h, b);
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
                      ? bias[(int64_t)b * seq + k0 + i] * kLog2e
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
              uint8_t* stage = smem + st * P::kStage;
              hopper::mbar_expect_tx(full + st, P::kQBox + P::kBox);
              hopper::tma_load_4d(stage, &qmap, full + st, c * 64, q0, h, b);
              hopper::tma_load_4d(stage + P::kQBox, &kmap, full + st, c * 64,
                                  k0, h, b);
            }
            if (++st == ST) { st = 0; ph ^= 1; }
          }
        }
        // the V (and, Q resident, K) stage with its bias
        hopper::mbar_wait(empty + st, ph ^ 1);
        float* bs = bias_s + st * BK;
#pragma unroll
        for (int x = 0; x < (BK + 31) / 32; ++x)
          if (lane + 32 * x < BK) bs[lane + 32 * x] = bv[x];
#pragma unroll
        for (int x = 0; x < NB; ++x) bv[x] = bnext[x];
        __syncwarp();
        if (lane == 0) {
          uint8_t* stage = smem + P::kQBytes + st * P::kStage;
          hopper::mbar_expect_tx(full + st,
                                 (P::kStream ? nv : NC + NV) * P::kBox);
          if constexpr (!P::kStream)
            for (int c = 0; c < NC; ++c)
              hopper::tma_load_4d(stage + c * P::kBox, &kmap, full + st,
                                  c * 64, k0, h, b);
          uint8_t* vs = stage + (P::kStream ? 0 : NC * P::kBox);
          for (int c = 0; c < nv; ++c)
            hopper::tma_load_4d(vs + c * P::kBox, &vmap, full + st,
                                col0 + c * 64, k0, h, b);
        }
        if (++st == ST) { st = 0; ph ^= 1; }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    hopper::reg_alloc<232>();
    const int ct = threadIdx.x - 128;
    const int cw = ct >> 7;          // consumer warpgroup
    const int lt = ct & 127;
    const int warp = lt >> 5;
    const int lane = lt & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int wq0 = q0 + cw * 64;    // the warpgroup's first query row
    const int r0 = wq0 + warp * 16 + g;
    const int r1 = r0 + 8;
    const uint32_t bh = (uint32_t)(b * heads + h);
    const uint32_t sbase = hopper::smem_u32(smem);

    float o[NV][32];
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[v][i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf;  // running max (log2 units)
    float l0 = 0.f, l1 = 0.f;          // this thread's partial row sums

    // Q resident: the consumers take turns to issue their products (named
    // barriers 1 and 2), so one's softmax runs while the other's products
    // hold the tensor cores; consumer 0 goes first.
    if constexpr (!P::kStream) {
      if (cw == 1) hopper::bar_arrive(1, 256);
      hopper::mbar_wait(qbar, 0);
    }
    int st = 0;
    uint32_t ph = 0;
    for (int j = 0; j < ntiles; ++j) {
      const int k0 = j * BK;
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      if constexpr (!P::kStream) {
        hopper::mbar_wait(full + st, ph);
        const uint32_t kst = sbase + P::kQBytes + st * P::kStage;
        hopper::bar_sync(1 + cw, 256);  // this consumer's turn to issue
        hopper::wgmma_fence();
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hopper::wgmma_ss<BK>(
                s, sbase + c * P::kQBox + cw * 64 * 128 + kk * 32,
                kst + c * P::kBox + kk * 32);
        hopper::wgmma_commit();
        hopper::bar_arrive(2 - cw, 256);  // the other consumer's turn
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
      } else {
        for (int c = 0; c < nc; ++c) {
          hopper::mbar_wait(full + st, ph);
          const uint32_t qst = sbase + st * P::kStage;
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hopper::wgmma_ss<BK>(s, qst + cw * 64 * 128 + kk * 32,
                                 qst + P::kQBox + kk * 32);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(s);
          if (lt == 0) hopper::mbar_arrive(empty + st);
          if (++st == ST) { st = 0; ph ^= 1; }
        }
        hopper::mbar_wait(full + st, ph);
      }

      // Scale, bias, masks (base-2 units); the tile's row max.
      const float* bs = bias_s + st * BK;
      const bool masked =
          k0 + BK > seq || (causal && k0 + BK - 1 > wq0);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const float2 bv = *reinterpret_cast<const float2*>(bs + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = fmaf(s[4 * n + e], scale_log2, (e & 1) ? bv.y : bv.x);
          if (masked) {
            const int kpos = k0 + 8 * n + 2 * t + (e & 1);
            const int qpos = (e < 2) ? r0 : r1;
            if (causal && qpos < kpos) x = kNegInf;
            if (kpos >= seq) x = -INFINITY;
          }
          s[4 * n + e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = hopper::exp2_ftz(m0 - mn0);
      const float a1 = hopper::exp2_ftz(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        s[4 * n] = hopper::exp2_ftz(s[4 * n] - mn0);
        s[4 * n + 1] = hopper::exp2_ftz(s[4 * n + 1] - mn0);
        s[4 * n + 2] = hopper::exp2_ftz(s[4 * n + 2] - mn1);
        s[4 * n + 3] = hopper::exp2_ftz(s[4 * n + 3] - mn1);
        sum0 += s[4 * n] + s[4 * n + 1];
        sum1 += s[4 * n + 2] + s[4 * n + 3];
      }
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
      if (drop.on) {  // l summed the undropped P; PV takes the dropped one
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * n + 2 * t + (e & 1);
            const int qpos = (e < 2) ? r0 : r1;
            s[4 * n + e] = dropout_hash::keep(drop.seed, bh, qpos, kpos,
                                              drop.threshold)
                               ? s[4 * n + e] * drop.scale
                               : 0.f;
          }
      }
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          o[v][4 * n] *= a0;
          o[v][4 * n + 1] *= a0;
          o[v][4 * n + 2] *= a1;
          o[v][4 * n + 3] *= a1;
        }

      // O += P V, P rounded to bf16 in the register A fragments.
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) hopper::a_fragment(pa[kk], s, kk);
      const uint32_t vst = sbase + P::kQBytes + st * P::kStage +
                           (P::kStream ? 0 : NC * P::kBox);
      if (!P::kStream) hopper::bar_sync(1 + cw, 256);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (!P::kStream || v < nv)
            hopper::wgmma_rs64(o[v], pa[kk],
                               hopper::desc_sw128(vst + v * P::kBox +
                                                  kk * 16 * 128));
      hopper::wgmma_commit();
      if (!P::kStream) hopper::bar_arrive(2 - cw, 256);
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int v = 0; v < NV; ++v) hopper::fence_regs(o[v]);
      if (lt == 0) hopper::mbar_arrive(empty + st);
      if (++st == ST) { st = 0; ph ^= 1; }
    }

    // Row sums across the quad, then O / l and LSE.
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
    if (t == 0 && split == 0) {
      float* lrow = lse + ((int64_t)b * heads + h) * seq;
      if (r0 < seq) lrow[r0] = m0 * kLn2 + logf(ls0);
      if (r1 < seq) lrow[r1] = m1 * kLn2 + logf(ls1);
    }
    // O / l of the consumer's rows, staged in shared memory (both
    // consumers are done with it) and written in 16-byte rows.
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[v][4 * n] = o[v][4 * n] / ls0;
        o[v][4 * n + 1] = o[v][4 * n + 1] / ls0;
        o[v][4 * n + 2] = o[v][4 * n + 2] / ls1;
        o[v][4 * n + 3] = o[v][4 * n + 3] / ls1;
      }
    hopper::bar_sync(3, 256);
    __nv_bfloat16* buf =
        reinterpret_cast<__nv_bfloat16*>(smem) + cw * 64 * (NV * 64 + 8);
    hopper::store_tile_bf16<NV>(
        o, P::kStream ? nv : NV, buf,
        out + lay.base(b, h) + (int64_t)wq0 * lay.row + col0, lay.row,
        seq - wq0, 4 + cw, lt);
  }
}

// ---------------------------------------------------------------------------

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  void* out;
  float* lse;
  int batch, seq, heads, head_dim;
  Layout lay;
  float sm_scale;
  int causal;
  Params drop;
};

template <int D, bool WIDE = false>
int launch_fp32(const Args& a, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  auto kernel = flash_fwd_fp32_kernel<D, WIDE>;
  const int err = set_smem_limit(kernel, Tile<D>::kBytes, done);
  if (err) return err;
  const int nchunks = WIDE ? (a.head_dim + D - 1) / D : 1;
  const dim3 grid((unsigned)((a.seq + kBQ - 1) / kBQ * nchunks),
                  (unsigned)a.heads, (unsigned)a.batch);
  kernel<<<grid, kThreads, Tile<D>::kBytes, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.bias, static_cast<float*>(a.out),
      a.lse, a.seq, a.heads, a.head_dim, a.lay, a.sm_scale, a.causal,
      a.drop);
  return (int)cudaGetLastError();
}

template <int BK, int NC, int NV>
int launch_wgmma(const Args& a, cudaStream_t stream) {
  using P = FwdPlan<BK, NC, NV>;
  static bool done[kMaxDevices] = {};
  auto kernel = flash_fwd_wgmma_kernel<BK, NC, NV>;
  int err = set_smem_limit(kernel, P::kBytes, done);
  if (err) return err;
  CUtensorMap qm, km, vm;
  const Layout& l = a.lay;
  if ((err = hopper::make_map(&qm, a.q, a.head_dim, a.seq, a.heads, a.batch,
                              l.row, l.head, l.batch, kWgBQ)) ||
      (err = hopper::make_map(&km, a.k, a.head_dim, a.seq, a.heads, a.batch,
                              l.row, l.head, l.batch, BK)) ||
      (err = hopper::make_map(&vm, a.v, a.head_dim, a.seq, a.heads, a.batch,
                              l.row, l.head, l.batch, BK)))
    return err;
  const int nsplit =
      P::kStream ? (a.head_dim + kSliceCols - 1) / kSliceCols : 1;
  const dim3 grid((unsigned)(a.heads * nsplit),
                  (unsigned)((a.seq + kWgBQ - 1) / kWgBQ), (unsigned)a.batch);
  kernel<<<grid, kWgThreads, P::kBytes, stream>>>(
      qm, km, vm, a.bias, static_cast<__nv_bfloat16*>(a.out), a.lse, a.seq,
      a.heads, a.head_dim, a.lay, a.sm_scale * kLog2e, a.causal, a.drop);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_packed_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    void* lse, int batch, int seq, int heads, int head_dim,
    int64_t batch_stride, int64_t head_stride, int64_t row_stride,
    float sm_scale, int causal, uint32_t seed, uint32_t threshold,
    float keep_scale, int dropout, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, static_cast<const float*>(bias), out,
               static_cast<float*>(lse), batch, seq, heads, head_dim,
               Layout{batch_stride, head_stride, row_stride}, sm_scale,
               causal, Params{seed, threshold, keep_scale, dropout}};
  if (head_dim <= 0 || head_dim % 64) return (int)cudaErrorInvalidValue;
  if (dtype == kF32) {
    switch (head_dim) {
      case 64: return launch_fp32<64>(a, s);
      case 128: return launch_fp32<128>(a, s);
      case 192: return launch_fp32<192>(a, s);
      case 256: return launch_fp32<256>(a, s);
      default: return launch_fp32<kWideChunk, true>(a, s);
    }
  }
  if (dtype == kBF16) {
    switch (head_dim) {
      case 64: return launch_wgmma<128, 1, 1>(a, s);
      case 128: return launch_wgmma<128, 2, 2>(a, s);
      case 192: return launch_wgmma<64, 3, 3>(a, s);
      case 256: return launch_wgmma<64, 4, 4>(a, s);
      default: return launch_wgmma<64, 0, 4>(a, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
