// Paged decode attention for sm_90a: split-KV, shared-table row groups and
// bulk asynchronous copies.
//
// Replaces the Pallas kernel `paged_attention_kernel` of
// paddle_tpu/ops/pallas/paged_attention.py (line 116): for each query row s
// with one token, out[s] = softmax(q[s] . K[s]^T * sm_scale) . V[s], with K/V
// gathered block by block through block_tables[s, :] and masked to
// positions < context_lens[s].  Caches are fp32, bf16 or int8; int8 blocks
// carry a per-block fp32 (k_scale, v_scale) pair.
//
// Numerics: q and K/V values go to fp32; scores, the running max m, the sum
// l and the accumulator acc are fp32 (online softmax: m' = max(m, new
// scores), alpha = 2^(m - m'), p = 2^(score - m'), l = l alpha + sum p,
// acc = acc alpha + p . V, scores in log2 units: sm_scale log2(e) folded
// in, ex2.approx); positions past the context add exactly 0; with bf16
// caches p is rounded to bf16 before p . V while l sums the unrounded p;
// out = acc / max(l, 1e-30), so a row with context_len 0 is exactly 0.
// int8 blocks keep their scales out of the dots: score = (q . k8) (k_scale
// sm_scale) and acc += (p v_scale) v8, with int8 -> fp32 by a byte permute
// and one exact subtract (no I2F, no per-element scale).
//
// What bounds it on the H100: bytes.  A row does ~4 d flops for each K/V
// token it reads (2 d elements), far below fp32 FMA's ~20 flops per byte,
// so the time is the live context's K/V bytes over 3.35 TB/s.  What stood
// in the way (the previous kernel: one 8-warp CTA a row, synchronous
// loads, a warp-wide max and sum every block): a 64-row call filled 64 of
// 132 SMs with ~16 KB in flight each, and rows that share one table (a
// prefill chunk) read the same blocks once a row.  The design:
//   * split-KV: the grid is (row group, KV split); a CTA takes a contiguous
//     range of the table's tiles, clipped to its rows' lengths (a CTA whose
//     range starts past them exits), and writes a partial (m, l, acc[d]) to
//     fp32 scratch that the wrapper allocates for the call.  A merge kernel
//     combines a row's partials in one fixed order, so a call repeats bit
//     for bit; no state outlives a call (no counters), so a call can be
//     captured in a CUDA graph.  The split count comes from the wrapper's
//     plan (shapes only, never context_lens);
//   * bulk asynchronous copies: a tile is up to kSlotBytes of K (and of V):
//     whole cache blocks, or a part of one, copied with cp.async.bulk into a
//     ring of stages and counted on mbarriers, issued ahead of the
//     consumers, only for live tokens, V's copy beside K's; the CTA's table
//     entries (and int8 scales) are staged in shared memory at its start,
//     so no copy waits on a table read;
//   * one-row groups (own tables: a decode step): a CTA of kRowWarps warps
//     for one row, warp w taking every kRowWarps-th tile of the range
//     through its own kRowStages-slot ring (its lanes issue the copies); a
//     token row is covered by G lanes, and each of a warp's 32 / G lane
//     groups keeps an online softmax of its own over its tokens, so nothing
//     warp-wide runs inside the loop; the CTA's groups merge at the end;
//   * shared-table groups (table row stride 0, where the wrapper's plan
//     takes this route for the cache type: a prefill chunk): a CTA of
//     kSharedWarps warps takes up to 64 rows (d 128) against its range; each
//     tile comes into shared memory once (warp 0 issues) and every row reads
//     it, a lane holding kRowsPerLane rows x 16 columns, so a 16-byte read
//     feeds 4 rows; each row masked by its own length.
// No tensor cores: fp32 products stay fp32 (TF32 would break the fp32
// tolerance), and a row against a stream of K/V rows has no reuse.
//
// C interface (bound with ctypes): pointers and the stream are `void*`; the
// entry returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxBlockSize = 64;   // tokens per cache block
constexpr int kMaxDim = 256;
constexpr int kSlotBytes = 4096;    // one K (and one V) tile of a ring stage
constexpr int kMaxTileTokens = 64;
constexpr int kSharedTileTokens = 8;  // a shared-table tile's tokens at most
constexpr int kMaxTileCopies = 32;  // bulk copies of one tile (one a lane)
constexpr int kRowWarps = 4;        // warps of a one-row CTA
constexpr int kRowStages = 3;       // ring slots of each of its warps
constexpr int kSharedWarps = 4;     // warps of a shared-table CTA
constexpr int kSharedStages = 4;    // its ring slots
constexpr int kRowsPerLane = 4;     // rows a lane of it holds
constexpr int kSharedCols = 16;     // columns a lane of it holds
constexpr int kSub = 4;             // tokens a shared-table lane scores at once
constexpr int kRowUnroll = 2;       // tokens a one-row lane group scores at
                                    // once (twice that for int8)
constexpr int kMaxSplits = 256;
constexpr int kWindow = 256;        // table entries (and scales) a CTA stages
constexpr int kMergeThreads = 256;
constexpr float kNegInf = -1e30f;

// dtype codes shared with the Python wrapper.
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kI8 = 2;

struct Params {
  const void* q;
  const uint8_t* k;
  const uint8_t* v;
  const int* tables;
  int64_t table_stride;
  const int* lens;
  const float* scales;
  void* out;
  float* ws;        // (num_seqs, splits, d) acc, then (num_seqs, splits, 2)
  int num_seqs, d, bs, width;   // width: the table's blocks
  float sm_scale;
  int q_dtype;
  int row_bytes;     // d * element size
  int tile_tokens;   // tokens a tile covers
  int copy_tokens;   // tokens of one bulk copy (a block, or the tile)
  int copies;        // bulk copies a tile
  int tiles;         // tiles of the full table width
  int tps;           // tiles a split
  int splits;
  int rows_per_cta;  // 1, or the shared-table row group
  int lanes_per_row; // shared-table lanes a row (G)
};

// -- element conversions ------------------------------------------------------

// 16 bytes of T as fp32 values (16 / sizeof(T) of them).
__device__ __forceinline__ void unpack16(const uint4& raw, float* f, float) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(const uint4& raw, float* f,
                                         __nv_bfloat16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// int8 b -> fp32 exactly: the byte with its sign bit flipped (b + 128) is
// put under the exponent of 2^23 (0x4B000000) and 2^23 + 128 subtracted.
__device__ __forceinline__ void unpack16(const uint4& raw, float* f, int8_t) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = w[i] ^ 0x80808080u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * i + b] =
          __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650u | b)) -
          8388736.f;
  }
}

__device__ __forceinline__ uint4 lds128(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
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

// q[at .. at + N) in fp32 (N a multiple of 4, at too): 16- or 8-byte
// loads where q is aligned for them.
template <int N>
__device__ __forceinline__ void load_q(const Params& p, int64_t at,
                                       float* f) {
  const bool vec = (reinterpret_cast<uintptr_t>(p.q) & 15) == 0;
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    if (p.q_dtype == kF32) {
      const float* q = static_cast<const float*>(p.q) + at + i;
      const float4 x = vec ? *reinterpret_cast<const float4*>(q)
                           : make_float4(q[0], q[1], q[2], q[3]);
      f[i] = x.x;
      f[i + 1] = x.y;
      f[i + 2] = x.z;
      f[i + 3] = x.w;
    } else {
      const __nv_bfloat16* q =
          static_cast<const __nv_bfloat16*>(p.q) + at + i;
      uint2 x;
      if (vec) {
        x = *reinterpret_cast<const uint2*>(q);
      } else {
        const uint16_t* h = reinterpret_cast<const uint16_t*>(q);
        x = make_uint2(h[0] | (uint32_t)h[1] << 16,
                       h[2] | (uint32_t)h[3] << 16);
      }
      f[i] = __uint_as_float(x.x << 16);
      f[i + 1] = __uint_as_float(x.x & 0xffff0000u);
      f[i + 2] = __uint_as_float(x.y << 16);
      f[i + 3] = __uint_as_float(x.y & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ void store_out(const Params& p, int64_t at,
                                          float r) {
  if (p.q_dtype == kF32)
    static_cast<float*>(p.out)[at] = r;
  else
    static_cast<__nv_bfloat16*>(p.out)[at] = __float2bfloat16_rn(r);
}

__device__ __forceinline__ int row_len(const Params& p, int row) {
  return max(0, min(p.lens[row], p.width * p.bs));
}

// Tiles a context of `len` tokens covers, and the splits that hold them.
__device__ __forceinline__ int live_tiles(const Params& p, int len) {
  return (len + p.tile_tokens - 1) / p.tile_tokens;
}
__device__ __forceinline__ int live_splits(const Params& p, int len) {
  return (live_tiles(p, len) + p.tps - 1) / p.tps;
}

// The longest (clipped) length of the rows [row0, row0 + rows_per_cta).
__device__ int group_len(const Params& p, int row0, int* s_len) {
  if (threadIdx.x == 0) *s_len = 0;
  __syncthreads();
  int mx = 0;
  const int end = min(row0 + p.rows_per_cta, p.num_seqs);
  for (int r = row0 + threadIdx.x; r < end; r += blockDim.x)
    mx = max(mx, row_len(p, r));
  atomicMax(s_len, mx);
  __syncthreads();
  return *s_len;
}

// -- tile copies --------------------------------------------------------------

// The CTA's table entries from block j0 on (and, for int8 caches, their
// (k_scale sm_scale, v_scale)), staged in shared memory at its start; a
// block past the window is read from device memory.
struct Window {
  int j0;
  int bid[kWindow];
  float ks[kWindow];
  float vs[kWindow];
};

__device__ __forceinline__ int block_id(const Window& w, const int* table,
                                        int j) {
  const int i = j - w.j0;
  return i < kWindow ? w.bid[i] : table[j];
}

// Stage the bids of blocks [j0, j1) (all threads; a barrier follows): the
// split's whole range, read while the lengths are read.
__device__ __forceinline__ void stage_bids(Window& w, const int* table,
                                           int j0, int j1) {
  for (int i = threadIdx.x; i < min(j1 - j0, kWindow); i += blockDim.x)
    w.bid[i] = table[j0 + i];
}

// Stage their scales once the bids are visible (a barrier follows).
__device__ __forceinline__ void stage_scales(const Params& p, Window& w,
                                             int j1) {
  for (int i = threadIdx.x; i < min(j1 - w.j0, kWindow); i += blockDim.x) {
    const int bid = w.bid[i];
    w.ks[i] = p.scales[2 * bid] * p.sm_scale;
    w.vs[i] = p.scales[2 * bid + 1];
  }
}

// (k_scale sm_scale, v_scale) of token position pos.
__device__ __forceinline__ float2 block_scales(const Params& p,
                                               const Window& w,
                                               const int* table, int pos) {
  const int j = pos / p.bs;
  const int i = j - w.j0;
  if (i < kWindow) return make_float2(w.ks[i], w.vs[i]);
  const int bid = table[j];
  return make_float2(p.scales[2 * bid] * p.sm_scale, p.scales[2 * bid + 1]);
}

// Warp-collective: bring tile t's live tokens (below live_end) of K and V
// into kdst / vdst, counted on fk / fv, one bulk copy a lane.
__device__ __forceinline__ void issue_tile(const Params& p, const Window& w,
                                           const int* table, int t,
                                           int live_end, uint8_t* kdst,
                                           uint8_t* vdst, uint64_t* fk,
                                           uint64_t* fv, int lane) {
  const int p0 = t * p.tile_tokens;
  const int end = min(p0 + p.tile_tokens, live_end);
  if (lane == 0) {
    const uint32_t bytes = (uint32_t)(end - p0) * p.row_bytes;
    hopper::mbar_expect_tx(fk, bytes);
    hopper::mbar_expect_tx(fv, bytes);
  }
  __syncwarp();
  const int pos = p0 + lane * p.copy_tokens;
  if (lane < p.copies && pos < end) {
    const int j = pos / p.bs;
    const int bid = block_id(w, table, j);
    const int n = min(p.copy_tokens, end - pos);
    const int64_t off = ((int64_t)bid * p.bs + pos - j * p.bs) * p.row_bytes;
    const uint32_t dst = (uint32_t)(lane * p.copy_tokens * p.row_bytes);
    hopper::bulk_load(kdst + dst, p.k + off, (uint32_t)n * p.row_bytes, fk);
    hopper::bulk_load(vdst + dst, p.v + off, (uint32_t)n * p.row_bytes, fv);
  }
}

// -- partials -----------------------------------------------------------------

__device__ __forceinline__ float* part_acc(const Params& p, int row,
                                           int split) {
  return p.ws + ((int64_t)row * p.splits + split) * p.d;
}
__device__ __forceinline__ float* part_ml(const Params& p, int row,
                                          int split) {
  return p.ws + (int64_t)p.num_seqs * p.splits * p.d +
         ((int64_t)row * p.splits + split) * 2;
}

// The merge kernel's CTA combines the nw partials of `row` into out (m in
// log2 units):
// every (m, l) read in one pass, their max and the sum of the weights by a
// fixed shuffle tree over the splits; each 4 columns' sum by blockDim /
// (d / 4) split lanes taking every so-many-th split in order, then added
// in lane order.  s_red: blockDim float4s (>= 2 kMaxSplits floats).
__device__ void merge_row(const Params& p, int row, int nw, float* s_f,
                          float4* s_red) {
  float2* s_ml = reinterpret_cast<float2*>(s_red);
  for (int s = threadIdx.x; s < nw; s += blockDim.x)
    s_ml[s] = __ldcg(reinterpret_cast<const float2*>(part_ml(p, row, s)));
  __syncthreads();
  if (threadIdx.x < 32) {
    float mx = kNegInf;
    for (int s = threadIdx.x; s < nw; s += 32) mx = fmaxf(mx, s_ml[s].x);
    mx = warp_max(mx);
    float den = 0.f;
    for (int s = threadIdx.x; s < nw; s += 32) {
      const float f = hopper::exp2_ftz(s_ml[s].x - mx);
      s_f[s] = f;
      den += s_ml[s].y * f;
    }
    den = warp_sum(den);
    if (threadIdx.x == 0) s_f[kMaxSplits] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  const int nc = p.d / 4;
  const int lanes = blockDim.x / nc;
  const int c = threadIdx.x % nc;
  const int sl = threadIdx.x / nc;
  if (sl < lanes) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = sl; s < nw; s += lanes) {
      const float4 x =
          __ldcg(reinterpret_cast<const float4*>(part_acc(p, row, s)) + c);
      const float f = s_f[s];
      a.x += x.x * f;
      a.y += x.y * f;
      a.z += x.z * f;
      a.w += x.w * f;
    }
    s_red[threadIdx.x] = a;
  }
  __syncthreads();
  if ((int)threadIdx.x < nc) {
    float4 a = s_red[c];
    for (int l = 1; l < lanes; ++l) {
      const float4 x = s_red[l * nc + c];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    const float den = s_f[kMaxSplits];
    const int64_t at = (int64_t)row * p.d + 4 * c;
    store_out(p, at, a.x / den);
    store_out(p, at + 1, a.y / den);
    store_out(p, at + 2, a.z / den);
    store_out(p, at + 3, a.w / den);
  }
}

// -- one-row groups -----------------------------------------------------------

// Scores are kept in log2 units (sm_scale log2(e) folded in), exponentials
// are ex2.approx: p = 2^(s - m).
constexpr float kLog2e = 1.4426950408889634f;

// TKV: cache element type.  G: lanes a token (a power of two); NC: 16-byte
// chunks a lane covers (G NC chunks >= a row).  A warp holds 32 / G lane
// groups, each an online softmax of its own over the tokens grp, grp +
// 32 / G, ... of every tile: nothing warp-wide inside the loop.  Lane gl of
// group grp covers chunks (m G + gl + grp G) mod (G NC), m < NC: rotated by
// group, so the groups' reads of neighbouring token rows fall in different
// banks while each lane's columns (its q and acc) stay in registers.  At
// the end the CTA's lane groups merge in group order.
template <typename TKV, int G, int NC>
__global__ void __launch_bounds__(kRowWarps * 32)
paged_attn_rows_kernel(const Params p) {
  constexpr int VEC = 16 / (int)sizeof(TKV);
  constexpr int TPW = 32 / G;        // lane groups a warp
  constexpr int GROUPS = kRowWarps * TPW;
  constexpr int U = kRowUnroll * (sizeof(TKV) == 1 ? 2 : 1);
  constexpr bool kQuant = sizeof(TKV) == 1;
  constexpr bool kRoundP = sizeof(TKV) == 2;

  extern __shared__ __align__(128) uint8_t ring_smem[];
  __shared__ __align__(8) uint64_t bars[kRowWarps][kRowStages][2];
  __shared__ Window win;
  __shared__ float s_m[GROUPS];
  __shared__ float s_l[GROUPS];
  __shared__ float s_f[GROUPS];

  const int row = blockIdx.x;
  const int split = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / G;
  const int gl = lane % G;
  const int nv = p.row_bytes / 16;
  const int* table = p.tables + (int64_t)row * p.table_stride;

  // this lane's chunks, q over them in fp32, the split's table entries and
  // the row's length: one round trip
  int cm[NC];
  float qf[NC][VEC];
#pragma unroll
  for (int m = 0; m < NC; ++m) {
    cm[m] = (m * G + gl + grp * G) % (G * NC);
    if (cm[m] < nv)
      load_q<VEC>(p, (int64_t)row * p.d + cm[m] * VEC, qf[m]);
    else
#pragma unroll
      for (int i = 0; i < VEC; ++i) qf[m][i] = 0.f;
  }
  const int t_begin = split * p.tps;
  const int j0 = t_begin * p.tile_tokens / p.bs;
  const int j1 =
      min(((t_begin + p.tps) * p.tile_tokens - 1) / p.bs + 1, p.width);
  stage_bids(win, table, j0, j1);
  const int len = row_len(p, row);
  const int ntl = live_tiles(p, len);
  const int nw = live_splits(p, len);
  if (split >= max(nw, 1)) return;  // the range starts past the context
  const int t_end = min(t_begin + p.tps, ntl);
  if (threadIdx.x == 0) {
    win.j0 = j0;
    for (int w = 0; w < kRowWarps; ++w)
      for (int s = 0; s < kRowStages; ++s) {
        hopper::mbar_init(&bars[w][s][0], 1);
        hopper::mbar_init(&bars[w][s][1], 1);
      }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // this warp's tiles: first, first + kRowWarps, ... below t_end
  const int first = t_begin + warp;
  const int n_my = first < t_end ? (t_end - first + kRowWarps - 1) / kRowWarps
                                 : 0;
  uint8_t* ring = ring_smem + warp * kRowStages * 2 * kSlotBytes;
  for (int s = 0; s < kRowStages && s < n_my; ++s)
    issue_tile(p, win, table, first + s * kRowWarps, len,
               ring + s * 2 * kSlotBytes,
               ring + s * 2 * kSlotBytes + kSlotBytes, &bars[warp][s][0],
               &bars[warp][s][1], lane);
  if (kQuant) stage_scales(p, win, j1);
  __syncthreads();
  const float qk_scale = p.sm_scale * kLog2e;

  float m_run = kNegInf, l = 0.f;
  float acc[NC][VEC];
#pragma unroll
  for (int m = 0; m < NC; ++m)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[m][i] = 0.f;

  for (int it = 0; it < n_my; ++it) {
    const int s = it % kRowStages;
    const uint32_t parity = (uint32_t)(it / kRowStages) & 1u;
    const int t = first + it * kRowWarps;
    const int p0 = t * p.tile_tokens;
    const int nt = min(p.tile_tokens, len - p0);
    const uint8_t* kt = ring + s * 2 * kSlotBytes;
    const uint8_t* vt = kt + kSlotBytes;

    hopper::mbar_wait(&bars[warp][s][0], parity);
    hopper::mbar_wait(&bars[warp][s][1], parity);
    for (int t0 = 0; t0 < nt; t0 += TPW * U) {
      // U tokens' scores (rows past nt read row nt - 1, masked below)
      float sc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint8_t* kr =
            kt + min(t0 + u * TPW + grp, nt - 1) * p.row_bytes;
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          float kf[VEC];
          unpack16(cm[m] < nv ? lds128(kr + cm[m] * 16)
                              : make_uint4(0u, 0u, 0u, 0u),
                   kf, TKV());
#pragma unroll
          for (int i = 0; i < VEC; i += 2) {
            d0 += qf[m][i] * kf[i];
            d1 += qf[m][i + 1] * kf[i + 1];
          }
        }
        sc[u] = group_sum<G>(d0 + d1);
      }
      float vs[U];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int tt = t0 + u * TPW + grp;
        float ks = qk_scale;
        vs[u] = 1.f;
        if (kQuant && tt < nt) {
          const float2 bsc = block_scales(p, win, table, p0 + tt);
          ks = bsc.x * kLog2e;
          vs[u] = bsc.y;
        }
        sc[u] = tt < nt ? sc[u] * ks : kNegInf;
        mx = fmaxf(mx, sc[u]);
      }
      if (mx > m_run) {
        const float alpha = hopper::exp2_ftz(m_run - mx);
        l *= alpha;
#pragma unroll
        for (int m = 0; m < NC; ++m)
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[m][i] *= alpha;
        m_run = mx;
      }
      // acc += p . V over the U tokens
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int tt = t0 + u * TPW + grp;
        float pe = tt < nt ? hopper::exp2_ftz(sc[u] - m_run) : 0.f;
        l += pe;
        if (kRoundP) pe = __bfloat162float(__float2bfloat16_rn(pe));
        if (kQuant) pe *= vs[u];
        const uint8_t* vr = vt + min(tt, nt - 1) * p.row_bytes;
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          float vf[VEC];
          unpack16(cm[m] < nv ? lds128(vr + cm[m] * 16)
                              : make_uint4(0u, 0u, 0u, 0u),
                   vf, TKV());
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[m][i] += pe * vf[i];
        }
      }
    }
    __syncwarp();  // the slot is rewritten next
    if (it + kRowStages < n_my) {
      hopper::fence_proxy_async();
      issue_tile(p, win, table, t + kRowStages * kRowWarps, len,
                 ring + s * 2 * kSlotBytes,
                 ring + s * 2 * kSlotBytes + kSlotBytes, &bars[warp][s][0],
                 &bars[warp][s][1], lane);
    }
  }

  // the lane groups' states, merged in group order (the ring is free now:
  // every copy issued was waited for)
  float* s_acc = reinterpret_cast<float*>(ring_smem);  // [GROUPS][d]
  const int group = warp * TPW + grp;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < NC; ++m)
    if (cm[m] < nv)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        s_acc[group * p.d + cm[m] * VEC + i] = acc[m][i];
  if (gl == 0) {
    s_m[group] = m_run;
    s_l[group] = l;
  }
  __syncthreads();
  float mx = kNegInf;
  for (int g = 0; g < GROUPS; ++g) mx = fmaxf(mx, s_m[g]);
  if (threadIdx.x < GROUPS)
    s_f[threadIdx.x] = hopper::exp2_ftz(s_m[threadIdx.x] - mx);
  __syncthreads();
  float lt = 0.f;
  for (int g = 0; g < GROUPS; ++g) lt += s_l[g] * s_f[g];
  const float den = fmaxf(lt, 1e-30f);
  float* pa = nw > 1 ? part_acc(p, row, split) : nullptr;
  for (int e = threadIdx.x; e < p.d; e += kRowWarps * 32) {
    float a = 0.f;
    for (int g = 0; g < GROUPS; ++g) a += s_acc[g * p.d + e] * s_f[g];
    if (pa)
      pa[e] = a;
    else  // the row's only split: the output itself
      store_out(p, (int64_t)row * p.d + e, a / den);
  }
  if (pa && threadIdx.x == 0) {
    part_ml(p, row, split)[0] = mx;
    part_ml(p, row, split)[1] = lt;
  }
}

// -- shared-table row groups --------------------------------------------------

// TKV: cache element type; G: lanes a row set (a power of two >= d / 16).
// A lane holds kSharedCols columns = CPL 16-byte chunks (chunk gl + G m of
// a row, m < CPL) of kRowsPerLane rows; the lanes of a warp that hold the
// same columns read the same bytes (a broadcast).
template <typename TKV, int G>
__global__ void __launch_bounds__(kSharedWarps * 32)
paged_attn_shared_kernel(const Params p) {
  constexpr int VEC = 16 / (int)sizeof(TKV);
  constexpr int CPL = kSharedCols / VEC;
  constexpr int R = kRowsPerLane;
  constexpr bool kQuant = sizeof(TKV) == 1;
  constexpr bool kRoundP = sizeof(TKV) == 2;

  extern __shared__ __align__(128) uint8_t ring_smem[];
  __shared__ __align__(8) uint64_t full[kSharedStages][2];
  __shared__ __align__(8) uint64_t empty[kSharedStages];
  __shared__ Window win;
  __shared__ int s_len;

  const int group = blockIdx.x;
  const int split = blockIdx.y;
  const int row0 = group * p.rows_per_cta;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nv = p.row_bytes / 16;
  const int gl = lane % G;
  const int rbase = row0 + (warp * (32 / G) + lane / G) * R;
  const int* table = p.tables;  // row stride 0: every row's table

  // q of this lane's rows and columns, the split's table entries and the
  // rows' lengths: one round trip
  float qf[R][CPL][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int col = (gl + c * G) * VEC;
      if (rbase + r < p.num_seqs && col < p.d)
        load_q<VEC>(p, (int64_t)(rbase + r) * p.d + col, qf[r][c]);
      else
#pragma unroll
        for (int i = 0; i < VEC; ++i) qf[r][c][i] = 0.f;
    }
  const int t_begin = split * p.tps;
  const int j0 = t_begin * p.tile_tokens / p.bs;
  const int j1 =
      min(((t_begin + p.tps) * p.tile_tokens - 1) / p.bs + 1, p.width);
  stage_bids(win, table, j0, j1);
  const int glen = group_len(p, row0, &s_len);
  const int ntl = live_tiles(p, glen);
  const int nw = live_splits(p, glen);
  if (split >= max(nw, 1)) return;
  const int n = min(t_begin + p.tps, ntl) - t_begin;
  if (threadIdx.x == 0) {
    win.j0 = j0;
    for (int s = 0; s < kSharedStages; ++s) {
      hopper::mbar_init(&full[s][0], 1);
      hopper::mbar_init(&full[s][1], 1);
      hopper::mbar_init(&empty[s], kSharedWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 0)
    for (int s = 0; s < kSharedStages && s < n; ++s)
      issue_tile(p, win, table, t_begin + s, glen,
                 ring_smem + s * 2 * kSlotBytes,
                 ring_smem + s * 2 * kSlotBytes + kSlotBytes, &full[s][0],
                 &full[s][1], lane);
  if (kQuant) stage_scales(p, win, j1);
  __syncthreads();

  int lenr[R];
  float acc[R][CPL][VEC];
  float m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    lenr[r] = rbase + r < p.num_seqs ? row_len(p, rbase + r) : 0;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[r][c][i] = 0.f;
  }
  const float qk_scale = p.sm_scale * kLog2e;

  for (int it = 0; it < n; ++it) {
    const int s = it % kSharedStages;
    const uint32_t parity = (uint32_t)(it / kSharedStages) & 1u;
    const int t = t_begin + it;
    const int p0 = t * p.tile_tokens;
    const int nt = min(p.tile_tokens, glen - p0);
    const uint8_t* kt = ring_smem + s * 2 * kSlotBytes;
    const uint8_t* vt = kt + kSlotBytes;

    hopper::mbar_wait(&full[s][0], parity);
    hopper::mbar_wait(&full[s][1], parity);
    for (int t0 = 0; t0 < nt; t0 += kSub) {
      // kSub tokens' scores for the R rows (rows past nt read row nt - 1)
      float pr[kSub][R];
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        const uint8_t* kr = kt + min(t0 + u, nt - 1) * p.row_bytes;
#pragma unroll
        for (int r = 0; r < R; ++r) pr[u][r] = 0.f;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int vi = gl + c * G;
          float kf[VEC];
          unpack16(vi < nv ? lds128(kr + vi * 16) : make_uint4(0u, 0u, 0u, 0u),
                   kf, TKV());
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int i = 0; i < VEC; ++i) pr[u][r] += qf[r][c][i] * kf[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kSub; ++u)
#pragma unroll
        for (int r = 0; r < R; ++r) pr[u][r] = group_sum<G>(pr[u][r]);
      float vs[kSub];
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        float ks = qk_scale;
        vs[u] = 1.f;
        if (kQuant && t0 + u < nt) {
          const float2 bsc = block_scales(p, win, table, p0 + t0 + u);
          ks = bsc.x * kLog2e;
          vs[u] = bsc.y;
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
          pr[u][r] = (t0 + u < nt && p0 + t0 + u < lenr[r]) ? pr[u][r] * ks
                                                            : kNegInf;
      }
      // online softmax over the kSub tokens, row by row
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float smax = kNegInf;
#pragma unroll
        for (int u = 0; u < kSub; ++u) smax = fmaxf(smax, pr[u][r]);
        if (smax > m[r]) {
          const float alpha = hopper::exp2_ftz(m[r] - smax);
          l[r] *= alpha;
#pragma unroll
          for (int c = 0; c < CPL; ++c)
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[r][c][i] *= alpha;
          m[r] = smax;
        }
#pragma unroll
        for (int u = 0; u < kSub; ++u) {
          const bool valid = t0 + u < nt && p0 + t0 + u < lenr[r];
          float pe = valid ? hopper::exp2_ftz(pr[u][r] - m[r]) : 0.f;
          l[r] += pe;
          if (kRoundP) pe = __bfloat162float(__float2bfloat16_rn(pe));
          pr[u][r] = kQuant ? pe * vs[u] : pe;
        }
      }
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        const uint8_t* vr = vt + min(t0 + u, nt - 1) * p.row_bytes;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int vi = gl + c * G;
          float vf[VEC];
          unpack16(vi < nv ? lds128(vr + vi * 16) : make_uint4(0u, 0u, 0u, 0u),
                   vf, TKV());
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[r][c][i] += pr[u][r] * vf[i];
        }
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
    if (warp == 0 && it + kSharedStages < n) {
      hopper::mbar_wait(&empty[s], parity);  // every warp is done with it
      hopper::fence_proxy_async();
      issue_tile(p, win, table, t + kSharedStages, glen,
                 ring_smem + s * 2 * kSlotBytes,
                 ring_smem + s * 2 * kSlotBytes + kSlotBytes, &full[s][0],
                 &full[s][1], lane);
    }
  }

  // each row's result (one split) or partial; (m, l) from the row's first
  // lane
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = rbase + r;
    if (row >= p.num_seqs) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* pa = nw > 1 ? part_acc(p, row, split) : nullptr;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int col = (gl + c * G) * VEC;
      if (col >= p.d) continue;
      if (pa) {
#pragma unroll
        for (int i = 0; i < VEC; i += 4)
          *reinterpret_cast<float4*>(pa + col + i) =
              make_float4(acc[r][c][i], acc[r][c][i + 1], acc[r][c][i + 2],
                          acc[r][c][i + 3]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          store_out(p, (int64_t)row * p.d + col + i, acc[r][c][i] / den);
      }
    }
    if (pa && gl == 0) {
      part_ml(p, row, split)[0] = m[r];
      part_ml(p, row, split)[1] = l[r];
    }
  }
}

// -- the merge kernel ---------------------------------------------------------

// One CTA a row: the row group's partials of `row` into out, where the
// group took more than one split (reads bypass L1: other CTAs wrote them).
// kShared only names the route in a profile (the shared-table kernel).
template <bool kShared>
__global__ void __launch_bounds__(kMergeThreads)
paged_attn_merge_kernel(const Params p) {
  __shared__ float s_f[kMaxSplits + 1];
  __shared__ float4 s_red[kMergeThreads];
  __shared__ int s_len;
  const int row = blockIdx.x;
  const int glen =
      group_len(p, row / p.rows_per_cta * p.rows_per_cta, &s_len);
  const int nw = live_splits(p, glen);
  if (nw > 1) merge_row(p, row, nw, s_f, s_red);
}

// -- launch -------------------------------------------------------------------

int pow2_at_least(int x) {
  int g = 1;
  while (g < x) g *= 2;
  return g;
}


// The dynamic shared-memory attribute of `kernel`, set once a device
// (`done`: the caller's per-kernel bit set); the default allows 48 KB of
// static and dynamic memory together.
template <typename K>
int set_smem(K kernel, int bytes, uint32_t& done) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 32 && !(done & (1u << dev))) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    done |= 1u << dev;
  }
  return 0;
}

template <typename TKV, int G>
int launch_rows(const Params& p, cudaStream_t s) {
  constexpr int smem = kRowWarps * kRowStages * 2 * kSlotBytes;
  constexpr int NC = sizeof(TKV) == 1 ? 2 : 4;
  static uint32_t done = 0;
  auto kernel = paged_attn_rows_kernel<TKV, G, NC>;
  const int err = set_smem(kernel, smem, done);
  if (err) return err;
  kernel<<<dim3(p.num_seqs, p.splits), kRowWarps * 32, smem, s>>>(p);
  return 0;
}

template <typename TKV, int G>
int launch_shared(const Params& p, cudaStream_t s) {
  constexpr int smem = kSharedStages * 2 * kSlotBytes;
  static uint32_t done = 0;
  auto kernel = paged_attn_shared_kernel<TKV, G>;
  const int err = set_smem(kernel, smem, done);
  if (err) return err;
  const int groups = (p.num_seqs + p.rows_per_cta - 1) / p.rows_per_cta;
  kernel<<<dim3(groups, p.splits), kSharedWarps * 32, smem, s>>>(p);
  return 0;
}

// One-row lane groups: a lane covers NC 16-byte chunks (2 of int8, 4
// else), a token G = the next power of two >= its chunks / NC lanes.
// Shared-table lanes: G = lanes_per_row (the next power of two >= d / 16).
template <typename TKV>
int launch_kv(const Params& p, bool shared, cudaStream_t s) {
  int err = 0;
  if (shared) {
    switch (p.lanes_per_row) {
      case 2: err = launch_shared<TKV, 2>(p, s); break;
      case 4: err = launch_shared<TKV, 4>(p, s); break;
      case 8: err = launch_shared<TKV, 8>(p, s); break;
      case 16: err = launch_shared<TKV, 16>(p, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    constexpr int NC = sizeof(TKV) == 1 ? 2 : 4;
    const int g = pow2_at_least((p.row_bytes / 16 + NC - 1) / NC);
    switch (g) {
      case 1: err = launch_rows<TKV, 1>(p, s); break;
      case 2: err = launch_rows<TKV, 2>(p, s); break;
      case 4: err = launch_rows<TKV, 4>(p, s); break;
      case 8: err = launch_rows<TKV, 8>(p, s); break;
      case 16: err = launch_rows<TKV, 16>(p, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (err) return err;
  if (p.splits > 1) {
    if (shared)
      paged_attn_merge_kernel<true><<<p.num_seqs, kMergeThreads, 0, s>>>(p);
    else
      paged_attn_merge_kernel<false><<<p.num_seqs, kMergeThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// `shared`: the shared-table route (table_stride must be 0); else the
// one-row kernel, whatever the stride.  The tiles of a call
// (paddle_tpu_torch/ops/kernels/paged_attention.py's `tile_geometry`
// mirrors this): whole cache blocks while one fits a slot and the token cap
// (kMaxTileTokens, kSharedTileTokens for the shared-table route: its work a
// tile is rows x tokens), up to kMaxTileCopies blocks; else the largest
// part of a block (a divisor of block_size) that does.
extern "C" int paged_attention(const void* q, const void* k, const void* v,
                               const void* tables, const void* lens,
                               const void* scales, void* out, void* ws,
                               int num_seqs, int d, int block_size,
                               int max_blocks, int64_t table_stride,
                               float sm_scale, int q_dtype, int kv_dtype,
                               int splits, int shared, void* stream) {
  const int elt = kv_dtype == kF32 ? 4 : kv_dtype == kBF16 ? 2 : 1;
  if (num_seqs <= 0 || d <= 0 || d % 32 != 0 || d > kMaxDim ||
      block_size < 1 || block_size > kMaxBlockSize || max_blocks < 0 ||
      (q_dtype != kF32 && q_dtype != kBF16) ||
      (kv_dtype != kF32 && kv_dtype != kBF16 && kv_dtype != kI8) ||
      (kv_dtype == kI8 && scales == nullptr) ||
      (shared && table_stride != 0))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = static_cast<const uint8_t*>(k);
  p.v = static_cast<const uint8_t*>(v);
  p.tables = static_cast<const int*>(tables);
  p.table_stride = table_stride;
  p.lens = static_cast<const int*>(lens);
  p.scales = static_cast<const float*>(scales);
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.num_seqs = num_seqs;
  p.d = d;
  p.bs = block_size;
  p.width = max_blocks;
  p.sm_scale = sm_scale;
  p.q_dtype = q_dtype;
  p.row_bytes = d * elt;
  const int most = shared ? kSharedTileTokens : kMaxTileTokens;
  const int block_bytes = block_size * p.row_bytes;
  if (block_bytes <= kSlotBytes && block_size <= most) {
    int nb = kSlotBytes / block_bytes;
    nb = min(nb, min(most / block_size, kMaxTileCopies));
    p.tile_tokens = nb * block_size;
    p.copy_tokens = block_size;
    p.copies = nb;
    p.tiles = (max_blocks + nb - 1) / nb;
  } else {
    int tt = 1;
    for (int c = 1; c <= min(block_size, most); ++c)
      if (block_size % c == 0 && c * p.row_bytes <= kSlotBytes) tt = c;
    p.tile_tokens = tt;
    p.copy_tokens = tt;
    p.copies = 1;
    p.tiles = max_blocks * (block_size / tt);
  }
  p.rows_per_cta = 1;
  p.lanes_per_row = 1;
  if (shared) {
    p.lanes_per_row = pow2_at_least(d / kSharedCols);
    p.rows_per_cta = kSharedWarps * (32 / p.lanes_per_row) * kRowsPerLane;
  }
  // splits from the wrapper's plan: each non-empty at the full width
  p.splits = splits;
  p.tps = p.tiles > 0 ? (p.tiles + splits - 1) / splits : 1;
  if (splits < 1 || splits > kMaxSplits ||
      (p.tiles > 0 ? (splits - 1) * p.tps >= p.tiles : splits != 1) ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case kF32:
      return launch_kv<float>(p, shared, s);
    case kBF16:
      return launch_kv<__nv_bfloat16>(p, shared, s);
    default:
      return launch_kv<int8_t>(p, shared, s);
  }
}
