// EXPERIMENT, not built by build.py and not called by the port: the
// single-kernel bf16 flash-attention backward with one recompute of S that
// was measured against the shipped two-kernel design (csrc/
// flash_attention_packed_bwd.cu) and lost at every shape measured; kept so
// that the comparison in PERF.md (section 6) can be run again with
// experiments/attention_experiments.py.  The C entry takes two more
// pointers than the shipped one (an fp32 dQ accumulator and int32 turn
// counters) and their count.
//
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
// The bias gets no gradient.  The bf16 kernel takes the exponential in base
// 2 (scores and LSE pre-multiplied by log2 e).
//
// What bounds it on the H100.  With S recomputed once the work is
// 10 b h s^2 d operations: 16.1 GFLOP at the ERNIE-base shape (b 8, s 512,
// h 12, d 64), 16 us at 989 TF/s, against ~50 MB of q, k, v, o, dO read and
// dq, dk, dv written, 15 us at 3.35 TB/s; at LLaMA-2-7B's causal s 4096
// d 128, 344 GFLOP, 0.35 ms.  Operations bound it.  In fp32 the CUDA cores
// bound it (67 TF/s, 0.24 ms at ERNIE-base).
//
// Design, two launches on one stream:
//   1. delta pre-pass: one warp per (token, head) sums dO * O in fp32 into a
//      (batch, heads, seq) scratch the wrapper allocates; it also zeroes the
//      bf16 kernel's dQ turn counters (below).
//   2. bf16 (flash_bwd_wgmma_kernel): one recompute of S.  A CTA of 384
//      threads owns a key tile -- warpgroup 0 the producer, warpgroups 1
//      and 2 the consumers -- keeps dK and dV in fp32 registers and walks
//      the 64-row query tiles.  For each query tile a consumer recomputes
//      S^T = K Q^T and dP^T = V dO^T (wgmma, both operands K-major in
//      shared memory), P^T = exp(S^T - lse), replays the dropout mask,
//      forms dS^T = P^T (dP^T - delta) sm_scale, and accumulates
//      dV += P^T dO and dK += dS^T Q (wgmma, P^T / dS^T as register A
//      fragments, dO / Q MN-major).  dS^T goes to shared memory, and
//      dQ_i = dS K is one more wgmma (both operands MN-major).  Loads are
//      TMA from 4-d tensor maps (head_dim, seq, heads, batch) that the C
//      entry builds from the layout's strides; K and V stay resident, Q,
//      dO and the per-query LSE and delta stream through a two-stage ring
//      with mbarrier full/empty pairs.
//        * d 64, 128: a CTA owns 128 keys, 64 per consumer, and every
//          column; the dQ product of query tile i takes all 128 keys, its
//          64-column boxes split between the consumers (d 64: consumer
//          i % 2 does all of it).
//        * d 192, 256: a CTA owns 64 keys; both consumers compute the same
//          S^T and dP^T and each writes 128 columns of dK, dV and dQ
//          (registers: dK and dV of 64 keys x d take d fp32 registers a
//          thread).
//        * d above 256: as d 256, over 256 output columns a CTA (grid y =
//          head * ceil(d / 256) + slice); K, V, Q and dO of the whole head
//          stream through the ring box by box for S^T and dP^T, and only
//          the slice's K stays resident.
//      dQ is summed in a fixed order without atomics, so the result is the
//      same run to run (FlashAttention-3's deterministic mode): the wrapper
//      hands over an fp32 (batch, heads, seq, head_dim) accumulator
//      (torch.empty) and one int32 counter per (batch, head, slice, 64-row
//      query tile), zeroed by the delta pre-pass.  The consumers write
//      their dQ partial of query tile i into the stage that held its Q and
//      dO (the same size); warps 1-3 of the producer warpgroup, the dQ
//      writer, add it to the accumulator and release the stage, so the
//      consumers never wait on the order.  The order is descending: the
//      last key tile j that reaches query tile i adds first, key tile 0
//      last.  A writer adds only when the counter equals its turn (acquire
//      spin by one thread), then fences and stores turn + 1 (release).
//      The first contributor writes instead of adding, so the accumulator
//      needs no memset; key tile 0 converts the sum to bf16 and writes dq
//      itself.  Key tile j runs in CTA gridDim.x - 1 - j, so a CTA waits
//      only on a CTA of lower linear id, which the hardware dispatched
//      before it and which never waits on it: the wait cannot deadlock.
//      Descending also suits causal masking, where key tile j + 1 starts
//      two query tiles after key tile j and so reaches each query tile
//      first.  The writer brings the sums so far into a 16 KB shared
//      scratch with cp.async, so its L2 round trips overlap.  setmaxnreg
//      gives the producer warpgroup 40 registers and the consumers 232.
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

// Helpers of this design that the shipped kernels do not use.
namespace ordered {

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of bf16 element (row, col) (col < 64) in a swizzled box.
__device__ __forceinline__ uint32_t swizzle_offset(int row, int col) {
  return (uint32_t)(row * hopper::kBoxRowBytes +
                    ((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) << 1)));
}

#define ORDERED_ACC8(o) \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// d (64 x 64) (+)= A (64 x 16) B (16 x 64), both in shared memory; TA / TB:
// the operand is MN-major (1) or K-major (0).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : ORDERED_ACC8(0), ORDERED_ACC8(8), ORDERED_ACC8(16), ORDERED_ACC8(24)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

#undef ORDERED_ACC8

}  // namespace ordered

namespace {

using dropout_hash::Params;

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // query rows per bf16 query tile
constexpr int kSliceCols = 256;   // bf16 output columns a CTA above d 128
constexpr float kLog2e = 1.4426950408889634f;

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
  float* dq_acc;       // bf16 only: (batch, heads, seq, head_dim) fp32
  int* turns;          // bf16 only: the dQ turn counters
  int n_turns;
  int seq;
  int heads;
  int head_dim;
  Layout lay;
  float sm_scale;
  int causal;
  Params drop;
};

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O) per (batch, head, position), in fp32; warps
// past the rows zero the turn counters.

template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(BwdArgs a, int64_t rows) {
  const int64_t w = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (lane == 0 && w < a.n_turns) a.turns[w] = 0;
  if (w >= rows) return;
  const int h = (int)(w % a.heads);
  const int64_t tok = w / a.heads;  // batch * seq + position
  const int b = (int)(tok / a.seq);
  const int pos = (int)(tok % a.seq);
  const int64_t off = a.lay.base(b, h) + (int64_t)pos * a.lay.row;
  const T* o = static_cast<const T*>(a.o) + off;
  const T* d = static_cast<const T*>(a.dout) + off;
  float acc = 0.f;
  for (int c = lane; c < a.head_dim; c += 32)
    acc += to_float(o[c]) * to_float(d[c]);
  acc = warp_sum(acc);
  if (lane == 0) a.delta[((int64_t)b * a.heads + h) * a.seq + pos] = acc;
}

// ---------------------------------------------------------------------------
// 2. bf16: warp-specialised wgmma + TMA, one recompute of S (header note).

constexpr int kWgThreads = 384;
constexpr int kBox = kBQ * hopper::kBoxRowBytes;  // one 64-row box, 8 KB

// Shared-memory plan.  KG: 64-key groups a CTA (2: one per consumer, all
// columns; 1: both consumers on the same keys, 128 columns each); NCH:
// 64-column boxes of the head resident (the slice above d 256); STREAM:
// K, V, Q and dO of the whole head stream box by box for S^T and dP^T.
// A stage holds Q and dO of one query tile (the slice's columns), which is
// exactly the size of that tile's fp32 dQ partial: once the products have
// read Q and dO, the consumers write the partial into the stage and the
// dQ writer releases it.
template <int KG, int NCH, bool STREAM>
struct BwdPlan {
  static constexpr int kKeys = 64 * KG;               // keys a CTA
  static constexpr int kOut = KG == 2 ? NCH : 2;      // output boxes a consumer
  static constexpr int kCols = 64 * NCH;              // dQ partial row, floats
  static constexpr int kKRes = 0;                     // resident K
  static constexpr int kVRes = kKRes + NCH * KG * kBox;  // resident V
  static constexpr int kStages = 2;
  static constexpr int kStageBytes =
      STREAM ? (4 * kBox > 2 * NCH * kBox ? 4 * kBox : 2 * NCH * kBox)
             : 2 * NCH * kBox;
  static constexpr int kStage = kVRes + (STREAM ? 0 : NCH * KG * kBox);
  static constexpr int kDs = kStage + kStages * kStageBytes;  // dS^T
  static constexpr int kDsBytes = kKeys * hopper::kBoxRowBytes;
  static constexpr int kStats = kDs + kDsBytes;  // lse2, delta a stage
  static constexpr int kScr = kStats + kStages * 2 * kBQ * 4;  // the writer's
  static constexpr int kScrSlots = 1024;                       // float4s
  static constexpr int kBars = kScr + kScrSlots * 16;
  // resident, then full, empty and dQ-written per stage
  static constexpr int kBytes = kBars + (1 + 3 * kStages) * 8 + 1024;
  static_assert(kBytes <= 227 * 1024, "shared memory");
  static_assert(kBQ * kCols * 4 <= kStageBytes, "dQ partial fits a stage");
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~(uintptr_t)1023);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   hopper::smem_u32(smem_dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Float offset of (row, col) in a stage's fp32 dQ partial of `cols`
// columns: 16-byte chunks swizzled by row within groups of 8, so the
// consumers' column-pair stores spread over the banks.
__device__ __forceinline__ int dq_offset(int row, int col, int cols) {
  const int c16 = col >> 2;
  return row * cols + (((c16 & ~7) | ((c16 ^ row) & 7)) << 2) + (col & 3);
}

// The key tile's place in the dQ order of query tile i: the last key
// tile that reaches the query tile adds first, key tile 0 last.
__device__ __forceinline__ int last_key_tile(int q0, int seq, int keys,
                                             int nu, int causal) {
  return causal ? min(nu - 1, (min(q0 + kBQ, seq) - 1) / keys) : nu - 1;
}

// grid = (key tiles, heads * slices, batch), block = 384 threads.  Key
// tile u = gridDim.x - 1 - blockIdx.x: the dQ turn of tile u follows tile
// u + 1's, which has the lower block id.
template <int KG, int NCH, bool STREAM>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap dmap,
                       BwdArgs a) {
  using P = BwdPlan<KG, NCH, STREAM>;
  constexpr int ST = P::kStages;
  constexpr int NO = P::kOut;
  constexpr int W = P::kCols;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* stats = reinterpret_cast<float*>(smem + P::kStats);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + P::kBars);
  uint64_t* kbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + ST;
  uint64_t* dqfull = bars + 1 + 2 * ST;

  const int seq = a.seq;
  const int nslices = KG == 2 ? 1 : (a.head_dim + kSliceCols - 1) / kSliceCols;
  const int nu = gridDim.x;
  const int u = nu - 1 - (int)blockIdx.x;   // key tile
  const int h = blockIdx.y / nslices;
  const int slice = blockIdx.y % nslices;
  const int b = blockIdx.z;
  const int kb = u * P::kKeys;              // first key
  const int col0 = slice * kSliceCols;      // first output column
  const int nspan = STREAM ? min(NCH, (a.head_dim - col0) / 64) : NCH;
  const int nc = a.head_dim / 64;           // boxes of the whole head
  const int nq = (seq + kBQ - 1) / kBQ;
  const int i0 = a.causal ? kb / kBQ : 0;   // first query tile it touches
  const uint32_t bh = (uint32_t)(b * a.heads + h);

  if (threadIdx.x == 0) {
    hopper::mbar_init(kbar, 1);
    for (int i = 0; i < ST; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, 2);
      hopper::mbar_init(dqfull + i, 2);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    hopper::reg_dealloc<40>();
    if (threadIdx.x < 32) {
      // ---- producer warp: TMA loads, LSE and delta ----
      const int lane = threadIdx.x;
      if (lane == 0) {
        hopper::prefetch_map(&qmap);
        hopper::prefetch_map(&kmap);
        hopper::prefetch_map(&vmap);
        hopper::prefetch_map(&dmap);
        // resident: K (and V unless streaming) of the CTA's keys
        hopper::mbar_expect_tx(kbar,
                               (STREAM ? 1 : 2) * nspan * KG * kBox);
        for (int c = 0; c < nspan; ++c)
          for (int g = 0; g < KG; ++g) {
            hopper::tma_load_4d(smem + P::kKRes + (c * KG + g) * kBox, &kmap,
                                kbar, col0 + c * 64, kb + 64 * g, h, b);
            if (!STREAM)
              hopper::tma_load_4d(smem + P::kVRes + (c * KG + g) * kBox,
                                  &vmap, kbar, c * 64, kb + 64 * g, h, b);
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
              uint8_t* s = smem + P::kStage + st * P::kStageBytes;
              hopper::mbar_expect_tx(full + st, 4 * kBox);
              hopper::tma_load_4d(s, &kmap, full + st, c * 64, kb, h, b);
              hopper::tma_load_4d(s + kBox, &vmap, full + st, c * 64, kb, h,
                                  b);
              hopper::tma_load_4d(s + 2 * kBox, &qmap, full + st, c * 64, q0,
                                  h, b);
              hopper::tma_load_4d(s + 3 * kBox, &dmap, full + st, c * 64, q0,
                                  h, b);
            }
            if (++st == ST) { st = 0; ph ^= 1; }
          }
        }
        // Q and dO of the query tile (the slice's columns), LSE and delta
        hopper::mbar_wait(empty + st, ph ^ 1);
        float* sv = stats + st * 2 * kBQ;
        for (int r = lane; r < kBQ; r += 32) {
          const bool in = q0 + r < seq;
          const int64_t idx = (int64_t)bh * seq + q0 + r;
          sv[r] = in ? a.lse[idx] * kLog2e : 0.f;
          sv[kBQ + r] = in ? a.delta[idx] : 0.f;
        }
        __syncwarp();
        if (lane == 0) {
          uint8_t* s = smem + P::kStage + st * P::kStageBytes;
          hopper::mbar_expect_tx(full + st, 2 * nspan * kBox);
          for (int c = 0; c < nspan; ++c) {
            hopper::tma_load_4d(s + c * kBox, &qmap, full + st,
                                col0 + c * 64, q0, h, b);
            hopper::tma_load_4d(s + (NCH + c) * kBox, &dmap, full + st,
                                col0 + c * 64, q0, h, b);
          }
        }
        if (++st == ST) { st = 0; ph ^= 1; }
      }
    } else {
      // ---- dQ writer, warps 1-3: the ordered sum into dq_acc / dq ----
      const int wt = threadIdx.x - 32;
      const int ncols = (KG == 2 ? NCH : nspan) * 64;
      int* turns = a.turns + ((int64_t)bh * nslices + slice) * nq;
      __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(a.dq);
      const int64_t base = a.lay.base(b, h);
      int st = 0;
      uint32_t ph = 0;
      uint32_t dqph = 0;  // the dqfull parity of each stage, one bit each
      for (int i = i0; i < nq; ++i) {
        if constexpr (STREAM) {
          for (int c = 0; c < nc; ++c)
            if (++st == ST) { st = 0; ph ^= 1; }
        }
        const int q0 = i * kBQ;
        const int turn = last_key_tile(q0, seq, P::kKeys, nu, a.causal) - u;
        hopper::mbar_wait(dqfull + st, (dqph >> st) & 1);
        dqph ^= 1u << st;
        if (wt == 0)
          while (ld_acquire(turns + i) != turn) {
          }
        hopper::bar_sync(5, 96);
        const float* buf =
            reinterpret_cast<const float*>(smem + P::kStage +
                                           st * P::kStageBytes);
        // The sums so far come into a shared scratch by cp.async, 1024
        // float4 at a time, so the L2 round trips overlap; each thread adds
        // and stores the slots it loaded.
        float4* scr = reinterpret_cast<float4*>(smem + P::kScr);
        const int per_row = ncols / 4;
        const int units = kBQ * per_row;
        for (int b0 = 0; b0 < units; b0 += P::kScrSlots) {
          const int b1 = min(units, b0 + P::kScrSlots);
          if (turn > 0) {
            for (int x = b0 + wt; x < b1; x += 96) {
              const int qq = q0 + x / per_row;
              if (qq < seq)
                cp_async16(scr + (x - b0),
                           a.dq_acc + ((int64_t)bh * seq + qq) * a.head_dim +
                               col0 + (x % per_row) * 4);
            }
            cp_async_wait_all();
          }
          for (int x = b0 + wt; x < b1; x += 96) {
            const int r = x / per_row;
            const int col = (x % per_row) * 4;
            const int qq = q0 + r;
            if (qq >= seq) continue;
            float4 v4 =
                *reinterpret_cast<const float4*>(buf + dq_offset(r, col, W));
            if (turn > 0) {
              const float4 y = scr[x - b0];
              v4.x += y.x;
              v4.y += y.y;
              v4.z += y.z;
              v4.w += y.w;
            }
            if (u == 0) {
              __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(
                  dq + base + (int64_t)qq * a.lay.row + col0 + col);
              out[0] = __floats2bfloat162_rn(v4.x, v4.y);
              out[1] = __floats2bfloat162_rn(v4.z, v4.w);
            } else {
              __stcg(reinterpret_cast<float4*>(
                         a.dq_acc + ((int64_t)bh * seq + qq) * a.head_dim +
                         col0 + col),
                     v4);
            }
          }
        }
        __threadfence();
        ordered::fence_proxy_async();  // the stage goes back to the TMA
        hopper::bar_sync(5, 96);
        if (wt == 0) {
          st_release(turns + i, turn + 1);
          hopper::mbar_arrive(empty + st);
          hopper::mbar_arrive(empty + st);
        }
        if (++st == ST) { st = 0; ph ^= 1; }
      }
    }
    return;
  }

  // ---- consumers ----
  hopper::reg_alloc<232>();
  const int ct = threadIdx.x - 128;
  const int cw = ct >> 7;
  const int lt = ct & 127;
  const int warp = lt >> 5;
  const int lane = lt & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kg = KG == 2 ? cw : 0;          // the consumer's key group
  const int kr0 = kb + 64 * kg + 16 * warp + g;  // its two key rows
  const int kr1 = kr0 + 8;
  const int ob = KG == 2 ? 0 : 2 * cw;      // its first output box (span)
  const int nout = KG == 2 ? NCH : max(0, min(2, nspan - ob));
  const uint32_t sbase = hopper::smem_u32(smem);
  const float bias0 = kr0 < seq ? a.bias[(int64_t)b * seq + kr0] * kLog2e : 0.f;
  const float bias1 = kr1 < seq ? a.bias[(int64_t)b * seq + kr1] * kLog2e : 0.f;
  const float scale2 = a.sm_scale * kLog2e;

  float dk[NO][32], dv[NO][32];
#pragma unroll
  for (int v = 0; v < NO; ++v)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[v][e] = dv[v][e] = 0.f;

  hopper::mbar_wait(kbar, 0);
  int st = 0;
  uint32_t ph = 0;
  for (int i = i0; i < nq; ++i) {
    const int q0 = i * kBQ;
    float sT[32], dpT[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sT[e] = dpT[e] = 0.f;
    if constexpr (!STREAM) {
      hopper::mbar_wait(full + st, ph);
      const uint32_t qs = sbase + P::kStage + st * P::kStageBytes;
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t row = (c * KG + kg) * kBox + kk * 32;
          ordered::wgmma_ss64<0, 0>(
              sT, hopper::desc_sw128(sbase + P::kKRes + row),
              hopper::desc_sw128(qs + c * kBox + kk * 32), 1);
          ordered::wgmma_ss64<0, 0>(
              dpT, hopper::desc_sw128(sbase + P::kVRes + row),
              hopper::desc_sw128(qs + (NCH + c) * kBox + kk * 32), 1);
        }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
    } else {
      for (int c = 0; c < nc; ++c) {
        hopper::mbar_wait(full + st, ph);
        const uint32_t s = sbase + P::kStage + st * P::kStageBytes;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          ordered::wgmma_ss64<0, 0>(sT, hopper::desc_sw128(s + kk * 32),
                                   hopper::desc_sw128(s + 2 * kBox + kk * 32),
                                   1);
          ordered::wgmma_ss64<0, 0>(dpT,
                                   hopper::desc_sw128(s + kBox + kk * 32),
                                   hopper::desc_sw128(s + 3 * kBox + kk * 32),
                                   1);
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
        float p = exp2f(fmaf(sT[4 * n + e], scale2, (e < 2) ? bias0 : bias1) -
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
    // dS^T to shared memory (rows = the CTA's keys, columns = queries)
    uint8_t* dsb = smem + P::kDs;
    if (KG == 2 || cw == 0) {
      const int rr = 64 * kg + 16 * warp + g;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int c = 16 * kk + 2 * t;
        *reinterpret_cast<uint32_t*>(dsb + ordered::swizzle_offset(rr, c)) =
            df[kk][0];
        *reinterpret_cast<uint32_t*>(dsb + ordered::swizzle_offset(rr + 8, c)) =
            df[kk][1];
        *reinterpret_cast<uint32_t*>(dsb + ordered::swizzle_offset(rr, c + 8)) =
            df[kk][2];
        *reinterpret_cast<uint32_t*>(
            dsb + ordered::swizzle_offset(rr + 8, c + 8)) = df[kk][3];
      }
      ordered::fence_proxy_async();
    }

    // dV += P^T dO, dK += dS^T Q over the consumer's output boxes.
    const uint32_t qs = sbase + P::kStage + st * P::kStageBytes;
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
    // dS^T of every consumer is in shared memory, and no product reads
    // the stage's Q and dO any more: the stage takes the dQ partial.
    hopper::bar_sync(1, 256);

    // dQ_i = dS K for the consumer's dQ boxes, into the stage.
    float* part = reinterpret_cast<float*>(smem + P::kStage +
                                           st * P::kStageBytes);
    const uint32_t dsa = sbase + P::kDs;
#pragma unroll
    for (int v = 0; v < NO; ++v) {
      int box;  // KG 2: box (cw + i) % 2; KG 1: the consumer's boxes
      if (KG == 2) {
        if (v > 0) break;
        box = (cw + i) & 1;
        if (box >= NCH) break;
      } else {
        if (v >= nout) break;
        box = ob + v;
      }
      float acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * KG; ++kk)
        ordered::wgmma_ss64<1, 1>(
            acc, hopper::desc_sw128(dsa + kk * 16 * 128),
            hopper::desc_sw128(sbase + P::kKRes + box * KG * kBox +
                               kk * 16 * 128),
            1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      const int r = 16 * warp + g;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = box * 64 + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(part + dq_offset(r, c, W)) =
            make_float2(acc[4 * n], acc[4 * n + 1]);
        *reinterpret_cast<float2*>(part + dq_offset(r + 8, c, W)) =
            make_float2(acc[4 * n + 2], acc[4 * n + 3]);
      }
    }
    hopper::bar_sync(2 + cw, 128);
    if (lt == 0) hopper::mbar_arrive(dqfull + st);
    if (++st == ST) { st = 0; ph ^= 1; }
  }

  // dK and dV of the consumer's keys and output boxes.
  const int64_t base = a.lay.base(b, h);
  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(a.dk);
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(a.dv);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kr = half ? kr1 : kr0;
    if (kr >= seq) continue;
    const int64_t row = base + (int64_t)kr * a.lay.row + col0;
#pragma unroll
    for (int v = 0; v < NO; ++v) {
      if (KG == 1 && v >= nout) continue;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = (ob + v) * 64 + 8 * n + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(dkp + row + c) =
            __floats2bfloat162_rn(dk[v][4 * n + 2 * half],
                                  dk[v][4 * n + 2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dvp + row + c) =
            __floats2bfloat162_rn(dv[v][4 * n + 2 * half],
                                  dv[v][4 * n + 2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------

constexpr int kBF16 = 1;

template <typename T>
int launch_delta(const BwdArgs& a, int batch, cudaStream_t stream) {
  const int64_t rows = (int64_t)batch * a.seq * a.heads;
  const int64_t warps = rows > a.n_turns ? rows : a.n_turns;
  flash_bwd_delta_kernel<T>
      <<<(unsigned)((warps + 7) / 8), 256, 0, stream>>>(a, rows);
  return (int)cudaGetLastError();
}

template <int KG, int NCH, bool STREAM>
int launch_wgmma(const BwdArgs& a, int batch, cudaStream_t stream) {
  using P = BwdPlan<KG, NCH, STREAM>;
  static bool done[kMaxDevices] = {};
  auto kernel = flash_bwd_wgmma_kernel<KG, NCH, STREAM>;
  int err = set_smem_limit(kernel, P::kBytes, done);
  if (err) return err;
  err = launch_delta<__nv_bfloat16>(a, batch, stream);
  if (err) return err;
  CUtensorMap maps[4];
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  const Layout& l = a.lay;
  for (int i = 0; i < 4; ++i)
    if ((err = hopper::make_map(maps + i, ptrs[i], a.head_dim, a.seq, a.heads,
                                batch, l.row, l.head, l.batch, kBQ)))
      return err;
  const int nslices =
      KG == 2 ? 1 : (a.head_dim + kSliceCols - 1) / kSliceCols;
  const dim3 grid((unsigned)((a.seq + P::kKeys - 1) / P::kKeys),
                  (unsigned)(a.heads * nslices), (unsigned)batch);
  kernel<<<grid, kWgThreads, P::kBytes, stream>>>(maps[0], maps[1], maps[2],
                                                  maps[3], a);
  return (int)cudaGetLastError();
}

// The dQ turn counters the bf16 kernel needs: one per (batch, head, output
// slice, 64-row query tile).
int turns_needed(int batch, int seq, int heads, int head_dim) {
  const int slices =
      head_dim <= 128 ? 1 : (head_dim + kSliceCols - 1) / kSliceCols;
  return batch * heads * slices * ((seq + kBQ - 1) / kBQ);
}

}  // namespace

extern "C" int flash_attention_packed_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* out, const void* dout, const void* lse, void* delta, void* dq,
    void* dk, void* dv, void* dq_acc, void* turns, int n_turns, int batch,
    int seq, int heads, int head_dim, int64_t batch_stride, int64_t head_stride,
    int64_t row_stride, float sm_scale, int causal, uint32_t seed,
    uint32_t threshold, float keep_scale, int dropout, int dtype,
    void* stream) {
  if (head_dim <= 0 || head_dim % 64) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16 && n_turns < turns_needed(batch, seq, heads, head_dim))
    return (int)cudaErrorInvalidValue;  // the wrapper's buffer is too small
  const BwdArgs a{q, k, v, static_cast<const float*>(bias), out, dout,
                  static_cast<const float*>(lse), static_cast<float*>(delta),
                  dq, dk, dv, static_cast<float*>(dq_acc),
                  static_cast<int*>(turns), n_turns, seq, heads, head_dim,
                  Layout{batch_stride, head_stride, row_stride}, sm_scale,
                  causal, Params{seed, threshold, keep_scale, dropout}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    switch (head_dim) {
      case 64: return launch_wgmma<2, 1, false>(a, batch, s);
      case 128: return launch_wgmma<2, 2, false>(a, batch, s);
      case 192: return launch_wgmma<1, 3, false>(a, batch, s);
      case 256: return launch_wgmma<1, 4, false>(a, batch, s);
      default: return launch_wgmma<1, 4, true>(a, batch, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
