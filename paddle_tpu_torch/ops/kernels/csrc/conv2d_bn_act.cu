// Fused NHWC convolution + per-channel epilogue for sm_90a.
//
// Replaces the Pallas kernel `conv2d_bn_act` of
// paddle_tpu/ops/pallas/conv_fused.py (line 152):
//
//   out[n, y, x, o] = act(sum_{i, j, c} xpad[n, y*sh + i, x*sw + j, c]
//                                       * w[o, c, i, j] * a[o] + b[o])
//
// with x NHWC (fp32 or bf16), a and b fp32 (O,), the sum in fp32 and the
// output NHWC in x's dtype.  Acts: none, relu, relu6, sigmoid, tanh, gelu
// (erf), silu.  The wrapper lays the OIHW filter out once per weight: bf16
// as (O, kh, kw, C) (K-major, like K in Q K^T), fp32 as (kh, kw, C, O).
// Zero padding comes from the loads themselves (TMA's out-of-bounds fill,
// or zero-filled cp.async); the JAX wrapper's padded copy of x (a TPU
// block-shape artefact) is not made.
//
// Implicit GEMM: M = n * Ho * Wo output pixels, N = O channels, K = kh * kw
// * C, walked in units of one filter tap x 64 channels.  ops/kernels/
// conv_fused.py `conv_plan` mirrors the tiling below.
//
// What bounds it on the H100: operations.  A 3x3 conv does 2 * 9 * C flops
// for each output value against ~2 bytes of activations read and written,
// far above the bf16 ridge (~295 flops a byte).  VGG's late layers have
// few output pixels (b128 at 2x2 is M = 512): output tiles alone give 16
// CTAs for 132 SMs, so the plan splits K across CTAs until the grid fills
// one wave.
//
// bf16 (conv2d_bn_act_wgmma_kernel): one CTA of 384 threads per 128-pixel x
// 128-channel output tile and K range -- warpgroup 0 the producer,
// warpgroups 1 and 2 the consumers of 64 pixels each.
//   * A (the input windows) by TMA in im2col mode: one 4-d map (C, W, H, N)
//     whose bounding box is the positions of the filter's first tap
//     (corners -p and p - (k - 1)) at the traversal strides (sw, sh), so one
//     load walks 128 output pixels in (n, y, x) order, across image ends,
//     and reads each at the tap's offset (j, i); pixels in the padding or
//     past the last image read as zeros.  One box is 64 channels, 128
//     bytes, stored with the 128-byte swizzle.
//   * B (the filter) by a 2-d tiled map over (kh * kw * C, O): a 64 x 128
//     box, K-major, the same descriptors as A.
//   * A ring of 4 stages (A 16 KB + B 16 KB) with mbarrier full/empty
//     pairs; the producer's lane 0 issues both loads a stage.  setmaxnreg
//     gives the producer 40 registers and the consumers 232.
//   * Each consumer runs wgmma m64n128k16 (4 k-steps a unit), fp32
//     accumulators in registers, and keeps one group of products in flight
//     (wgmma.wait_group 1) before it frees the previous stage.
//   * Epilogue: acc * a[o] + b[o] and the act in fp32, rounded once to
//     bf16, staged in shared memory and written in 16-byte rows.  a and b
//     are read before the K loop, and the act is a compile-time constant
//     in the unrolled loop (with_act): read after the loop, and resolved
//     per value, the two made the epilogue the 16x16 layer's largest cost.
//   The products of bf16 values are exact in fp32, so this is the TPU
//   kernel's fp32 dot in another summation order.  Tensor maps are
//   __grid_constant__ parameters, so CUDA-graph capture works.
//
// fp32 (conv2d_bn_act_fp32_kernel): FMAs on the CUDA cores.  The tensor
// cores take fp32 operands only as TF32, which keeps ~3 decimal digits and
// would break the fp32 contract (1e-4 of the largest value against the
// plain version's fp32 sums, the JAX interpret kernel's arithmetic).  A CTA
// of 4 warps owns a 64-pixel x 128-channel tile and walks K in tiles of one
// tap x 16 channels: the 64 input rows (conv_tile.cuh, zero-filled
// cp.async) and the filter slice, three stages deep; each thread 8 x 8
// outputs.
//
// Split K (both types): grid z = splits; split s takes the units [s U / S,
// (s + 1) U / S) of the U = kh * kw * C / 64 units, so every unit is summed
// once, in order.  With more than one split each CTA writes its fp32 tile
// to a workspace (splits, M, O) that the wrapper allocates, and
// conv2d_bn_act_split_sum_kernel adds the splits in order 0 .. S-1 and
// applies the epilogue: no atomics, so outputs repeat bit for bit.
//
// C interface (bound with ctypes): pointers and the stream are `void*`; the
// entry returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act.cuh"
#include "attention_layout.cuh"
#include "conv_tile.cuh"
#include "hopper.cuh"

namespace {

using conv_tile::RowInfo;
using conv_tile::Shape;
using conv_tile::cp_async16;
using conv_tile::cp_async_commit;
using conv_tile::cp_async_wait;
using epilogue_act::apply_act;
using epilogue_act::kNone;
using epilogue_act::kSilu;

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kUnitC = 64;     // channels of one K unit (C % 64 == 0)
constexpr int kBN = 128;       // output channels per CTA, both types

// Calls f(ActTag<act>{}) with the act as a compile-time constant, so an
// unrolled epilogue of 64 values inlines one activation.  (With the act a
// run-time value, every value carried the code of all seven, and the
// epilogue dominated the bf16 16x16 layer; PERF.md section 6.)
template <int A>
struct ActTag {
  static constexpr int kAct = A;
};

template <typename F>
__device__ __forceinline__ void with_act(int act, F&& f) {
  switch (act) {
    case epilogue_act::kRelu: f(ActTag<epilogue_act::kRelu>{}); break;
    case epilogue_act::kRelu6: f(ActTag<epilogue_act::kRelu6>{}); break;
    case epilogue_act::kSigmoid: f(ActTag<epilogue_act::kSigmoid>{}); break;
    case epilogue_act::kTanh: f(ActTag<epilogue_act::kTanh>{}); break;
    case epilogue_act::kGelu: f(ActTag<epilogue_act::kGelu>{}); break;
    case epilogue_act::kSilu: f(ActTag<epilogue_act::kSilu>{}); break;
    default: f(ActTag<kNone>{});
  }
}

// The K units [u0, u1) of split `split` of `splits`.
__device__ __forceinline__ void split_units(int units, int splits, int split,
                                            int& u0, int& u1) {
  u0 = (int)((int64_t)split * units / splits);
  u1 = (int)((int64_t)(split + 1) * units / splits);
}

// ---------------------------------------------------------------------------
// fp32: FMA tiles (see the header note).

constexpr int kF32BM = conv_tile::kBM;  // 64 pixels
constexpr int kF32BK = conv_tile::kKBytes / 4;  // 16 channels a K tile
constexpr int kF32Stages = 3;
constexpr int kF32Threads = conv_tile::kThreads;
constexpr int kF32LdA = kF32BK + 4;
constexpr int kF32LdB = kBN + 4;
constexpr int kF32A = kF32BM * kF32LdA;
constexpr int kF32Stage = kF32A + kF32BK * kF32LdB;

__device__ __forceinline__ void load_tile_fp32(float* stage, const float* x,
                                               const float* wk,
                                               const Shape& s,
                                               const RowInfo& ri, int kt,
                                               int n0) {
  const int tid = threadIdx.x;
  const int c_tiles = s.c / kF32BK;
  const int tap = kt / c_tiles;
  const int c0 = (kt - tap * c_tiles) * kF32BK;
  const int i = tap / s.kw, j = tap - (tap / s.kw) * s.kw;
  float* Bs = stage + kF32A;
  conv_tile::load_a<float>(stage, kF32LdA, x, s, ri, i, j, c0);
  constexpr int kChunksB = kBN * 4 / 16;  // chunks in a B row
  constexpr int kPer = kF32BK * kChunksB / kF32Threads;
  const float* wrow = wk + ((int64_t)tap * s.c + c0) * s.o + n0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = tid + q * kF32Threads;
    const int r = e / kChunksB, ch = e % kChunksB;
    cp_async16(Bs + r * kF32LdB + ch * 4, wrow + (int64_t)r * s.o + ch * 4,
               16);
  }
}

// thread (ty, tx) of a 16 x 8 grid owns pixels ty + 8 r (r < 8) and
// channels 8 tx .. 8 tx + 7.
__device__ __forceinline__ void compute_fma(const float* stage,
                                            float (&acc)[8][8]) {
  const float* As = stage;
  const float* Bs = stage + kF32A;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int k = 0; k < kF32BK; ++k) {
    float av[8], bv[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) av[r] = As[(ty + 8 * r) * kF32LdA + k];
    const float4 b0 =
        *reinterpret_cast<const float4*>(Bs + k * kF32LdB + 8 * tx);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + k * kF32LdB + 8 * tx + 4);
    bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
    bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// grid = (ceil(M / 64), O / 128, splits), block = 128 threads.  With one
// split the epilogue writes `out`; with more, the fp32 partial tile goes to
// ws[split].
__global__ void __launch_bounds__(kF32Threads)
    conv2d_bn_act_fp32_kernel(const float* __restrict__ x,
                              const float* __restrict__ wk,
                              const float* __restrict__ a,
                              const float* __restrict__ b,
                              float* __restrict__ out,
                              float* __restrict__ ws, Shape s, int act) {
  __shared__ __align__(16) float smem[kF32Stages * kF32Stage];
  const int64_t m0 = (int64_t)blockIdx.x * kF32BM;
  const int n0 = blockIdx.y * kBN;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const RowInfo ri = conv_tile::row_info(s, m0);

  int u0, u1;
  split_units(s.kh * s.kw * (s.c / kUnitC), splits, blockIdx.z, u0, u1);
  constexpr int kPerUnit = kUnitC / kF32BK;
  const int kt0 = u0 * kPerUnit, nkt = (u1 - u0) * kPerUnit;
#pragma unroll
  for (int st = 0; st < kF32Stages - 1; ++st) {
    if (st < nkt)
      load_tile_fp32(smem + st * kF32Stage, x, wk, s, ri, kt0 + st, n0);
    cp_async_commit();
  }
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

  for (int k = 0; k < nkt; ++k) {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();
    const int nk = k + kF32Stages - 1;
    if (nk < nkt)
      load_tile_fp32(smem + (nk % kF32Stages) * kF32Stage, x, wk, s, ri,
                     kt0 + nk, n0);
    cp_async_commit();
    compute_fma(smem + (k % kF32Stages) * kF32Stage, acc);
  }
  cp_async_wait<0>();

  const int tx = tid % 16, ty = tid / 16;
  const int o = n0 + 8 * tx;
  auto store = [&](const float (&v)[8], float* dst) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  };
  if (splits > 1) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int64_t p = m0 + ty + 8 * r;
      if (p < s.m)
        store(acc[r], ws + ((int64_t)blockIdx.z * s.m + p) * s.o + o);
    }
    return;
  }
  float av[8], bv[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    av[c] = a[o + c];
    bv[c] = b[o + c];
  }
  with_act(act, [&](auto tag) {
    constexpr int kAct = decltype(tag)::kAct;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int64_t p = m0 + ty + 8 * r;
      if (p >= s.m) continue;
      float v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        v[c] = apply_act(acc[r][c] * av[c] + bv[c], kAct);
      store(v, out + p * s.o + o);
    }
  });
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma + TMA im2col (see the header note).

constexpr int kWgThreads = 384;  // producer warpgroup + 2 consumers
constexpr int kWgBM = 128;       // output pixels per CTA (64 per consumer)
constexpr int kStages = 4;
constexpr int kABytes = kWgBM * hopper::kBoxRowBytes;  // 16 KB
constexpr int kBBytes = kBN * hopper::kBoxRowBytes;    // 16 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kOutLd = kBN + 8;  // bf16 row stride of the epilogue buffer
constexpr int kOutBytes = 64 * kOutLd * 2;  // one consumer's buffer
constexpr int kOutOff = kStages * kStageBytes;
constexpr int kBarOff = kOutOff + 2 * kOutBytes;
constexpr int kWgSmem = kBarOff + 2 * kStages * 8 + 1024;  // + alignment

// grid = (ceil(M / 128), O / 128, splits), block = 384 threads.
__global__ void __launch_bounds__(kWgThreads, 1)
    conv2d_bn_act_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                               const __grid_constant__ CUtensorMap bmap,
                               const float* __restrict__ a,
                               const float* __restrict__ b,
                               __nv_bfloat16* __restrict__ out,
                               float* __restrict__ ws, Shape s, int act) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + kStages;
  const int64_t m0 = (int64_t)blockIdx.x * kWgBM;
  const int n0 = blockIdx.y * kBN;
  const int splits = gridDim.z;
  const int c_units = s.c / kUnitC;
  int u0, u1;
  split_units(s.kh * s.kw * c_units, splits, blockIdx.z, u0, u1);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, 2);  // one arrival per consumer
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: lane 0 of warp 0 issues the loads ----
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      hopper::prefetch_map(&amap);
      hopper::prefetch_map(&bmap);
      // the tile's first output pixel, as the first tap's input position
      const int64_t hw = (int64_t)s.ho * s.wo;
      const int img = (int)(m0 / hw);
      const int rem = (int)(m0 - (int64_t)img * hw);
      const int oy = rem / s.wo, ox = rem - (rem / s.wo) * s.wo;
      const int w0 = ox * s.sw - s.pw, h0 = oy * s.sh - s.ph;
      int st = 0;
      uint32_t ph = 0;
      for (int u = u0; u < u1; ++u) {
        const int tap = u / c_units;
        const int c0 = (u - tap * c_units) * kUnitC;
        const int i = tap / s.kw, j = tap - i * s.kw;
        hopper::mbar_wait(empty + st, ph ^ 1);
        uint8_t* stage = smem + st * kStageBytes;
        hopper::mbar_expect_tx(full + st, kStageBytes);
        hopper::tma_load_im2col_4d(stage, &amap, full + st, c0, w0, h0, img,
                                   (uint16_t)j, (uint16_t)i);
        hopper::tma_load_2d(stage + kABytes, &bmap, full + st,
                            tap * s.c + c0, n0);
        if (++st == kStages) { st = 0; ph ^= 1; }
      }
    }
  } else {
    // ---- consumers: 64 pixels x 128 channels each ----
    hopper::reg_alloc<232>();
    const int ct = threadIdx.x - 128;
    const int cw = ct >> 7;  // consumer warpgroup
    const int lt = ct & 127;
    const int warp = lt >> 5;
    const int lane = lt & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t sbase = hopper::smem_u32(smem);

    // The epilogue's scale and shift for this thread's 32 channels, read
    // before the K loop so their latency hides behind it (read after it,
    // 32 dependent loads cost about as much as the whole 16x16 layer's
    // products).
    float2 ea[16], eb[16];
    if (splits == 1) {
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int c = n0 + 8 * n + 2 * (lane & 3);
        ea[n] = *reinterpret_cast<const float2*>(a + c);
        eb[n] = *reinterpret_cast<const float2*>(b + c);
      }
    }
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int st = 0, prev = -1;
    uint32_t ph = 0;
    for (int u = u0; u < u1; ++u) {
      hopper::mbar_wait(full + st, ph);
      const uint32_t as = sbase + st * kStageBytes + cw * 64 * 128;
      const uint32_t bs = sbase + st * kStageBytes + kABytes;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_ss128(acc, hopper::desc_sw128(as + kk * 32),
                            hopper::desc_sw128(bs + kk * 32), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the previous unit's products are done
      hopper::fence_regs(acc);
      if (prev >= 0 && lt == 0) hopper::mbar_arrive(empty + prev);
      prev = st;
      if (++st == kStages) { st = 0; ph ^= 1; }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    // Accumulator element 4 n + e: row 16 warp + g + 8 (e / 2), column
    // 8 n + 2 t + (e % 2) of the consumer's 64 x 128 tile (hopper.cuh).
    const int64_t p0 = m0 + cw * 64;
    const int r0 = 16 * warp + g;
    if (splits > 1) {
      float* dst = ws + ((int64_t)blockIdx.z * s.m) * s.o + n0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t p = p0 + r0 + 8 * half;
        if (p >= s.m) continue;
#pragma unroll
        for (int n = 0; n < 16; ++n)
          *reinterpret_cast<float2*>(dst + p * s.o + 8 * n + 2 * t) =
              make_float2(acc[4 * n + 2 * half], acc[4 * n + 2 * half + 1]);
      }
      return;
    }
    __nv_bfloat16* buf =
        reinterpret_cast<__nv_bfloat16*>(smem + kOutOff + cw * kOutBytes);
    with_act(act, [&](auto tag) {
      constexpr int kAct = decltype(tag)::kAct;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int c = 8 * n + 2 * t;
        const float2 av = ea[n], bv = eb[n];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float v0 =
              apply_act(acc[4 * n + 2 * half] * av.x + bv.x, kAct);
          const float v1 =
              apply_act(acc[4 * n + 2 * half + 1] * av.y + bv.y, kAct);
          *reinterpret_cast<__nv_bfloat162*>(
              buf + (r0 + 8 * half) * kOutLd + c) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    });
    hopper::bar_sync(1 + cw, 128);
    const int64_t left = s.m - p0;
    const int rows = left < 64 ? (int)left : 64;
    constexpr int kChunks = kBN * 2 / 16;  // 16-byte chunks a row
    for (int q = lt; q < 64 * kChunks; q += 128) {
      const int r = q / kChunks, c = (q % kChunks) * 8;
      if (r < rows)
        *reinterpret_cast<uint4*>(out + (p0 + r) * s.o + n0 + c) =
            *reinterpret_cast<const uint4*>(buf + r * kOutLd + c);
    }
  }
}

// ---------------------------------------------------------------------------
// The split sum: out = act(sum_{s < S} ws[s] * a + b), splits added in
// order; each thread 4 channels of one pixel.

template <typename T>
__global__ void __launch_bounds__(256)
    conv2d_bn_act_split_sum_kernel(const float* __restrict__ ws,
                                   const float* __restrict__ a,
                                   const float* __restrict__ b,
                                   T* __restrict__ out, int64_t m, int o,
                                   int splits, int act) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int o4 = o / 4;
  if (q >= m * o4) return;
  const int64_t p = q / o4;
  const int c = (int)(q - p * o4) * 4;
  const int64_t plane = m * o;
  float4 sum = *reinterpret_cast<const float4*>(ws + p * o + c);
  for (int sp = 1; sp < splits; ++sp) {
    const float4 v =
        *reinterpret_cast<const float4*>(ws + sp * plane + p * o + c);
    sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
  }
  const float4 av = *reinterpret_cast<const float4*>(a + c);
  const float4 bv = *reinterpret_cast<const float4*>(b + c);
  const float r0 = apply_act(sum.x * av.x + bv.x, act);
  const float r1 = apply_act(sum.y * av.y + bv.y, act);
  const float r2 = apply_act(sum.z * av.z + bv.z, act);
  const float r3 = apply_act(sum.w * av.w + bv.w, act);
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(out + p * o + c) = make_float4(r0, r1, r2, r3);
  } else {
    __nv_bfloat162 lo = __floats2bfloat162_rn(r0, r1);
    __nv_bfloat162 hi = __floats2bfloat162_rn(r2, r3);
    uint2 v;
    v.x = *reinterpret_cast<uint32_t*>(&lo);
    v.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + p * o + c) = v;
  }
}

template <typename T>
int launch_split_sum(const float* ws, const float* a, const float* b,
                     void* out, const Shape& s, int splits, int act,
                     cudaStream_t stream) {
  const int64_t items = s.m * (s.o / 4);
  conv2d_bn_act_split_sum_kernel<T><<<(unsigned)((items + 255) / 256), 256,
                                      0, stream>>>(
      ws, a, b, static_cast<T*>(out), s.m, s.o, splits, act);
  return (int)cudaGetLastError();
}

int launch_fp32(const void* x, const void* wk, const float* a, const float* b,
                void* out, float* ws, const Shape& s, int splits, int act,
                cudaStream_t stream) {
  dim3 grid((unsigned)((s.m + kF32BM - 1) / kF32BM), (unsigned)(s.o / kBN),
            (unsigned)splits);
  conv2d_bn_act_fp32_kernel<<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wk), a, b,
      static_cast<float*>(out), ws, s, act);
  int err = (int)cudaGetLastError();
  if (err || splits == 1) return err;
  return launch_split_sum<float>(ws, a, b, out, s, splits, act, stream);
}

int launch_bf16(const void* x, const void* wk, const float* a, const float* b,
                void* out, float* ws, const Shape& s, int splits, int act,
                cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  int err = set_smem_limit(conv2d_bn_act_wgmma_kernel, kWgSmem, done);
  if (err) return err;
  CUtensorMap am, bm;
  if ((err = hopper::make_im2col_map(&am, x, s.n, s.h, s.w, s.c, s.kh, s.kw,
                                     s.sh, s.sw, s.ph, s.pw, kWgBM)) ||
      (err = hopper::make_map_2d(&bm, wk, (int64_t)s.kh * s.kw * s.c, s.o,
                                 (int64_t)s.kh * s.kw * s.c, kBN)))
    return err;
  dim3 grid((unsigned)((s.m + kWgBM - 1) / kWgBM), (unsigned)(s.o / kBN),
            (unsigned)splits);
  conv2d_bn_act_wgmma_kernel<<<grid, kWgThreads, kWgSmem, stream>>>(
      am, bm, a, b, static_cast<__nv_bfloat16*>(out), ws, s, act);
  err = (int)cudaGetLastError();
  if (err || splits == 1) return err;
  return launch_split_sum<__nv_bfloat16>(ws, a, b, out, s, splits, act,
                                         stream);
}

}  // namespace

// wk: bf16 (O, kh, kw, C), fp32 (kh, kw, C, O).  ws: fp32 (splits, M, O),
// unused (may be null) with one split.
extern "C" int conv2d_bn_act(const void* x, const void* wk, const void* a,
                             const void* b, void* out, void* ws, int n,
                             int h, int w, int c, int o, int kh, int kw,
                             int sh, int sw, int ph, int pw, int splits,
                             int act, int dtype, void* stream) {
  Shape s;
  if (!conv_tile::make_shape(s, n, h, w, c, o, kh, kw, sh, sw, ph, pw,
                             kUnitC, kBN) ||
      act < kNone || act > kSilu || splits < 1 ||
      splits > kh * kw * (c / kUnitC) || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* wsf = static_cast<float*>(ws);
  switch (dtype) {
    case kF32:
      return launch_fp32(x, wk, af, bf, out, wsf, s, splits, act, st);
    case kBF16:
      return launch_bf16(x, wk, af, bf, out, wsf, s, splits, act, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
