// The int8 GEMM shared by the int8 matmul and conv kernels
// (int8_matmul_dequant.cu, int8_conv2d_dequant.cu), for sm_90a: s8 x s8 ->
// s32 on the tensor cores by wgmma (m64nNk32), operands by TMA, and the
// fp32 dequant epilogue.
//
//   out[r, c] = act(float(sum_k a[r, k] * b[c, k]) * scale[c] + bias[c])
//
// Both operands K-major (8-bit wgmma takes no transposed operand): A as
// (rows, K), B as (columns, K).  K is walked in units of 128 int8 values,
// one 128-byte-swizzled TMA box row (hopper.cuh), so a unit is four k32
// steps at +32 bytes, the descriptor arithmetic of the bf16 kernels' k16
// steps.  A K range that ends inside a unit reads zeros past it (TMA's
// out-of-bounds fill), and a zero times any int8 is zero: the sum is exact.
//
// A CTA of 384 threads: warpgroup 0 the producer (lane 0 of warp 0 issues
// the TMA loads into a ring of kStages stages with mbarrier full / empty
// pairs; setmaxnreg 40), warpgroups 1 and 2 the consumers (setmaxnreg
// 232), each owning 64 rows x kBN columns of the CTA's 128-row tile with
// kBN / 2 s32 accumulators a thread.  A consumer keeps one unit's products
// in flight (wgmma.wait_group 1) before it frees the previous stage.
//
// Persistent and split K: the work items are (output tile, K split) pairs,
// tile-major with the splits of a tile adjacent; CTA i takes items i, i +
// grid, ...  (the grid is at most one wave).  The producer runs ahead into
// the next item while the consumers run the epilogue of the last, so one
// tile's stores overlap the next tile's loads.  Split s of S takes the
// units [s U / S, (s + 1) U / S).  With one split the epilogue writes the
// output; with more, each item writes its int32 partial tile to a
// workspace (S, rows, cols) and the split-sum kernel adds the S partials
// (exact in int32, so any order gives the same bits) and applies the
// epilogue once per output.
//
// Epilogue (= ops/kernels/int8.py `_epilogue`): int32 -> fp32 rounded to
// nearest, __fmul_rn by scale, __fadd_rn of bias (no FMA: the plain
// version's two roundings), the act as a compile-time template parameter,
// fp32 or bf16 (round to nearest even) out.  scale and bias of the tile's
// columns go to shared memory before the K loop.  A consumer stages its
// values (or int32 partials) 64 columns at a time in shared memory in the
// 128-byte-swizzled box layout and one thread stores them by TMA (rows
// past M are clipped by the store); the last store runs while the consumer
// starts the next item's products, and a buffer is waited for only when it
// is written again.  Five stages and 64-column passes were the fastest of
// the shapes measured (experiments/int8_experiments.py variants).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act.cuh"
#include "attention_layout.cuh"
#include "hopper.cuh"

namespace int8_gemm {

constexpr int kUnitK = 128;    // int8 values of one K unit (a box row)
constexpr int kBM = 128;       // output rows per tile (64 per consumer)
constexpr int kBN = 128;       // output columns per tile (128 or 256)
constexpr int kStages = 5;
constexpr int kThreads = 384;  // producer warpgroup + 2 consumers
constexpr int kChunkN = 64;    // output columns an epilogue pass stages
constexpr int kABytes = kBM * kUnitK;
constexpr int kBBytes = kBN * kUnitK;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kOutBoxBytes = 64 * hopper::kBoxRowBytes;  // a store box
constexpr int kOutBytes = 64 * kChunkN * 4;  // a consumer's staged values
constexpr int kParamBytes = 2 * kBN * 4;     // one consumer's scale, bias
constexpr int kOutOff = kStages * kStageBytes;
constexpr int kParamOff = kOutOff + 2 * kOutBytes;
constexpr int kBarOff = kParamOff + 2 * kParamBytes;
constexpr int kSmem = kBarOff + 2 * kStages * 8 + 1024;  // + alignment
static_assert(kBN == 128 || kBN == 256, "wgmma n128 or n256");
static_assert(kSmem <= 232448, "shared memory of one CTA");

enum Out { kF32 = 0, kBF16 = 1 };

// -- s8 wgmma -------------------------------------------------------------------

#define I8_ACC8(o) \
  "+r"(d[o + 0]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]), \
      "+r"(d[o + 4]), "+r"(d[o + 5]), "+r"(d[o + 6]), "+r"(d[o + 7])

// d (64 x 128, s32) += A (64 x 32, s8, shared, K-major) B^T (128 x 32, s8,
// shared, K-major).
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : I8_ACC8(0), I8_ACC8(8), I8_ACC8(16), I8_ACC8(24), I8_ACC8(32),
        I8_ACC8(40), I8_ACC8(48), I8_ACC8(56)
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 256, s32) += A (64 x 32, s8, shared, K-major) B^T (256 x 32, s8,
// shared, K-major).
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : I8_ACC8(0), I8_ACC8(8), I8_ACC8(16), I8_ACC8(24), I8_ACC8(32),
        I8_ACC8(40), I8_ACC8(48), I8_ACC8(56), I8_ACC8(64), I8_ACC8(72),
        I8_ACC8(80), I8_ACC8(88), I8_ACC8(96), I8_ACC8(104), I8_ACC8(112),
        I8_ACC8(120)
      : "l"(a), "l"(b), "r"(1));
}

#undef I8_ACC8

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint32_t a,
                                         uint32_t b) {
  if constexpr (N == 256)
    wgmma_s8_n256(d, hopper::desc_sw128(a), hopper::desc_sw128(b));
  else
    wgmma_s8_n128(d, hopper::desc_sw128(a), hopper::desc_sw128(b));
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// -- work items ---------------------------------------------------------------

struct Geometry {
  int64_t rows;  // output rows (M)
  int cols;      // output columns (N), the output's row stride
  int units;     // K units
  int splits;
  int tiles_n;   // cols / kBN
  int items;     // tiles * splits

  __device__ __forceinline__ void item(int q, int64_t& m0, int& n0,
                                       int& split, int& u0, int& u1) const {
    split = q % splits;
    const int tile = q / splits;
    m0 = (int64_t)(tile / tiles_n) * kBM;
    n0 = (tile % tiles_n) * kBN;
    u0 = (int)((int64_t)split * units / splits);
    u1 = (int)((int64_t)(split + 1) * units / splits);
  }
};

// Geometry of an (rows x cols) output over `units` K units in `splits`
// splits; false when the items overflow an int.
inline bool make_geometry(Geometry& g, int64_t rows, int cols, int units,
                          int splits) {
  const int64_t tiles = (rows + kBM - 1) / kBM * (cols / kBN);
  if (rows <= 0 || cols <= 0 || cols % kBN || units <= 0 || splits < 1 ||
      splits > units || tiles * splits > 0x7fffffff)
    return false;
  g.rows = rows;
  g.cols = cols;
  g.units = units;
  g.splits = splits;
  g.tiles_n = cols / kBN;
  g.items = (int)(tiles * splits);
  return true;
}

// -- epilogue -------------------------------------------------------------------

template <int kAct>
__device__ __forceinline__ float dequant(int acc, float scale, float bias,
                                         bool has_bias) {
  float v = __fmul_rn(__int2float_rn(acc), scale);
  if (has_bias) v = __fadd_rn(v, bias);
  return epilogue_act::apply_act(v, kAct);
}

template <typename U>
__device__ __forceinline__ void put2(U* p, float v0, float v1);
template <>
__device__ __forceinline__ void put2<float>(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
template <>
__device__ __forceinline__ void put2<__nv_bfloat16>(__nv_bfloat16* p,
                                                    float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// Element (r, c) of a consumer's staged 64 x kChunkN tile of kE-byte
// values: box c * kE / 128 of 64 rows x 128 bytes, 16-byte chunk j of row r
// at chunk j ^ (r % 8) (the 128-byte swizzle the store's map reads).
template <int kE>
__device__ __forceinline__ uint8_t* staged(uint8_t* buf, int r, int c) {
  const int byte = c * kE;
  const int within = byte & 127;
  return buf + (byte >> 7) * kOutBoxBytes + r * 128 +
         ((((within >> 4) ^ (r & 7)) << 4) | (within & 15));
}

// Stage a consumer's accumulator pairs: put(p, n, half) writes elements
// 4 (kChunkN / 8 chunk + n) + 2 half and + 1 (row 16 warp + g + 8 half,
// columns 8 n + 2 t and + 1 of the chunk) at p.
template <int kE, typename Put>
__device__ __forceinline__ void stage(uint8_t* buf, int lt, Put put) {
  const int warp = lt >> 5, g = (lt & 31) >> 2, t = lt & 3;
#pragma unroll
  for (int n = 0; n < kChunkN / 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      put(staged<kE>(buf, 16 * warp + g + 8 * half, 8 * n + 2 * t), n,
          half);
}

// -- the kernel body ------------------------------------------------------------

// `load(a, b, bar, m0, n0, u)` issues the TMA loads of K unit u of the tile
// at (m0, n0): A's 128 rows into a, B's kBN rows into b, kStageBytes in all,
// counted on bar.  `omap` is the 3-d store map (cols, rows, planes) of the
// T output (one plane) or, with more than one split, of the int32
// workspace (one plane a split).
template <typename T, int kAct, typename Load>
__device__ __forceinline__ void gemm(const Geometry& g,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ bias,
                                     const CUtensorMap* omap, Load load) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + kStages;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, 2);  // one arrival per consumer
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      load.prefetch();
      int st = 0;
      uint32_t ph = 0;
      for (int q = blockIdx.x; q < g.items; q += gridDim.x) {
        int64_t m0;
        int n0, split, u0, u1;
        g.item(q, m0, n0, split, u0, u1);
        for (int u = u0; u < u1; ++u) {
          hopper::mbar_wait(empty + st, ph ^ 1);
          uint8_t* stage = smem + st * kStageBytes;
          hopper::mbar_expect_tx(full + st, kStageBytes);
          load(stage, stage + kABytes, full + st, m0, n0, u);
          if (++st == kStages) { st = 0; ph ^= 1; }
        }
      }
    }
    return;
  }

  // ---- consumers: 64 rows x kBN columns each ----
  hopper::reg_alloc<232>();
  const int ct = threadIdx.x - 128;
  const int cw = ct >> 7;  // consumer warpgroup
  const int lt = ct & 127;
  const int bar = 1 + cw;  // the warpgroup's named barrier
  const uint32_t sbase = hopper::smem_u32(smem);
  uint8_t* buf = smem + kOutOff + cw * kOutBytes;
  float* s_scale = reinterpret_cast<float*>(smem + kParamOff +
                                            cw * kParamBytes);
  float* s_bias = s_scale + kBN;
  const bool has_bias = bias != nullptr;
  int st = 0;
  uint32_t ph = 0;
  for (int q = blockIdx.x; q < g.items; q += gridDim.x) {
    int64_t m0;
    int n0, split, u0, u1;
    g.item(q, m0, n0, split, u0, u1);
    if (g.splits == 1) {
      // this tile's scale and bias, read before the K loop so their
      // latency hides behind it (the previous item's epilogue ended with a
      // barrier, so nobody reads the old values any more)
      for (int c = lt; c < kBN; c += 128) {
        s_scale[c] = scale[n0 + c];
        s_bias[c] = has_bias ? bias[n0 + c] : 0.0f;
      }
    }
    int acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
    int prev = -1;
    for (int u = u0; u < u1; ++u) {
      hopper::mbar_wait(full + st, ph);
      const uint32_t as = sbase + st * kStageBytes + cw * 64 * kUnitK;
      const uint32_t bs = sbase + st * kStageBytes + kABytes;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kUnitK / 32; ++kk)
        wgmma_s8<kBN>(acc, as + kk * 32, bs + kk * 32);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the previous unit's products are done
      fence_regs(acc);
      if (prev >= 0 && lt == 0) hopper::mbar_arrive(empty + prev);
      prev = st;
      if (++st == kStages) { st = 0; ph ^= 1; }
    }
    hopper::wgmma_wait<0>();
    fence_regs(acc);
    if (lt == 0) hopper::mbar_arrive(empty + prev);

    // the previous item's stores have read the buffer; s_scale / s_bias
    // (written before the K loop) are visible after the barrier
    const bool partial = g.splits > 1;
    const int p0 = (int)(m0 + cw * 64);
#pragma unroll
    for (int ch = 0; ch < kBN / kChunkN; ++ch) {
      if (lt == 0) hopper::bulk_wait_read<0>();
      hopper::bar_sync(bar, 128);
      if (partial) {
        stage<4>(buf, lt, [&](uint8_t* p, int n, int half) {
          const int e = 4 * (kChunkN / 8 * ch + n) + 2 * half;
          *reinterpret_cast<int2*>(p) = make_int2(acc[e], acc[e + 1]);
        });
      } else {
        const int t2 = 2 * (lt & 3);
        stage<(int)sizeof(T)>(buf, lt, [&](uint8_t* p, int n, int half) {
          const int e = 4 * (kChunkN / 8 * ch + n) + 2 * half;
          const int c = ch * kChunkN + 8 * n + t2;
          const float2 sc = *reinterpret_cast<const float2*>(s_scale + c);
          const float2 bi = *reinterpret_cast<const float2*>(s_bias + c);
          put2<T>(reinterpret_cast<T*>(p),
                  dequant<kAct>(acc[e], sc.x, bi.x, has_bias),
                  dequant<kAct>(acc[e + 1], sc.y, bi.y, has_bias));
        });
      }
      hopper::fence_proxy_async();
      hopper::bar_sync(bar, 128);
      if (lt == 0) {
        const int eb = partial ? 4 : (int)sizeof(T);
        for (int b = 0; b < kChunkN * eb / 128; ++b)
          hopper::tma_store_3d(omap, buf + b * kOutBoxBytes,
                               n0 + ch * kChunkN + b * (128 / eb), p0,
                               partial ? split : 0);
        hopper::bulk_commit();
      }
    }
  }
  if (lt == 0) hopper::bulk_wait<0>();
}

// The split sum: out = act(float(sum_s ws[s]) * scale + bias), each thread
// 4 columns of one row.
template <typename T, int kAct>
__device__ __forceinline__ void split_sum(const int32_t* __restrict__ ws,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ bias,
                                          T* __restrict__ out, int64_t rows,
                                          int cols, int splits) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int c4 = cols / 4;
  if (q >= rows * c4) return;
  const int64_t r = q / c4;
  const int c = (int)(q - r * c4) * 4;
  const int64_t plane = rows * cols;
  int4 sum = *reinterpret_cast<const int4*>(ws + r * cols + c);
  for (int sp = 1; sp < splits; ++sp) {
    const int4 v = *reinterpret_cast<const int4*>(ws + sp * plane + r * cols +
                                                  c);
    sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
  }
  const bool has_bias = bias != nullptr;
  float bi[4] = {0.f, 0.f, 0.f, 0.f};
  if (has_bias)
    for (int i = 0; i < 4; ++i) bi[i] = bias[c + i];
  const float v0 = dequant<kAct>(sum.x, scale[c], bi[0], has_bias);
  const float v1 = dequant<kAct>(sum.y, scale[c + 1], bi[1], has_bias);
  const float v2 = dequant<kAct>(sum.z, scale[c + 2], bi[2], has_bias);
  const float v3 = dequant<kAct>(sum.w, scale[c + 3], bi[3], has_bias);
  put2<T>(out + r * cols + c, v0, v1);
  put2<T>(out + r * cols + c + 2, v2, v3);
}

// -- host -------------------------------------------------------------------------

// The kernel's store map: over the T output (one plane) or, with more than
// one split, over the int32 workspace (splits planes of rows x cols).
template <typename T>
int store_map(CUtensorMap* map, void* out, int32_t* ws, const Geometry& g) {
  if (g.splits > 1)
    return hopper::make_map_3d(map, ws, g.cols, g.rows, g.splits, 64,
                               hopper::Elem::kI32);
  return hopper::make_map_3d(map, out, g.cols, g.rows, 1, 64,
                             sizeof(T) == 4 ? hopper::Elem::kF32
                                            : hopper::Elem::kBF16);
}


template <typename T>
struct TypeTag {
  using type = T;
};

template <int A>
struct ActTag {
  static constexpr int kAct = A;
};

// f(TypeTag<T>{}, ActTag<act>{}) with the output type and the act as
// compile-time constants; cudaErrorInvalidValue for codes out of range.
template <typename F>
int dispatch(int act, int out_dtype, F&& f) {
  auto by_act = [&](auto tt) -> int {
    switch (act) {
      case epilogue_act::kNone: return f(tt, ActTag<epilogue_act::kNone>{});
      case epilogue_act::kRelu: return f(tt, ActTag<epilogue_act::kRelu>{});
      case epilogue_act::kRelu6: return f(tt, ActTag<epilogue_act::kRelu6>{});
      case epilogue_act::kSigmoid:
        return f(tt, ActTag<epilogue_act::kSigmoid>{});
      case epilogue_act::kTanh: return f(tt, ActTag<epilogue_act::kTanh>{});
      default: return (int)cudaErrorInvalidValue;
    }
  };
  switch (out_dtype) {
    case kF32: return by_act(TypeTag<float>{});
    case kBF16: return by_act(TypeTag<__nv_bfloat16>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace int8_gemm
