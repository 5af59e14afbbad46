// sm_90a building blocks of the bf16 attention and convolution kernels and
// the int8 GEMMs: TMA tensor maps (tiled and im2col, bf16 or int8) and
// loads, mbarriers, named barriers, warpgroup register hand-over, and bf16
// wgmma with its shared-memory descriptors (the s8 wgmma is in
// int8_gemm.cuh; its descriptors are these).
//
// Tiles.  Every operand tile in shared memory is a column of "boxes": one
// TMA box is `rows` rows of 64 bf16 (128 bytes), stored with the 128-byte
// swizzle (16-byte chunk c of row r sits at chunk c ^ (r % 8)), each box
// 1024-byte aligned.  A head row of d values is d / 64 boxes side by side.
//   * K-major operand (the reduction runs along the 64 columns: Q and K in
//     Q K^T): a 16-deep k-step is the box's start address + 32 bytes * k.
//   * MN-major operand (the reduction runs along the rows: V in P V): a
//     16-deep k-step is the start address + 16 rows * 128 bytes, and one
//     box gives 64 output columns.
// Both use stride 1024 bytes between 8-row groups (SBO) and the 128-byte
// swizzle layout type.
//
// wgmma accumulator layout (m64nN, fp32), for thread 128 w' + 32 w + lane of
// a warpgroup, g = lane / 4, t = lane % 4: element 4 n + e is row 16 w + g
// + 8 (e / 2), column 8 n + 2 t + (e % 2) -- the mma.sync m16n8k16 C layout
// of each 8-column tile.  The register A fragment of a 16-deep k-step kk is
// {pack(acc[8kk], acc[8kk+1]), pack(acc[8kk+2], acc[8kk+3]),
//  pack(acc[8kk+4], acc[8kk+5]), pack(acc[8kk+6], acc[8kk+7])} of an
// accumulator whose columns are that k index.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kBoxCols = 64;                     // bf16 per box row
constexpr int kBoxRowBytes = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The first 1024-byte boundary at or after p: the 128-byte swizzle repeats
// every 1024 bytes, so a swizzled tile starts on one.
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~(uintptr_t)1023);
}

// -- mbarriers ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(addr),
      "r"(parity)
      : "memory");
}

// -- named barriers among a subset of warps (id 0 is __syncthreads) -----------

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -- warpgroup register hand-over ---------------------------------------------

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// -- TMA ----------------------------------------------------------------------

// Load box (c0, c1, c2, c3) of a 4-d tensor map into shared memory, counted
// on `bar` in bytes; coordinates past the tensor's end read as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Load box (c0, c1) of a 2-d tensor map into shared memory, counted on
// `bar` in bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Im2col load of a 4-d (C, W, H, N) map: the map's pixelsPerColumn pixels
// from the start pixel (w, h, n) on, walked through the map's bounding box
// W first, then H, then N, at its traversal strides; each pixel read at
// (w + off_w, h + off_h) (the filter tap), channels c .. c +
// channelsPerPixel.  Pixels outside the tensor read as zeros.
__device__ __forceinline__ void tma_load_im2col_4d(void* dst,
                                                   const CUtensorMap* map,
                                                   uint64_t* bar, int c,
                                                   int w, int h, int n,
                                                   uint16_t off_w,
                                                   uint16_t off_h) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c),
      "r"(w), "r"(h), "r"(n), "h"(off_w), "h"(off_h)
      : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Store box (c0, c1, c2) of a 3-d tensor map from shared memory (rows past
// the tensor are not written); completion is tracked by bulk groups.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N committed bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until at most N committed bulk groups are still incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Order this thread's shared-memory writes before later reads by the async
// proxy (a TMA store).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// -- wgmma --------------------------------------------------------------------

__device__ __forceinline__ uint64_t desc_encode(uint32_t x) {
  return (uint64_t)((x & 0x3FFFF) >> 4);
}

// Descriptor of a 128-byte-swizzled operand starting at shared address
// `addr` (LBO 16 bytes, unused by these layouts; SBO 1024 bytes).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return desc_encode(addr) | (desc_encode(16) << 16) |
         (desc_encode(1024) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_ACC8(o) \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// d (64 x 64) (+)= A (64 x 16, shared, K-major) B (16 x 64, shared,
// K-major).
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32) (+)= A (64 x 16, shared, K-major) B (16 x 32, shared,
// K-major).
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128) (+)= A (64 x 16, shared, K-major) B (16 x 128, shared,
// K-major).
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1, 0, 0;\n}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24),
        HOPPER_ACC8(32), HOPPER_ACC8(40), HOPPER_ACC8(48), HOPPER_ACC8(56)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16, registers) B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t* a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef HOPPER_ACC8

// d (64 x N) += A (64 x 16) B^T (N x 16), both K-major in shared memory at
// shared addresses a and b (N = 128, 64 or 32).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint32_t a,
                                         uint32_t b) {
  if constexpr (N == 128)
    wgmma_ss128(d, desc_sw128(a), desc_sw128(b), 1);
  else if constexpr (N == 64)
    wgmma_ss64(d, desc_sw128(a), desc_sw128(b), 1);
  else
    wgmma_ss32(d, desc_sw128(a), desc_sw128(b), 1);
}

// 2^x in one MUFU instruction; results below 2^-126 flush to zero (the
// softmax probabilities this gives are far below bf16's resolution of the
// row's largest, which is 1).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The register A fragment of k-step kk of an accumulator (see above).
template <int N>
__device__ __forceinline__ void a_fragment(uint32_t* a, const float (&x)[N],
                                           int kk) {
  a[0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
  a[1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
}

// A consumer warpgroup's 64 x (boxes * 64) fp32 accumulators (NB wgmma
// m64n64 tiles, the first `boxes` valid) written as bf16 rows of global
// memory at `dst` (row stride `row_stride` elements), the first `rows`
// rows: staged in the shared buffer `buf` (64 x (NB * 64 + 8) bf16, 16-byte
// aligned), then copied with 16-byte stores along the rows.  `bar` is a
// named barrier of the warpgroup's 128 threads; `lt` the thread's index in
// the warpgroup.
template <int NB>
__device__ __forceinline__ void store_tile_bf16(const float (&acc)[NB][32],
                                                int boxes,
                                                __nv_bfloat16* buf,
                                                __nv_bfloat16* dst,
                                                int64_t row_stride, int rows,
                                                int bar, int lt) {
  constexpr int ld = NB * 64 + 8;
  const int warp = lt >> 5, g = (lt & 31) >> 2, t = lt & 3;
#pragma unroll
  for (int v = 0; v < NB; ++v) {
    if (v >= boxes) break;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int r = 16 * warp + g, c = 64 * v + 8 * n + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(buf + r * ld + c) =
          __floats2bfloat162_rn(acc[v][4 * n], acc[v][4 * n + 1]);
      *reinterpret_cast<__nv_bfloat162*>(buf + (r + 8) * ld + c) =
          __floats2bfloat162_rn(acc[v][4 * n + 2], acc[v][4 * n + 3]);
    }
  }
  bar_sync(bar, 128);
  const int chunks = boxes * 8;  // 16-byte chunks a row
  for (int x = lt; x < 64 * chunks; x += 128) {
    const int r = x / chunks, c = (x % chunks) * 8;
    if (r < rows)
      *reinterpret_cast<uint4*>(dst + r * row_stride + c) =
          *reinterpret_cast<const uint4*>(buf + r * ld + c);
  }
}

// -- host: tensor maps --------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no
// -lcuda at link time).
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const int*, const int*,
                                 cuuint32_t, cuuint32_t, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeIm2col, found as encode_fn() finds the tiled encoder.
inline EncodeIm2col encode_im2col_fn() {
  static EncodeIm2col fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeIm2col", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeIm2col>(p);
  }
  return fn;
}

// Element types of the maps below: a box row is always 128 bytes, so 64
// bf16 or 128 int8 values (int8 maps are UINT8 maps: TMA copies bytes, and
// its zero fill is the int8 zero).
enum class Elem { kBF16, kI8, kF32, kI32 };

inline CUtensorMapDataType map_type(Elem e) {
  switch (e) {
    case Elem::kBF16: return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    case Elem::kI8: return CU_TENSOR_MAP_DATA_TYPE_UINT8;
    case Elem::kF32: return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    default: return CU_TENSOR_MAP_DATA_TYPE_INT32;
  }
}

inline int elem_bytes(Elem e) {
  return e == Elem::kI8 ? 1 : (e == Elem::kBF16 ? 2 : 4);
}

// The 2-d map (cols, rows) of a row-major matrix with `ld` elements between
// rows (16 bytes' worth), read in boxes of one 128-byte row of columns x
// `box_rows` rows with the 128-byte swizzle; columns and rows past the
// matrix read as zeros.
inline int make_map_2d(CUtensorMap* map, const void* base, int64_t cols,
                       int64_t rows, int64_t ld, int box_rows,
                       Elem elem = Elem::kBF16) {
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorNotSupported;
  const int eb = elem_bytes(elem);
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld * eb)};
  const cuuint32_t box[2] = {(cuuint32_t)(kBoxRowBytes / eb),
                             (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, map_type(elem), 2,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The 3-d map (cols, rows, planes) of `planes` row-major (rows, cols)
// matrices stored one after the other (cols a multiple of 16 bytes' worth),
// in boxes of one 128-byte row of columns x `box_rows` rows x 1 plane with
// the 128-byte swizzle; a store clips what lies past the matrix.
inline int make_map_3d(CUtensorMap* map, const void* base, int64_t cols,
                       int64_t rows, int64_t planes, int box_rows,
                       Elem elem) {
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorNotSupported;
  const int eb = elem_bytes(elem);
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)(cols * eb),
                                 (cuuint64_t)(rows * cols * eb)};
  const cuuint32_t box[3] = {(cuuint32_t)(kBoxRowBytes / eb),
                             (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, map_type(elem), 3, const_cast<void*>(base),
                        dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The im2col map of an NHWC image batch (n, h, w, c) for a kh x kw filter
// at stride (sh, sw) and zero padding (ph, pw): the bounding box of a
// filter's first tap runs from -p to size + p - k (both ends inclusive), so
// one walk of it visits the output pixels in (n, y, x) order; each load
// fills `pixels` rows of one 128-byte row of channels (64 bf16 or 128
// int8, 128-byte swizzle; channels past c read as zeros).  Corners must
// lie in [-128, 127] (rank 4).
constexpr int kIm2colCornerMin = -128;
constexpr int kIm2colCornerMax = 127;

inline int make_im2col_map(CUtensorMap* map, const void* base, int n, int h,
                           int w, int c, int kh, int kw, int sh, int sw,
                           int ph, int pw, int pixels,
                           Elem elem = Elem::kBF16) {
  EncodeIm2col fn = encode_im2col_fn();
  if (!fn) return (int)cudaErrorNotSupported;
  const int eb = elem_bytes(elem);
  const int lower[2] = {-pw, -ph};
  const int upper[2] = {pw - (kw - 1), ph - (kh - 1)};
  for (int i = 0; i < 2; ++i)
    if (lower[i] < kIm2colCornerMin || upper[i] > kIm2colCornerMax ||
        upper[i] < kIm2colCornerMin)
      return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)c * eb,
                                 (cuuint64_t)w * c * eb,
                                 (cuuint64_t)h * w * c * eb};
  const cuuint32_t estr[4] = {1, (cuuint32_t)sw, (cuuint32_t)sh, 1};
  const CUresult r = fn(map, map_type(elem), 4, const_cast<void*>(base),
                        dims, strides, lower, upper,
                        (cuuint32_t)(kBoxRowBytes / eb), (cuuint32_t)pixels,
                        estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The 4-d map (head_dim, seq, heads, batch) of one bf16 operand with element
// strides (row, head, batch), read in boxes of 64 columns x `box_rows` rows
// with the 128-byte swizzle; rows past seq read as zeros.  Returns a CUDA
// error code (0 on success).
inline int make_map(CUtensorMap* map, const void* base, int head_dim, int seq,
                    int heads, int batch, int64_t row, int64_t head,
                    int64_t bstride, int box_rows) {
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorNotSupported;
  // A dimension of extent 1 is never stepped over; give it a stride TMA
  // accepts (a multiple of 16 bytes) whatever the caller's view says.
  if (seq == 1) row = head_dim;
  if (heads == 1) head = row * seq;
  if (batch == 1) bstride = head * heads;
  const cuuint64_t dims[4] = {(cuuint64_t)head_dim, (cuuint64_t)seq,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)row * 2, (cuuint64_t)head * 2,
                                 (cuuint64_t)bstride * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBoxCols, (cuuint32_t)box_rows, 1,
                             1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hopper
