// Implicit-GEMM addressing of the NHWC convolution kernels: the
// convolution's Shape (conv2d_bn_act.cu, int8_conv2d_dequant.cu) and the
// cp.async A tile of conv2d_bn_act.cu's fp32 route.
//
// M = n * Ho * Wo output pixels, K = kh * kw * C.  A CTA of 4 warps owns
// 64 output pixels and walks K in tiles of one filter tap and 64 bytes of
// channels.  Each thread copies two of the tile's 64 input rows, one
// 16-byte chunk each, with cp.async; a row whose tap falls in the padding
// or past the last pixel is zero-filled (source size 0), so padding needs
// no padded copy of the input.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace conv_tile {

constexpr int kBM = 64;        // output pixels per CTA
constexpr int kKBytes = 64;    // channel bytes per K tile
constexpr int kThreads = 128;  // 4 warps
constexpr int kChunksA = kKBytes / 16;         // 16-byte chunks an A row
constexpr int kRowStep = kThreads / kChunksA;  // rows between a thread's two

// 16 bytes from global to shared memory, zero-filled past src_bytes.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   mma_bf16::smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Shape {
  int n, h, w, c, o, kh, kw, sh, sw, ph, pw, ho, wo;
  int64_t m;  // n * ho * wo
};

// The shape of a convolution from its C entry's arguments; false for a
// shape the kernels refuse (C % c_align, O % o_align, empty output, a grid
// of more than 2^31 - 1 pixel tiles).
inline bool make_shape(Shape& s, int n, int h, int w, int c, int o, int kh,
                       int kw, int sh, int sw, int ph, int pw, int c_align,
                       int o_align) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c % c_align != 0 || o <= 0 ||
      o % o_align != 0 || kh <= 0 || kw <= 0 || sh <= 0 || sw <= 0 ||
      ph < 0 || pw < 0 || h + 2 * ph < kh || w + 2 * pw < kw)
    return false;
  s.n = n; s.h = h; s.w = w; s.c = c; s.o = o; s.kh = kh; s.kw = kw;
  s.sh = sh; s.sw = sw; s.ph = ph; s.pw = pw;
  s.ho = (h + 2 * ph - kh) / sh + 1;
  s.wo = (w + 2 * pw - kw) / sw + 1;
  s.m = (int64_t)n * s.ho * s.wo;
  return (s.m + kBM - 1) / kBM <= 0x7fffffff;
}

// The two A rows a thread copies per K tile: their image, output row and
// column (or image -1 past the last pixel), fixed for the whole K loop.
struct RowInfo {
  int img[2], oy[2], ox[2];
};

__device__ __forceinline__ RowInfo row_info(const Shape& s, int64_t m0) {
  RowInfo ri;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int64_t p = m0 + threadIdx.x / kChunksA + q * kRowStep;
    if (p < s.m) {
      const int64_t hw = (int64_t)s.ho * s.wo;
      ri.img[q] = (int)(p / hw);
      const int rem = (int)(p - (int64_t)ri.img[q] * hw);
      ri.oy[q] = rem / s.wo;
      ri.ox[q] = rem - ri.oy[q] * s.wo;
    } else {
      ri.img[q] = -1;
      ri.oy[q] = ri.ox[q] = 0;
    }
  }
  return ri;
}

// Copy the A tile of tap (i, j), channels [c0, c0 + kKBytes / sizeof(T)),
// into As (kBM rows, row stride ld elements).
template <typename T>
__device__ __forceinline__ void load_a(T* As, int ld, const T* x,
                                       const Shape& s, const RowInfo& ri,
                                       int i, int j, int c0) {
  constexpr int kPerChunk = 16 / (int)sizeof(T);
  const int chunk = threadIdx.x % kChunksA;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int r = threadIdx.x / kChunksA + q * kRowStep;
    const int y = ri.oy[q] * s.sh - s.ph + i;
    const int xx = ri.ox[q] * s.sw - s.pw + j;
    const bool ok = ri.img[q] >= 0 && y >= 0 && y < s.h && xx >= 0 &&
                    xx < s.w;
    const T* src = x;
    if (ok)
      src = x + (((int64_t)ri.img[q] * s.h + y) * s.w + xx) * s.c + c0 +
            chunk * kPerChunk;
    cp_async16(As + r * ld + chunk * kPerChunk, src, ok ? 16 : 0);
  }
}

}  // namespace conv_tile
