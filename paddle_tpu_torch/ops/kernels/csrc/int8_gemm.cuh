// The int8 tensor-core tile shared by the int8 matmul and conv kernels
// (int8_matmul_dequant.cu, int8_conv2d_dequant.cu): mma.sync m16n8k32 with
// s8 operands and s32 accumulators, and the fp32 dequant epilogue.
//
// A CTA of 4 warps owns a 64-row x 128-column output tile and walks K in
// tiles of 64 bytes, three stages deep in shared memory.  A stage holds A
// as 64 rows x 64 int8 values (row = output row, K contiguous) and B as
// 128 rows x 64 values (row = output column, K contiguous), each row padded
// to 80 bytes so the ldmatrix reads of eight rows hit eight distinct bank
// groups.  The s8 mma wants both operands K-contiguous ("row.col"), and
// Hopper has no ldmatrix .trans for 8-bit elements, so B is stored
// transposed in device memory by the caller.  ldmatrix moves 8 x 8 b16
// matrices, i.e. 8 rows x 16 int8 values: thread i receives bytes 4 (i % 4)
// .. 4 (i % 4) + 3 of row i / 4, which is the m16n8k32 A fragment layout
// (row g = lane / 4, K bytes 4 t .. 4 t + 3 for t = lane % 4) and, with
// the output column as the row, the B fragment layout.
//
// Warp (wm, wn) of a 2 x 2 grid owns 32 rows x 64 columns: 2 m16 tiles x 8
// n8 tiles of 4 int32 accumulators.  The sum is exact in int32.  The
// epilogue converts it to fp32 (round to nearest), multiplies by the
// column's scale and adds its bias with __fmul_rn / __fadd_rn (no FMA
// contraction, the plain version's two roundings), applies the act and
// stores fp32 or bf16 (round to nearest even).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "act.cuh"
#include "conv_tile.cuh"
#include "mma_bf16.cuh"

namespace int8_gemm {

constexpr int kBM = 64;        // output rows per CTA
constexpr int kBN = 128;       // output columns per CTA
constexpr int kBK = 64;        // int8 values per K tile
constexpr int kThreads = 128;  // 4 warps
constexpr int kStages = 3;
constexpr int kLd = kBK + 16;  // padded row stride, bytes
constexpr int kA = kBM * kLd;
constexpr int kStage = kA + kBN * kLd;
constexpr int kChunks = kBK / 16;  // 16-byte chunks a row
static_assert(kBM == conv_tile::kBM && kBK == conv_tile::kKBytes &&
                  kThreads == conv_tile::kThreads,
              "the conv's A tile is conv_tile's");

using epilogue_act::apply_act;
using epilogue_act::kNone;
using epilogue_act::kTanh;  // the last act the int8 epilogue takes
enum Out { kF32 = 0, kBF16 = 1 };

struct Acc {
  int v[2][8][4];
};

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.v[mi][ni][e] = 0;
}

// d += a (16 x 32, row) * b (32 x 8, col), s8 in, s32 accumulate.
__device__ __forceinline__ void mma(int* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The products of one K tile (a stage) into the warp's accumulators.
__device__ __forceinline__ void compute_stage(const int8_t* stage,
                                              Acc& acc) {
  const int8_t* As = stage;
  const int8_t* Bs = stage + kA;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 32) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm * 32 + mi * 16 + (lane & 7) + (m & 1) * 8;
      mma_bf16::ldmatrix_x4(a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                            As + r * kLd + kk + (m >> 1) * 16);
    }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      // b[0], b[1]: K halves of n-tile 2 nj; b[2], b[3]: of n-tile 2 nj + 1
      uint32_t b[4];
      const int r = wn * 64 + nj * 16 + (m >> 1) * 8 + (lane & 7);
      mma_bf16::ldmatrix_x4(b[0], b[1], b[2], b[3],
                            Bs + r * kLd + kk + (m & 1) * 16);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma(acc.v[mi][2 * nj], a[mi], b[0], b[1]);
        mma(acc.v[mi][2 * nj + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ float dequant(int acc, float scale,
                                         const float* bias, int col,
                                         int act) {
  float v = __fmul_rn((float)acc, scale);
  if (bias != nullptr) v = __fadd_rn(v, bias[col]);
  return apply_act(v, act);
}

// act(acc * scale + bias) of the CTA's tile at (m0, n0) into the row-major
// (rows, cols) output; rows past `rows` are skipped.
template <typename T>
__device__ __forceinline__ void epilogue(const Acc& acc, const float* scale,
                                         const float* bias, T* out,
                                         int64_t rows, int cols, int64_t m0,
                                         int n0, int act) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t p = m0 + wm * 32 + mi * 16 + g + half * 8;
      if (p >= rows) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int o = n0 + wn * 64 + ni * 8 + 2 * t;
        const float v0 =
            dequant(acc.v[mi][ni][2 * half], scale[o], bias, o, act);
        const float v1 =
            dequant(acc.v[mi][ni][2 * half + 1], scale[o + 1], bias, o + 1,
                    act);
        if constexpr (sizeof(T) == 4)
          *reinterpret_cast<float2*>(out + p * cols + o) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(out + p * cols + o) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// Copy 128 K-contiguous B rows (output columns n0 .. n0 + 127) of one K
// tile: row r starts at b_row(r), 64 bytes.
template <typename RowPtr>
__device__ __forceinline__ void load_b(int8_t* Bs, RowPtr b_row) {
#pragma unroll
  for (int q = 0; q < kBN * kChunks / kThreads; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int r = e / kChunks, ch = e % kChunks;
    conv_tile::cp_async16(Bs + r * kLd + ch * 16, b_row(r) + ch * 16, 16);
  }
}

}  // namespace int8_gemm
