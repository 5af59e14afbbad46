// bf16 tensor-core building blocks shared by the attention kernels:
// ldmatrix fragment loads and mma.sync m16n8k16 (bf16 in, fp32 accumulate).
//
// Fragment layout of mma.sync.m16n8k16 for lane = 4 * g + t:
//   A (16 x 16, row):  a0 (row g, cols 2t..2t+1), a1 (row g+8, 2t..),
//                      a2 (row g, 2t+8..),        a3 (row g+8, 2t+8..);
//   B (16 x 8, col):   b0 (k rows 2t..2t+1, col g), b1 (k rows 2t+8.., col g);
//   C (16 x 8):        c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, ...).
// So the C fragments of two neighbouring 8-column tiles are, packed to bf16,
// the A fragment of a 16-deep product (see pack_bf16).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (16 rows x 16 deep) of rows [row0, row0 + 16) and columns
// [col0, col0 + 16) of a row-major bf16 shared tile with row stride ld.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* tile,
                                       int ld, int row0, int col0, int lane) {
  const int r = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(a[0], a[1], a[2], a[3], tile + r * ld + col0 + (lane >> 4) * 8);
}

// B fragments of two 8-column n-tiles of X^T, for X a row-major shared tile
// (rows = the product's n index, columns = its k index): n-tiles at rows
// [n0, n0 + 8) and [n0 + 8, n0 + 16), k columns [k0, k0 + 16).
__device__ __forceinline__ void load_b_t(uint32_t* b,
                                         const __nv_bfloat16* tile, int ld,
                                         int n0, int k0, int lane) {
  const int m = lane >> 3;
  const int r = n0 + (m >> 1) * 8 + (lane & 7);
  ldmatrix_x4(b[0], b[1], b[2], b[3], tile + r * ld + k0 + (m & 1) * 8);
}

// B fragments of two 8-column n-tiles of X itself, for X a row-major shared
// tile (rows = the k index, columns = n): k rows [k0, k0 + 16), n columns
// [n0, n0 + 8) and [n0 + 8, n0 + 16).
__device__ __forceinline__ void load_b(uint32_t* b, const __nv_bfloat16* tile,
                                       int ld, int k0, int n0, int lane) {
  const int m = lane >> 3;
  const int r = k0 + (m & 1) * 8 + (lane & 7);
  ldmatrix_x4_trans(b[0], b[1], b[2], b[3], tile + r * ld + n0 + (m >> 1) * 8);
}

}  // namespace mma_bf16
