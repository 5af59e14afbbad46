// The in-kernel dropout keep decision, shared by the attention and the
// residual LayerNorm kernels (CUDA side of ops/kernels/dropout.py).
//
// Counterpart of paddle_tpu/ops/pallas/flash_attention.py `_dropout_keep`
// (the murmur3-finalizer position hash the JAX package computes in interpret
// mode): an element is kept when the hash of its global position is at least
// `threshold` = min(int(rate * 2^32), 2^32 - 1), compared unsigned.  The mask
// depends on positions only, never on tiling, so a backward kernel replays
// the forward's mask exactly.  `seed` is the signed int32 seed wrapped to
// uint32; attention passes bh = batch * heads + head, the LayerNorm bh = 0.
#pragma once

#include <stdint.h>

namespace dropout_hash {

constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kP1 = 0x9E3779B1u;
constexpr uint32_t kP2 = 0x85EBCA77u;
constexpr uint32_t kP3 = 0xC2B2AE3Du;

__device__ __forceinline__ bool keep(uint32_t seed, uint32_t bh, uint32_t q,
                                     uint32_t k, uint32_t threshold) {
  uint32_t h = seed + bh * kP3 + q * kP1 + k * kP2;
  h ^= h >> 16;
  h *= kM1;
  h ^= h >> 13;
  h *= kM2;
  h ^= h >> 16;
  return h >= threshold;
}

// The arguments every kernel with in-kernel dropout takes.
struct Params {
  uint32_t seed;
  uint32_t threshold;
  float scale;  // 1 / (1 - rate)
  int on;       // 0: no dropout
};

}  // namespace dropout_hash
