"""The in-kernel dropout hash (counterpart of paddle_tpu/ops/pallas/
flash_attention.py ``_dropout_keep`` and layer_norm.py ``_keep_tile``).

The keep decision for one element is a murmur3-finalizer hash of its global
position, so a mask never exists in device memory and the forward and
backward kernels replay it exactly, whatever their tiling:

    h = seed + bh * P3 + q_pos * P1 + k_pos * P2      (mod 2**32)
    h ^= h >> 16; h *= M1; h ^= h >> 13; h *= M2; h ^= h >> 16
    keep = h >= min(int(rate * 2**32), 2**32 - 1)     (unsigned)

Attention keys it by (batch * heads + head, query, key); the residual
LayerNorm by (0, row, column) of its (n, dim) view.  This is the hash the
JAX package computes in interpret mode, so the masks of the port's kernels
and plain versions are bit-identical to the JAX Pallas functions on the
CPU.  (The TPU's hardware-PRNG masks have no CPU counterpart and are not
reproduced.)  The CUDA side is ``csrc/dropout_hash.cuh``.

``keep_mask`` is the plain version.  PyTorch has no ``>>`` for uint32 on
the CPU, so it computes in int64, masks to 32 bits after every step, and
splits each 32 x 32-bit product into two that fit in int64.  It runs on
CPU and CUDA tensors alike.
"""
from __future__ import annotations

import torch

M1 = 0x85EBCA6B
M2 = 0xC2B2AE35
P1 = 0x9E3779B1
P2 = 0x85EBCA77
P3 = 0xC2B2AE3D
_MASK = 0xFFFFFFFF


def check_rate(rate: float) -> float:
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return rate


def threshold(rate: float) -> int:
    """The unsigned 32-bit keep threshold of ``rate``."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def keep_scale(rate: float) -> float:
    """The factor a kept element is scaled by: 1 / (1 - rate)."""
    return 1.0 / (1.0 - rate)


def seed_bits(seed: int) -> int:
    """A signed int32 seed as the uint32 the hash adds (wrapping)."""
    return int(seed) & _MASK


def _mul32(h, m: int):
    """(h * m) mod 2**32 for int64 ``h`` in [0, 2**32), without overflow."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def keep_mask(seed: int, bh, q_pos, k_pos, rate: float) -> torch.Tensor:
    """Boolean keep mask of the broadcast of ``bh``, ``q_pos`` and
    ``k_pos`` (int64 tensors or ints of non-negative positions)."""
    h = (seed_bits(seed) + _mul32(torch.as_tensor(bh, dtype=torch.int64), P3)
         ) & _MASK
    h = (h + _mul32(torch.as_tensor(q_pos, dtype=torch.int64), P1)) & _MASK
    h = (h + _mul32(torch.as_tensor(k_pos, dtype=torch.int64), P2)) & _MASK
    h = h ^ (h >> 16)
    h = _mul32(h, M1)
    h = h ^ (h >> 13)
    h = _mul32(h, M2)
    h = h ^ (h >> 16)
    return h >= threshold(rate)
