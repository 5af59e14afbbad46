"""Paged attention: one-token decode attention over a block-pooled KV cache.

Counterpart of paddle_tpu/ops/pallas/paged_attention.py.  For each query
row ``s``::

    out[s] = softmax(q[s] . K[s]^T * sm_scale) . V[s]

where ``K[s]`` / ``V[s]`` are gathered block by block through
``block_tables[s, :]`` and masked to positions ``< context_lens[s]``.  One
kernel source, ``csrc/paged_attention.cu`` (replaces
``paged_attention_kernel``).

Numerics follow the TPU kernel: scores, the running max, the sum and the
accumulator are fp32; masked positions add exactly 0; the result is
``acc / max(l, 1e-30)``, so a row with ``context_len == 0`` returns exact
zeros; with bf16 caches P is rounded to bf16 before P.V while the sum takes
the unrounded P; int8 blocks are dequantised with their own ``(k_scale,
v_scale)`` next to the dot, with q in fp32.

Shapes: ``q`` (num_seqs, d) fp32 or bf16; caches (num_blocks, block_size,
d) fp32, bf16 or int8; ``block_tables`` (num_seqs, max_blocks) int32 (rows
may share storage: a row stride of 0 broadcasts one table, as the chunked
prefill does); ``context_lens`` (num_seqs,) int32; ``kv_scales``
(num_blocks, 2) fp32, required for int8 caches.  The output is (num_seqs,
d) in q's dtype.

Unlike the JAX dispatch, nothing here quietly takes the plain version for a
shape the kernel refuses: on a CUDA tensor the wrapper launches the kernel
(``d % 32 == 0``, ``d <= 256``, ``1 <= block_size <= 64``) or raises.  On a
CPU tensor it runs ``paged_attention_plain``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import build, config

SOURCE = "paged_attention"
KERNEL = "paged_attention"
REPLACES = "paddle_tpu/ops/pallas/paged_attention.py:116 paged_attention_kernel"
MAX_DIM = 256
MAX_BLOCK_SIZE = 64
NEG_INF = -1e30
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _dequant(blocks, scales, which):
    """fp32 (..., block_size, d) int8 blocks times their per-block scale."""
    return blocks.float() * scales[..., which][..., None, None]


def paged_attention_plain(q, k_cache, v_cache, block_tables, context_lens,
                          sm_scale=None, kv_scales=None):
    """The kernel's arithmetic in plain PyTorch: one gather through the
    table, a masked fp32 softmax, P rounded to bf16 before P.V for bf16
    caches, and the sum of P divided out last."""
    num_seqs, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    block_size = k_cache.shape[1]
    tables = block_tables.long()
    k = k_cache[tables]                      # (S, max_blocks, bs, d)
    v = v_cache[tables]
    if k_cache.dtype == torch.int8:
        s_kv = kv_scales[tables]             # (S, max_blocks, 2)
        k, v = _dequant(k, s_kv, 0), _dequant(v, s_kv, 1)
    span = tables.shape[1] * block_size
    k = k.reshape(num_seqs, span, d).float()
    v = v.reshape(num_seqs, span, d)
    scores = torch.einsum("sd,smd->sm", q.float(), k) * sm_scale
    pos = torch.arange(span, device=q.device)[None, :]
    valid = pos < context_lens.long()[:, None]
    scores = scores.masked_fill(~valid, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if v.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
    acc = torch.einsum("sm,smd->sd", p, v.float())
    return (acc / l).to(q.dtype)


def _check(q, k_cache, v_cache, block_tables, context_lens, kv_scales):
    if q.dim() != 2 or k_cache.dim() != 3:
        raise ValueError(f"{KERNEL}: expected q (num_seqs, d) and caches "
                         f"(num_blocks, block_size, d), got {tuple(q.shape)} "
                         f"and {tuple(k_cache.shape)}")
    num_seqs, d = q.shape
    num_blocks, block_size, dk = k_cache.shape
    if v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"{KERNEL}: k and v caches must match in shape and "
                         f"dtype")
    if dk != d:
        raise ValueError(f"{KERNEL}: q has d={d}, the caches {dk}")
    if block_tables.dim() != 2 or block_tables.shape[0] != num_seqs:
        raise ValueError(f"{KERNEL}: block_tables must be (num_seqs, "
                         f"max_blocks), got {tuple(block_tables.shape)}")
    if context_lens.shape != (num_seqs,):
        raise ValueError(f"{KERNEL}: context_lens must be ({num_seqs},)")
    if k_cache.dtype == torch.int8 and (
            kv_scales is None or kv_scales.shape != (num_blocks, 2)
            or kv_scales.dtype != torch.float32):
        raise ValueError(f"{KERNEL}: int8 caches need float32 kv_scales of "
                         f"shape ({num_blocks}, 2)")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {q.device}")
    if q.dtype not in _Q_CODES or k_cache.dtype not in _KV_CODES:
        raise ValueError(f"{KERNEL}: q must be float32 or bfloat16 and the "
                         f"caches float32, bfloat16 or int8, got {q.dtype} "
                         f"and {k_cache.dtype}")
    if d % 32 or d > MAX_DIM:
        raise ValueError(f"{KERNEL}: d must be a multiple of 32 and at most "
                         f"{MAX_DIM}, got {d}")
    if not 1 <= block_size <= MAX_BLOCK_SIZE:
        raise ValueError(f"{KERNEL}: block_size must be 1..{MAX_BLOCK_SIZE}, "
                         f"got {block_size}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise ValueError(f"{KERNEL}: block_tables and context_lens must be "
                         f"int32")
    if block_tables.stride(1) != 1:
        raise ValueError(f"{KERNEL}: block_tables rows must be contiguous")
    tensors = [q, k_cache, v_cache, block_tables, context_lens]
    if k_cache.dtype == torch.int8:
        tensors.append(kv_scales)
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"{KERNEL}: all tensors must be on {q.device}")
    for t in tensors[:3] + tensors[4:]:
        if not t.is_contiguous():
            raise ValueError(f"{KERNEL}: q, caches, lengths and scales must "
                             f"be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError(f"{KERNEL}: caches must be 16-byte aligned")


def _entry():
    """C entry: q, k, v, tables, lens, scales, out (pointers), num_seqs, d,
    block_size, max_blocks (int), table row stride (int64), sm_scale, q and
    kv dtype codes, the stream."""
    fn = build.load(SOURCE).paged_attention
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([P] * 7 + [I, I, I, I, ctypes.c_int64,
                                  ctypes.c_float, I, I, P])
        fn.restype = I
    return fn


def paged_attention(q, k_cache, v_cache, block_tables, context_lens,
                    sm_scale: Optional[float] = None,
                    kv_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
    _check(q, k_cache, v_cache, block_tables, context_lens, kv_scales)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_cache, v_cache, block_tables,
                                     context_lens, sm_scale, kv_scales)
    num_seqs, d = q.shape
    out = torch.empty_like(q)
    if num_seqs == 0:
        return out
    quantized = k_cache.dtype == torch.int8
    err = _entry()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(),
        kv_scales.data_ptr() if quantized else None, out.data_ptr(),
        num_seqs, d, k_cache.shape[1], block_tables.shape[1],
        block_tables.stride(0), float(sm_scale), _Q_CODES[q.dtype],
        _KV_CODES[k_cache.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    config.record_call(KERNEL)
    return out


def supported(num_seqs: int, block_size: int, head_dim: int, dtype) -> bool:
    """Shapes and cache types (torch dtypes) the CUDA kernel takes."""
    return (head_dim % 32 == 0 and head_dim <= MAX_DIM
            and 1 <= block_size <= MAX_BLOCK_SIZE and dtype in _KV_CODES)


def paged_attention_cost(num_seqs: int, max_blocks: int, block_size: int,
                         head_dim: int,
                         kv_bytes_per_elem: int = 4) -> Tuple[float, float]:
    """(flops, device bytes) of one call if every row used its full table,
    the JAX package's cost model."""
    span = num_seqs * max_blocks * block_size
    flops = span * (4.0 * head_dim + 5.0)
    bytes_ = (2.0 * span * head_dim * kv_bytes_per_elem
              + 2.0 * num_seqs * head_dim * 4
              + num_seqs * max_blocks * 4 + num_seqs * 4)
    return flops, float(bytes_)


KERNELS = (
    config.Kernel(KERNEL, SOURCE, REPLACES, paged_attention,
                  paged_attention_plain),
)
