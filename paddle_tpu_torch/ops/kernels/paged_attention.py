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
v_scale)``, with q in fp32 (the kernel takes the scales out of the dots:
``(q . k8) k_scale`` and ``(p v_scale) . v8``).

Shapes: ``q`` (num_seqs, d) fp32 or bf16; caches (num_blocks, block_size,
d) fp32, bf16 or int8; ``block_tables`` (num_seqs, max_blocks) int32 (rows
may share storage: a row stride of 0 broadcasts one table, as the chunked
prefill does); ``context_lens`` (num_seqs,) int32; ``kv_scales``
(num_blocks, 2) fp32, required for int8 caches.  The output is (num_seqs,
d) in q's dtype.

Design (``paged_plan``, made from shapes alone and cached): the table's
blocks are cut into tiles of at most ``SLOT_BYTES`` of K (whole blocks, or
a part of one) that the kernel brings into shared memory with bulk
asynchronous copies; the tiles are split over ``splits`` CTAs a row group
(split-KV) and a merge kernel combines the partials in a fixed order.  A
row group is one row (own tables: a decode step), or, for rows that share
one table (row stride 0: a prefill chunk), up to 64 rows that read each
tile once, where the cost model finds that route cheaper.  Route and
split count come from that model, fitted on the H100 (``split_cost_us``);
the plan never reads ``context_lens``.  The partials' scratch is
allocated for each call (``_workspace``), so the kernel keeps no state
between calls and a call can be captured in a CUDA graph.

Unlike the JAX dispatch, nothing here quietly takes the plain version for a
shape the kernel refuses: on a CUDA tensor the wrapper launches the kernel
(``d % 32 == 0``, ``d <= 256``, ``1 <= block_size <= 64``) or raises.  On a
CPU tensor it runs ``paged_attention_plain``.
"""
from __future__ import annotations

import collections
import ctypes
import functools
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

# The C entry's limits and tile geometry (csrc/paged_attention.cu).
SLOT_BYTES = 4096        # K (and V) bytes of one tile
MAX_TILE_TOKENS = 64
SHARED_TILE_TOKENS = 8   # a shared-table tile's work is rows x tokens
MAX_TILE_COPIES = 32
ROW_WARPS = 4            # warps of a one-row CTA, which share its tiles
SHARED_WARPS = 4
ROWS_PER_LANE = 4
SHARED_COLS = 16
MAX_SPLITS = 256
WINDOW = 256             # table entries a CTA stages in shared memory
H100_SMS = 132
# CTAs an SM holds (the one-row kernel's 96 KB ring, the shared-table
# kernel's registers).
RESIDENT = 2
# The split cost model, fitted to H100 times of the kernel with the splits
# forced (experiments/paged_experiments.py splits; PERF.md section 6), one
# set for one-row groups and one for shared-table groups.  A call takes
# the larger of its bytes' time (FLOOR_KB_US a KB: 3.35 TB/s) and its CTAs'
# time, plus the merge kernel when it splits.
# Lengths are never read: FILL is the share of a table taken to be live.
# A CTA costs CTA_US plus, for each tile its warps take in turn, KB_US a KB
# of K and V and TOKEN_US a token (one-row groups) or ROW_TOKEN_US a row
# and token (shared-table groups); more than one split adds SPLIT_US and
# PARTIAL_US for each row's live split.
HBM_KB_US = 1024 / 3.35e6
COST = {
    False: dict(CTA_US=5.0, KB_US=0.05, TOKEN_US=0.04, ROW_TOKEN_US=0.0,
                SPLIT_US=5.0, PARTIAL_US=5e-3, FILL=0.65,
                FLOOR_KB_US=HBM_KB_US),
    True: dict(CTA_US=8.0, KB_US=0.05, TOKEN_US=0.0, ROW_TOKEN_US=4e-3,
               SPLIT_US=4.0, PARTIAL_US=1e-3, FILL=0.5,
               FLOOR_KB_US=HBM_KB_US),
}

PagedPlan = collections.namedtuple(
    "PagedPlan", "tile_tokens copy_tokens copies tiles splits "
    "tiles_per_split rows_per_cta row_groups shared_tile")


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


def tile_geometry(d: int, elt: int, block_size: int, width: int,
                  shared: bool = False) -> Tuple[int, int, int, int]:
    """(tile tokens, tokens a bulk copy, copies a tile, tiles of a table of
    ``width`` blocks), as the C entry computes them: whole blocks while
    one fits a slot and the token cap (MAX_TILE_TOKENS, SHARED_TILE_TOKENS
    for the shared-table route), else the largest divisor of block_size
    that does."""
    row = d * elt
    most = SHARED_TILE_TOKENS if shared else MAX_TILE_TOKENS
    if block_size * row <= SLOT_BYTES and block_size <= most:
        nb = min(SLOT_BYTES // (block_size * row), most // block_size,
                 MAX_TILE_COPIES)
        return nb * block_size, block_size, nb, -(-width // nb)
    tt = max(c for c in range(1, min(block_size, most) + 1)
             if block_size % c == 0 and c * row <= SLOT_BYTES)
    return tt, tt, 1, width * (block_size // tt)


def shared_rows(d: int) -> int:
    """Rows of a shared-table CTA: its lanes hold ROWS_PER_LANE rows of
    SHARED_COLS columns, a row over the next power of two >= d / 16
    lanes."""
    g = 1
    while g < d // SHARED_COLS:
        g *= 2
    return SHARED_WARPS * (32 // g) * ROWS_PER_LANE


def split_cost_us(rows: int, rows_per_cta: int, tiles: int, tile_tokens: int,
                  tile_kb: float, splits: int, shared: bool,
                  sms: int = H100_SMS) -> float:
    """The modelled time (us) of a call with ``splits`` KV splits over
    ``tiles`` tiles of ``tile_tokens`` tokens and ``tile_kb`` KB of K and
    V."""
    c = COST[shared]
    groups = -(-rows // rows_per_cta)
    tps = -(-tiles // splits)
    live = max(1, round(splits * c["FILL"]))
    tile = (c["KB_US"] * tile_kb + c["TOKEN_US"] * tile_tokens
            + c["ROW_TOKEN_US"] * min(rows_per_cta, rows) * tile_tokens)
    if not shared:
        tile /= ROW_WARPS
    # bytes at the card's rate, or at the share of it that fewer CTAs than
    # SMs can draw
    floor = ((1 if shared else rows) * tiles * tile_kb * c["FILL"]
             * c["FLOOR_KB_US"] / min(1.0, groups * live / sms))
    waves = -(-groups * live // (sms * RESIDENT))
    merge = (c["SPLIT_US"] + c["PARTIAL_US"] * rows * live
             if splits > 1 else 0.0)
    return max(floor, waves * (c["CTA_US"] + tps * tile)) + merge


def route_plan(num_seqs: int, max_blocks: int, block_size: int, d: int,
               kv_elt: int, shared_tile: bool,
               sms: int = H100_SMS) -> Tuple[float, PagedPlan]:
    """(modelled us, plan) of one route (``shared_tile``: the shared-table
    CTA group, row groups of ``shared_rows(d)``; else one row a group) at
    its cheapest split count under ``split_cost_us``, each split non-empty
    at the full width."""
    tt, ct, copies, tiles = tile_geometry(d, kv_elt, block_size, max_blocks,
                                          shared_tile)
    rows_per_cta = shared_rows(d) if shared_tile else 1
    groups = -(-num_seqs // rows_per_cta)
    most = max(1, min(MAX_SPLITS, tiles))
    # a split's blocks fit the CTA's staged window where they can
    least = min(most, -(-tiles * tt // (WINDOW * block_size)))
    candidates = {-(-tiles // -(-tiles // s)) if tiles else 1
                  for s in range(max(1, least), most + 1)}
    tile_kb = 2 * tt * d * kv_elt / 1024
    cost, splits = min((split_cost_us(num_seqs, rows_per_cta, tiles, tt,
                                      tile_kb, s, shared_tile, sms), s)
                       for s in candidates)
    tps = -(-tiles // splits) if tiles else 1
    return cost, PagedPlan(tt, ct, copies, tiles, splits, tps, rows_per_cta,
                           groups, shared_tile)


@functools.lru_cache(maxsize=1024)
def paged_plan(num_seqs: int, max_blocks: int, block_size: int, d: int,
               kv_elt: int, shared: bool, sms: int = H100_SMS) -> PagedPlan:
    """Route, tiles and KV splits of one call, from shapes alone
    (``shared``: the table's row stride is 0).

    Rows with their own tables take one row a group; rows sharing one
    table take the route of the two (``route_plan``) that the cost model
    finds cheaper: the shared-table CTA group reads each tile once for up
    to 64 rows, the one-row kernel reads it once a row from L2 but with
    fewer, wider CTAs, which wins on narrow tables and on the cache types
    whose products cost the shared-table lanes most.  A 64-row decode step
    over a wide table fills the card (fewer CTAs than SMs draw only their
    share of the bytes' rate); short tables take one split and no merge."""
    args = (num_seqs, max_blocks, block_size, d, kv_elt)
    plans = [route_plan(*args, False, sms)]
    if shared:
        plans.append(route_plan(*args, True, sms))
    return min(plans, key=lambda cp: cp[0])[1]


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
    """C entry: q, k, v, tables, lens, scales, out, ws (pointers), num_seqs,
    d, block_size, max_blocks (int), table row stride (int64), sm_scale, q
    and kv dtype codes, splits, the shared-table route (int), the
    stream."""
    fn = build.load(SOURCE).paged_attention
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([P] * 8 + [I, I, I, I, ctypes.c_int64,
                                  ctypes.c_float, I, I, I, I, P])
        fn.restype = I
    return fn


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _workspace(plan: PagedPlan, num_seqs: int, d: int, device):
    """The partials' fp32 scratch of one call, (num_seqs, splits, d) acc
    then (num_seqs, splits, 2) (m, l), or None for one split.  A new tensor
    each call, ordered on the current stream by the caching allocator (in
    a graph's private pool under capture): no buffer outlives the call."""
    if plan.splits == 1:
        return None
    return torch.empty(num_seqs * plan.splits * (d + 2), dtype=torch.float32,
                       device=device)


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
    width = block_tables.shape[1]
    stride = block_tables.stride(0)
    plan = paged_plan(num_seqs, width, k_cache.shape[1], d,
                      k_cache.element_size(), stride == 0,
                      _sms(q.device.index))
    ws = _workspace(plan, num_seqs, d, q.device)
    err = _entry()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(),
        kv_scales.data_ptr() if quantized else None, out.data_ptr(),
        None if ws is None else ws.data_ptr(), num_seqs, d, k_cache.shape[1],
        width, stride, float(sm_scale), _Q_CODES[q.dtype],
        _KV_CODES[k_cache.dtype], plan.splits, int(plan.shared_tile),
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
