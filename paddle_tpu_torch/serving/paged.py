"""Paged KV-cache serving: block-pool decode, chunked prefill, prefix reuse
(counterpart of paddle_tpu/serving/paged.py).

K/V lives in a pool of fixed-size blocks (``block_size`` tokens each) on
the device, and a sequence's cache is a block table: the ordered list of
physical block ids holding its tokens.  Device memory follows live tokens;
the host allocator runs between decode iterations.

* **Block-pool decode.** ``PagedDecoder`` has the JAX package's surface
  (``try_join`` / ``join`` / ``evict`` / ``step`` / ``decode`` /
  ``run_until_idle`` / ``active_count``); decode attention runs through the
  paged-attention CUDA kernel (``ops/kernels/paged_attention.py``), which
  walks each row's table and stops at its context length.  Freeing a
  sequence is a host-side refcount decrement: masked lengths make stale
  block contents unreachable.
* **Chunked prefill.** A prompt is written ``prefill_chunk`` tokens per
  ``step()``, round-robin across prefilling sequences and interleaved with
  the decode batch.  A chunk is C query rows sharing one table with lengths
  ``start+1 ... start+C``: K/V is written first, then attended, so causal
  attention inside the chunk falls out of the length mask.
* **Cross-tenant prefix cache.** Every full prompt block gets a chain hash
  (model fingerprint, storage dtype, the previous block's hash, the block's
  tokens); a joining prompt whose leading blocks hit resolves them to the
  same physical blocks with a refcount bump and skips their prefill.  K/V
  depends only on (token, position), which the chain pins, so a shared
  block holds exactly what the sequence would have written.  Shared blocks
  are full and never written again.  Decoders on one ``PagedKVCache`` share
  the pool; the fingerprint namespaces the hashes.  Fingerprints and chain
  hashes are the JAX package's strings, so the two packages agree on them.

int8 KV blocks (``kv_dtype="int8"``) are stored quantised (round half to
even, clip to +-127) with per-block fp32 (k, v) scales, calibrated exactly
as the amax over the model's whole vocab x position grid; the kernel
dequantises next to the dot.

Differences from the JAX package, on purpose:

* The step functions are plain functions on tensors, run eagerly: there is
  no trace counter and no buffer donation.  The pools are updated in place
  (``index_put_``).
* The per-step host buffers (``_meta_np``, ``_pf_meta_np``, the table
  rows) are copied into one fresh device tensor each step before anything
  can rewrite them, so a step never reads a host buffer the host is
  already refilling (the JAX package hands them to an async call).

``dense_reference_decode`` is the parity oracle: a straight-line dense
greedy decode of one sequence.
"""
from __future__ import annotations

import hashlib
import math
import time
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core import flags as _flags
from ..core.device import resolve_device
from ..ops.kernels import paged_attention as _pa
from ..utils import monitor as _monitor
from .continuous import DecodeHandle
from .slo import LOAD_SHED, REQUEST_MS, TTFT_MS, AdmissionError

__all__ = [
    "BlockPool", "PrefixCache", "PagedToyLM", "PagedKVCache", "PagedDecoder",
    "make_paged_toy_lm", "dense_reference_decode", "kv_pool_bytes",
]

KV_BLOCKS_FREE = _monitor.gauge(
    "serve.kv_blocks_free", "Free blocks in the paged KV pool (null block "
    "and refcounted live/cached blocks excluded).")
KV_CACHE_BYTES = _monitor.gauge(
    "serve.kv_cache_bytes", "Device bytes held by the paged KV cache (K + V "
    "blocks at their storage dtype + per-block scales).")
KV_PREFIX_HITS = _monitor.counter(
    "serve.kv_prefix_hits", "Prompt blocks resolved from the cross-tenant "
    "prefix cache instead of prefilled (one count per reused block).")
KV_PREFILL_CHUNKS = _monitor.counter(
    "serve.kv_prefill_chunks", "Chunked-prefill steps executed (one count "
    "per prompt chunk written into the block pool).")

_FREE, _PREFILL, _DECODE = 0, 1, 2

# Physical block 0 is the null block: never allocated, the padding target
# of inactive table entries and masked scatter rows.
_NULL_BLOCK = 0

# Bytes of the (vocab, positions, hidden) activations one calibration
# chunk materialises.
_CALIBRATION_CHUNK_BYTES = 1 << 28


def kv_pool_bytes(num_blocks: int, block_size: int, hidden: int,
                  kv_dtype: str = "float32") -> int:
    """Device bytes for a pool config (K + V + scales, null block
    included), the number ``PagedKVCache`` allocates."""
    itemsize = getattr(torch, kv_dtype).itemsize
    total = num_blocks + 1
    return 2 * total * block_size * hidden * itemsize + total * 2 * 4


class BlockPool:
    """Host-side refcounted allocator over physical block ids.

    ``alloc`` hands out an id at refcount 1; ``share`` bumps it (a prefix
    hit or a cache insert); ``free`` drops it and returns the block to the
    freelist at zero.  Over-free raises."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = int(num_blocks)           # allocatable blocks
        total = self.num_blocks + 1                 # + null block
        self._rc = [0] * total
        self._rc[_NULL_BLOCK] = 1                   # pinned forever
        self._free = list(range(total - 1, _NULL_BLOCK, -1))  # pop() -> 1,2,…

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def live_count(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        bid = self._free.pop()
        assert self._rc[bid] == 0
        self._rc[bid] = 1
        return bid

    def share(self, bid: int) -> int:
        if self._rc[bid] <= 0:
            raise RuntimeError(f"share of unallocated block {bid}")
        self._rc[bid] += 1
        return bid

    def free(self, bid: int) -> None:
        if bid == _NULL_BLOCK:
            raise RuntimeError("free of the null block")
        if self._rc[bid] <= 0:
            raise RuntimeError(f"double free of block {bid}")
        self._rc[bid] -= 1
        if self._rc[bid] == 0:
            self._free.append(bid)

    def refcount(self, bid: int) -> int:
        return self._rc[bid]


class PrefixCache:
    """LRU map of chain content hash -> physical block id.  The cache owns
    one reference per entry, so cached blocks survive their writer; a hit
    is a ``share`` (the joiner gets its own reference).  ``reclaim`` drops
    LRU entries under pool pressure."""

    def __init__(self, pool: BlockPool):
        self._pool = pool
        self._map: "OrderedDict[str, int]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._map)

    def get(self, h: str) -> Optional[int]:
        bid = self._map.get(h)
        if bid is None:
            return None
        self._map.move_to_end(h)
        KV_PREFIX_HITS.inc()
        return self._pool.share(bid)

    def put(self, h: str, bid: int) -> None:
        if h in self._map:
            return
        self._pool.share(bid)                       # the cache's reference
        self._map[h] = bid

    def reclaim(self, need: int) -> int:
        """Drop LRU entries until ``need`` blocks actually returned to the
        freelist (or the cache is empty); returns how many were freed."""
        freed = 0
        while self._map and freed < need:
            _, bid = self._map.popitem(last=False)
            was_free = self._pool.free_count
            self._pool.free(bid)
            freed += self._pool.free_count - was_free
        return freed


class PagedToyLM(nn.Module):
    """Deterministic single-attention-layer greedy LM for the paged path.

    K/V for a token depend only on (token, absolute position), which makes
    chunk writes order-free and prefix blocks reusable.  Weights (``emb``,
    ``pe``, ``wq``, ``wk``, ``wv``, ``wo``; N(0, 0.1^2)) come from
    ``generator`` (a CPU generator seeded with ``seed`` by default; the JAX
    package's ``jax.random`` stream cannot be reproduced, so
    ``convert.paged_toy_lm_from_jax`` carries its weights over).
    ``fingerprint`` is the JAX package's string for the same arguments."""

    def __init__(self, vocab: int, hidden: int, max_positions: int,
                 seed: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vocab, self.hidden = int(vocab), int(hidden)
        self.max_positions = int(max_positions)
        dev = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(int(seed))

        def weight(*shape):
            w = torch.randn(shape, generator=gen, device=gen.device) * 0.1
            return nn.Parameter(w.to(dev), requires_grad=False)

        self.emb = weight(vocab, hidden)
        self.pe = weight(max_positions, hidden)
        self.wq = weight(hidden, hidden)
        self.wk = weight(hidden, hidden)
        self.wv = weight(hidden, hidden)
        self.wo = weight(hidden, vocab)
        self.fingerprint = hashlib.sha256(
            f"paged_toy_lm:v1:{vocab}:{hidden}:{max_positions}:{seed}"
            .encode()).hexdigest()[:16]

    @property
    def device(self) -> torch.device:
        return self.emb.device

    def qkv(self, tokens, positions):
        """(q, k, v) fp32 rows for integer tokens at absolute positions."""
        x = self.emb[tokens.long()] + self.pe[positions.long()]
        return x @ self.wq, x @ self.wk, x @ self.wv

    def calibrate_kv_scales(self) -> Tuple[float, float]:
        """Exact calibration: amax of K and V over the full vocab x position
        grid, symmetric int8.  The grid is walked in chunks of positions
        (the whole grid is vocab x max_positions x hidden values); max is
        exact, so the scales do not depend on the chunking."""
        per = max(1, _CALIBRATION_CHUNK_BYTES // (self.vocab * self.hidden * 4))
        amax_k = amax_v = torch.zeros((), device=self.device)
        with torch.no_grad():
            emb = self.emb[:, None, :]
            for p0 in range(0, self.max_positions, per):
                x = emb + self.pe[p0:p0 + per][None, :, :]
                amax_k = torch.maximum(amax_k, (x @ self.wk).abs().amax())
                amax_v = torch.maximum(amax_v, (x @ self.wv).abs().amax())
        return (max(float(amax_k), 1e-8) / 127.0,
                max(float(amax_v), 1e-8) / 127.0)


def make_paged_toy_lm(vocab: int = 64, hidden: int = 32,
                      max_positions: int = 512, seed: int = 0, device=None,
                      generator: Optional[torch.Generator] = None
                      ) -> PagedToyLM:
    return PagedToyLM(vocab, hidden, max_positions, seed, device=device,
                      generator=generator)


class PagedKVCache:
    """The shared device-side store: K/V block pools ``(num_blocks + 1,
    block_size, hidden)`` of float32 or int8 on the model's device,
    ``(num_blocks + 1, 2)`` fp32 scales, the host allocator and the prefix
    cache.  Several ``PagedDecoder``s (tenants serving the same model) may
    attach to one cache; that is what makes the prefix cache
    cross-tenant."""

    def __init__(self, model: PagedToyLM, num_blocks: int, block_size: int,
                 kv_dtype: str = "float32"):
        if kv_dtype not in ("float32", "int8"):
            raise ValueError(f"kv_dtype must be float32|int8, got {kv_dtype}")
        self.model = model
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.kv_dtype = kv_dtype
        total = self.num_blocks + 1
        dev = model.device
        dt = getattr(torch, kv_dtype)
        self.k = torch.zeros((total, self.block_size, model.hidden), dtype=dt,
                             device=dev)
        self.v = torch.zeros_like(self.k)
        if kv_dtype == "int8":
            ks, vs = model.calibrate_kv_scales()
            self.k_scale, self.v_scale = ks, vs
            self.scales = torch.tensor([[ks, vs]], dtype=torch.float32,
                                       device=dev).repeat(total, 1)
        else:
            self.k_scale = self.v_scale = 1.0
            self.scales = torch.ones((total, 2), dtype=torch.float32,
                                     device=dev)
        self.pool = BlockPool(self.num_blocks)
        self.prefix = PrefixCache(self.pool)
        self.bytes = kv_pool_bytes(self.num_blocks, self.block_size,
                                   model.hidden, kv_dtype)
        KV_CACHE_BYTES.set(float(self.bytes))
        self.sync_metrics()

    def sync_metrics(self) -> None:
        KV_BLOCKS_FREE.set(float(self.pool.free_count))

    def block_hashes(self, tokens: Sequence[int]) -> List[str]:
        """Chain hashes for every full block of ``tokens``: block i's hash
        commits to the model, the storage dtype, every earlier block, and
        its own tokens."""
        out, prev = [], f"{self.model.fingerprint}:{self.kv_dtype}"
        bs = self.block_size
        for i in range(len(tokens) // bs):
            blk = ",".join(str(int(t)) for t in tokens[i * bs:(i + 1) * bs])
            prev = hashlib.sha256(f"{prev}|{blk}".encode()).hexdigest()
            out.append(prev)
        return out


class _Seq:
    __slots__ = ("handle", "block_ids", "context_len", "hashes",
                 "shared_blocks", "cached_upto")

    def __init__(self, handle: DecodeHandle, block_ids: List[int],
                 context_len: int, hashes: List[str], shared_blocks: int):
        self.handle = handle
        self.block_ids = block_ids       # owned references, table order
        self.context_len = context_len   # K/V tokens stored so far
        self.hashes = hashes             # full-prompt-block chain hashes
        self.shared_blocks = shared_blocks
        self.cached_upto = shared_blocks  # blocks already in PrefixCache


class PagedDecoder:
    """Iteration-level decoder over a paged KV pool.

    ``max_seqs`` bounds the decode batch width; ``max_blocks_per_seq``
    bounds one sequence's table.  Each ``step()`` runs at most one prefill
    chunk (``prefill_chunk`` query rows) and one decode step (``max_seqs``
    rows), each one launch of the paged-attention kernel."""

    def __init__(self, model: PagedToyLM, cache: PagedKVCache,
                 max_seqs: int, max_blocks_per_seq: int,
                 prefill_chunk: int = 8, donate: Optional[bool] = None,
                 tenant: str = "default"):
        del donate  # state donation is a JAX notion: accepted, ignored
        if model is not cache.model:
            raise ValueError("decoder model must be the cache's model")
        if max_seqs < 1:
            raise ValueError(f"max_seqs must be >= 1, got {max_seqs}")
        self.model = model
        self.cache = cache
        self.max_seqs = int(max_seqs)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.prefill_chunk = int(prefill_chunk)
        self.max_len = self.max_blocks_per_seq * cache.block_size
        self.tenant = str(tenant)
        self._sm_scale = 1.0 / math.sqrt(model.hidden)
        # persistent host mirrors, updated incrementally (join/grow/retire)
        self._tables_np = np.full((self.max_seqs, self.max_blocks_per_seq),
                                  _NULL_BLOCK, np.int32)
        # meta packs the five per-row scalars (tokens, positions, lens,
        # bids, offs); lens > 0 marks a live row
        self._meta_np = np.zeros((5, self.max_seqs), np.int32)
        self._pf_meta_np = np.zeros((5, self.prefill_chunk), np.int32)
        self._slots: List[Optional[_Seq]] = [None] * self.max_seqs
        self._state = [_FREE] * self.max_seqs
        self._prefill_rr: List[int] = []   # round-robin queue of slot ids
        self._shed_reason = "slots"        # why the last try_join refused

    # -- the step functions ---------------------------------------------------
    def _stage(self, meta: np.ndarray, tables: np.ndarray):
        """One fresh device copy of ``meta`` (5, rows) and ``tables``
        (rows', width): the host may rewrite its buffers as soon as this
        returns."""
        rows = meta.shape[1]
        buf = np.concatenate([meta.ravel(), tables.ravel()])
        dev = torch.from_numpy(buf).to(self.model.device)
        return dev[:5 * rows].view(5, rows), dev[5 * rows:].view(
            tables.shape)

    def _store(self, vals, scale):
        if self.cache.kv_dtype != "int8":
            return vals
        return torch.round(vals / scale).clamp_(-127, 127).to(torch.int8)

    def _forward(self, meta, tables):
        """Write the rows' K/V into the pools, attend through the tables,
        and return each row's greedy next token (a device tensor)."""
        cache, model = self.cache, self.model
        tokens, positions, lens, bids, offs = meta
        bids, offs = bids.long(), offs.long()
        active = (lens > 0)[:, None]
        q, k_new, v_new = model.qkv(tokens, positions)
        # masked scatter: inactive rows target the null block and rewrite
        # its existing value
        for pool, new, scale in ((cache.k, k_new, cache.k_scale),
                                 (cache.v, v_new, cache.v_scale)):
            cur = pool[bids, offs]
            pool.index_put_((bids, offs),
                            torch.where(active, self._store(new, scale), cur))
        attend = (_pa.paged_attention
                  if _flags.get_flag("use_paged_attention")
                  else _pa.paged_attention_plain)
        attn = attend(q, cache.k, cache.v, tables, lens,
                      sm_scale=self._sm_scale, kv_scales=cache.scales)
        return torch.argmax(attn @ model.wo, dim=-1)

    def _decode_step(self, width: int) -> np.ndarray:
        meta, tables = self._stage(self._meta_np,
                                   self._tables_np[:, :width])
        with torch.no_grad():
            nxt = self._forward(meta, tables)
            nxt = torch.where(meta[2] > 0, nxt, 0)
        return nxt.cpu().numpy()

    def _prefill_step(self, slot: int, width: int) -> np.ndarray:
        meta, table = self._stage(self._pf_meta_np,
                                  self._tables_np[slot:slot + 1, :width])
        # the chunk's rows share the slot's table (row stride 0)
        tables = table.expand(self.prefill_chunk, width)
        with torch.no_grad():
            nxt = self._forward(meta, tables)
        return nxt.cpu().numpy()

    # -- admission -----------------------------------------------------------
    @property
    def active_count(self) -> int:
        return sum(1 for s in self._state if s != _FREE)

    def _release(self, bids: List[int]) -> None:
        for bid in bids:
            self.cache.pool.free(bid)

    def try_join(self, prompt: Sequence[int],
                 max_new_tokens: int) -> Optional[DecodeHandle]:
        """Claim a slot and the prompt's blocks; None when slots or blocks
        are unavailable (callers distinguish via ``join``)."""
        h = DecodeHandle(prompt, max_new_tokens)
        if not h.prompt:
            raise ValueError("empty prompt")
        if len(h.prompt) + h.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(h.prompt)}) + max_new_tokens "
                f"({h.max_new_tokens}) exceeds max_blocks_per_seq * "
                f"block_size ({self.max_len})")
        if (len(h.prompt) + h.max_new_tokens
                > self.model.max_positions):
            raise ValueError("request exceeds the model's max_positions")
        slot = next((i for i in range(self.max_seqs)
                     if self._state[i] == _FREE), None)
        if slot is None:
            self._shed_reason = "slots"
            return None

        cache, bs = self.cache, self.cache.block_size
        plen = len(h.prompt)
        hashes = cache.block_hashes(h.prompt)
        # Shareable prefix: full blocks strictly before the last prompt
        # token, so at least one token prefills and yields the first
        # generated token's logits.
        limit = min(len(hashes), (plen - 1) // bs)
        block_ids: List[int] = []
        for i in range(limit):
            bid = cache.prefix.get(hashes[i])
            if bid is None:
                break
            block_ids.append(bid)
        shared = len(block_ids)
        need = _ceil_div(plen, bs) - shared
        for _ in range(need):
            bid = cache.pool.alloc()
            if bid is None and cache.prefix.reclaim(1):
                bid = cache.pool.alloc()
            if bid is None:
                self._release(block_ids)
                self._shed_reason = "kv_blocks"
                cache.sync_metrics()
                return None
            block_ids.append(bid)

        self._state[slot] = _PREFILL
        self._slots[slot] = _Seq(h, block_ids, shared * bs, hashes, shared)
        self._prefill_rr.append(slot)
        h.slot = slot
        row = self._tables_np[slot]
        row[:] = _NULL_BLOCK
        row[:len(block_ids)] = block_ids
        cache.sync_metrics()
        return h

    def join(self, prompt: Sequence[int],
             max_new_tokens: int) -> DecodeHandle:
        self._shed_reason = "slots"
        h = self.try_join(prompt, max_new_tokens)
        if h is None:
            reason = self._shed_reason
            LOAD_SHED.inc(reason=reason)
            raise AdmissionError(
                f"paged decode pool full ({reason}): "
                f"{self.max_seqs} seqs, "
                f"{self.cache.pool.free_count} free blocks")
        return h

    def evict(self, handle: DecodeHandle) -> None:
        """Retire a sequence mid-decode; generated tokens stay on the
        handle, its block references are dropped."""
        if handle.done or handle.slot is None:
            return
        slot = handle.slot
        seq = self._slots[slot]
        if seq is None or seq.handle is not handle:
            return
        handle.evicted = True
        self._retire(slot)

    def _retire(self, slot: int) -> None:
        seq = self._slots[slot]
        self._state[slot] = _FREE
        self._slots[slot] = None
        if slot in self._prefill_rr:
            self._prefill_rr.remove(slot)
        self._tables_np[slot, :] = _NULL_BLOCK
        if seq is not None:
            self._release(seq.block_ids)
            h = seq.handle
            h.done = True
            h.slot = None
            REQUEST_MS.observe((time.perf_counter() - h._t_submit) * 1e3,
                               tenant=self.tenant, bucket="decode")
        self.cache.sync_metrics()

    # -- block bookkeeping ---------------------------------------------------
    def _grow(self, seq: _Seq) -> bool:
        """Ensure a block exists for position ``seq.context_len``; False
        when the pool (and the reclaimable prefix cache) is dry."""
        idx = seq.context_len // self.cache.block_size
        if idx < len(seq.block_ids):
            return True
        bid = self.cache.pool.alloc()
        if bid is None and self.cache.prefix.reclaim(1):
            bid = self.cache.pool.alloc()
        if bid is None:
            return False
        seq.block_ids.append(bid)
        self._tables_np[seq.handle.slot, idx] = bid
        self.cache.sync_metrics()
        return True

    def _publish_full_blocks(self, seq: _Seq) -> None:
        """Insert freshly completed full prompt blocks into the prefix
        cache (shared ones are already there)."""
        plen = len(seq.handle.prompt)
        full = min(seq.context_len, plen) // self.cache.block_size
        while seq.cached_upto < min(full, len(seq.hashes)):
            i = seq.cached_upto
            self.cache.prefix.put(seq.hashes[i], seq.block_ids[i])
            seq.cached_upto = i + 1

    def _live_width(self, nblocks: int) -> int:
        """Table width fed to a step: the longest live table padded to a
        power of two (capped at the provisioned maximum)."""
        w = 1
        while w < nblocks:
            w *= 2
        return min(w, self.max_blocks_per_seq)

    # -- the lockstep iteration ----------------------------------------------
    def _prefill_one(self) -> int:
        """Advance one prefilling sequence by one chunk (round-robin)."""
        if not self._prefill_rr:
            return 0
        slot = self._prefill_rr.pop(0)
        seq = self._slots[slot]
        h = seq.handle
        bs = self.cache.block_size
        plen = len(h.prompt)
        start = seq.context_len
        n = min(self.prefill_chunk, plen - start)
        meta = self._pf_meta_np
        meta.fill(0)                       # 0 == null block == inactive
        for i in range(n):
            pos = start + i
            seq.context_len = pos          # _grow keys off context_len
            if not self._grow(seq):
                seq.context_len = start
                LOAD_SHED.inc(reason="kv_blocks")
                h.evicted = True
                self._retire(slot)
                return 0
            meta[0, i] = h.prompt[pos]
            meta[1, i] = pos
            meta[2, i] = pos + 1           # lens > 0 marks the row live
            meta[3, i] = seq.block_ids[pos // bs]
            meta[4, i] = pos % bs
        nxt = self._prefill_step(slot, self._live_width(len(seq.block_ids)))
        seq.context_len = start + n
        KV_PREFILL_CHUNKS.inc()
        self._publish_full_blocks(seq)
        if seq.context_len == plen:        # prompt fully written: the last
            h.tokens.append(int(nxt[n - 1]))   # row's logits are token 0
            if not h._ttft_recorded:
                h._ttft_recorded = True
                TTFT_MS.observe((time.perf_counter() - h._t_submit) * 1e3)
            if len(h.tokens) >= h.max_new_tokens:
                self._retire(slot)
            else:
                self._state[slot] = _DECODE
        else:
            self._prefill_rr.append(slot)  # back of the round-robin queue
        return 1

    def step(self) -> int:
        """One prefill chunk (if any prompt is pending) + one decode token
        for every decoding sequence.  Returns prefill chunks + decode rows
        advanced; 0 means idle."""
        advanced = self._prefill_one()

        meta = self._meta_np
        meta.fill(0)                       # 0 == null block == inactive
        bs = self.cache.block_size
        n_active = 0
        nblocks = 1
        for slot in range(self.max_seqs):
            if self._state[slot] != _DECODE:
                continue
            seq = self._slots[slot]
            h = seq.handle
            if not self._grow(seq):
                LOAD_SHED.inc(reason="kv_blocks")
                h.evicted = True
                self._retire(slot)
                continue
            pos = seq.context_len
            meta[0, slot] = h.tokens[-1]
            meta[1, slot] = pos
            meta[2, slot] = pos + 1        # lens > 0 marks the row live
            meta[3, slot] = seq.block_ids[pos // bs]
            meta[4, slot] = pos % bs
            nblocks = max(nblocks, len(seq.block_ids))
            n_active += 1
        if n_active:
            nxt = self._decode_step(self._live_width(nblocks))
            for slot in range(self.max_seqs):
                if meta[2, slot] == 0 or self._state[slot] != _DECODE:
                    continue
                seq = self._slots[slot]
                seq.context_len += 1
                seq.handle.tokens.append(int(nxt[slot]))
                if len(seq.handle.tokens) >= seq.handle.max_new_tokens:
                    self._retire(slot)
        return advanced + n_active

    def run_until_idle(self, max_steps: int = 100000) -> None:
        for _ in range(max_steps):
            if self.step() == 0:
                return
        raise RuntimeError(f"decode did not drain in {max_steps} steps")

    def decode(self, prompts: Sequence[Sequence[int]],
               max_new_tokens: int) -> List[List[int]]:
        """Decode every prompt, joining as capacity frees up, in prompt
        order."""
        handles: List[Optional[DecodeHandle]] = [None] * len(prompts)
        pending = list(range(len(prompts)))
        while pending or self.active_count:
            while pending:
                h = self.try_join(prompts[pending[0]], max_new_tokens)
                if h is None:
                    break
                handles[pending.pop(0)] = h
            if self.step() == 0 and pending:
                raise RuntimeError("pool cannot admit remaining prompts")
        return [h.tokens for h in handles]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def dense_reference_decode(model: PagedToyLM, prompt: Sequence[int],
                           max_new_tokens: int) -> List[int]:
    """Straight-line dense greedy decode of one sequence on the model's
    device: the parity oracle for the paged path (same math, no blocks, no
    batching; the prompt's K/V rows in one call, since only the last
    prompt position's logits are used)."""
    dev = model.device
    toks = [int(t) for t in prompt]
    sm = 1.0 / math.sqrt(model.hidden)
    n = len(toks) + max_new_tokens
    k_rows = torch.empty((n, model.hidden), device=dev)
    v_rows = torch.empty_like(k_rows)
    out: List[int] = []
    with torch.no_grad():
        q, k, v = model.qkv(torch.tensor(toks, device=dev),
                            torch.arange(len(toks), device=dev))
        q = q[-1:]
        k_rows[:len(toks)], v_rows[:len(toks)] = k, v
        pos = len(toks)
        while True:
            p = torch.softmax((q @ k_rows[:pos].T) * sm, dim=-1)
            cur = int(torch.argmax(((p @ v_rows[:pos]) @ model.wo)[0]))
            out.append(cur)
            if len(out) >= max_new_tokens:
                return out
            q, k, v = model.qkv(torch.tensor([cur], device=dev),
                                torch.tensor([pos], device=dev))
            k_rows[pos], v_rows[pos] = k[0], v[0]
            pos += 1
