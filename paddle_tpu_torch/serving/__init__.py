"""Serving (counterpart of paddle_tpu.serving).

Ported so far: :mod:`~paddle_tpu_torch.serving.paged`, paged KV-cache
decode (refcounted block pool, block tables, chunked prefill interleaved
with decode, cross-tenant prefix cache, int8 KV blocks) with its attention
in a hand-written CUDA kernel; the ``DecodeHandle`` it hands out
(:mod:`~paddle_tpu_torch.serving.continuous`); the admission errors and
``serve.*`` metrics it records (:mod:`~paddle_tpu_torch.serving.slo`).
The frontend, tenancy, ``ContinuousBatcher`` and ``SLOPolicy`` wait for
later slices.
"""
from .continuous import DecodeHandle
from .paged import (BlockPool, PagedDecoder, PagedKVCache, PrefixCache,
                    dense_reference_decode, kv_pool_bytes,
                    make_paged_toy_lm)
from .slo import AdmissionError, QuotaExceededError

__all__ = [
    "AdmissionError", "BlockPool", "DecodeHandle", "PagedDecoder",
    "PagedKVCache", "PrefixCache", "QuotaExceededError",
    "dense_reference_decode", "kv_pool_bytes", "make_paged_toy_lm",
]
