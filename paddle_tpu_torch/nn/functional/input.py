"""Embedding lookup (counterpart of paddle_tpu/nn/functional/input.py)."""
from __future__ import annotations

import torch.nn.functional as tF


def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of ``weight`` at the ids ``x`` (a gather, ``jnp.take`` in the
    JAX package); where ``x == padding_idx`` the row is zero, and so is its
    gradient.  ``torch.nn.functional.embedding`` rather than indexing: its
    backward sums repeated ids by segments in fp32, where indexing's
    serialises on them (token-type and position ids repeat 32k times a
    batch).  The sparse (deduplicated-rows) gradient is not ported."""
    if sparse:
        raise NotImplementedError(
            "embedding(sparse=True) is not ported to paddle_tpu_torch yet")
    out = tF.embedding(x.long(), weight)
    if padding_idx is not None:
        out = out * (x != padding_idx)[..., None].to(out.dtype)
    return out
