"""Embedding lookup (counterpart of paddle_tpu/nn/functional/input.py)."""
from __future__ import annotations

import torch.nn.functional as tF


def embedding(x, weight):
    """Rows of ``weight`` at the ids ``x`` (a gather, ``jnp.take`` in the
    JAX package).  ``torch.nn.functional.embedding`` rather than indexing:
    its backward sums repeated ids by segments in fp32, where indexing's
    serialises on them (token-type and position ids repeat 32k times a
    batch)."""
    return tF.embedding(x.long(), weight)
