"""Embedding lookup and one-hot (counterpart of paddle_tpu/nn/functional/
input.py; ref operators/lookup_table_v2_op.cc, one_hot_op.cc)."""
from __future__ import annotations

import torch
import torch.nn.functional as tF


def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of ``weight`` at the ids ``x`` (a gather, ``jnp.take`` in the
    JAX package); where ``x == padding_idx`` the row is zero, and so is its
    gradient.  The lookup is ``torch.nn.functional.embedding`` rather
    than indexing: its backward sums repeated ids by segments in
    fp32, where indexing's serialises on them (token-type and position
    ids repeat 32k times a batch).  ``sparse`` is accepted for the
    reference's signature and changes nothing: the gradient is dense
    either way, each row the sum over that id's repeats, as the JAX
    package's ``sparse_lookup`` gives it (the port keeps no SelectedRows
    gradient)."""
    del sparse
    out = tF.embedding(x.long(), weight)
    if padding_idx is not None:
        out = out * (x != padding_idx)[..., None].to(out.dtype)
    return out


def one_hot(x, num_classes):
    """(..., num_classes) float32 (``jax.nn.one_hot``'s default dtype)."""
    return tF.one_hot(x.long(), num_classes).to(torch.float32)
