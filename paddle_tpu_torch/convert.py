"""Weights and state from the JAX package into the port (counterpart of
paddle_tpu/autograd ``parameters_dict``; static programs' persistables).

The port's parameter names are the JAX package's qualified names, and
Linear weights keep Paddle's (in, out) layout, so conversion is a checked
copy.  Tied parameters are listed once in both packages (the MLM decoder
appears only as ``ernie.embeddings.word_embeddings.weight``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn


def parameters_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{qualified_name: parameter}, each tied tensor once, as the JAX
    package's ``parameters_dict``."""
    return dict(model.named_parameters())


def from_jax_params(np_params: Dict[str, np.ndarray], model: nn.Module,
                    dtype: Optional[torch.dtype] = None) -> nn.Module:
    """Copy the JAX package's ``parameters_dict(model)`` output (as numpy
    arrays) into ``model`` in place, with strict key and shape checks.
    ``dtype`` casts every floating parameter afterwards (bfloat16 to serve);
    tied parameters stay tied.  Returns ``model``."""
    own = parameters_dict(model)
    missing = sorted(set(own) - set(np_params))
    unexpected = sorted(set(np_params) - set(own))
    if missing or unexpected:
        raise KeyError(f"from_jax_params: missing keys {missing}, "
                       f"unexpected keys {unexpected}")
    with torch.no_grad():
        for name, p in own.items():
            arr = np.asarray(np_params[name])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"from_jax_params: {name} has shape "
                                 f"{arr.shape}, the model expects "
                                 f"{tuple(p.shape)}")
            if arr.dtype.kind == "f" and arr.dtype != np.float64:
                arr = arr.astype(np.float32)
            p.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    if dtype is not None:
        model.to(dtype)
    return model


_PAGED_TOY_LM_KEYS = ("emb", "pe", "wq", "wk", "wv", "wo")


def paged_toy_lm_from_jax(np_weights: Dict[str, np.ndarray], vocab: int,
                          hidden: int, max_positions: int, seed: int,
                          device=None):
    """A port ``PagedToyLM`` holding the JAX ``PagedToyLM``'s weights
    (``{emb, pe, wq, wk, wv, wo}`` as numpy arrays) for the same
    ``vocab / hidden / max_positions / seed``, so its fingerprint, and with
    it every prefix-cache hash, is the JAX model's.  Keys and shapes are
    checked strictly."""
    from .serving.paged import PagedToyLM

    got = set(np_weights)
    if got != set(_PAGED_TOY_LM_KEYS):
        raise KeyError(f"paged_toy_lm_from_jax: missing keys "
                       f"{sorted(set(_PAGED_TOY_LM_KEYS) - got)}, unexpected "
                       f"keys {sorted(got - set(_PAGED_TOY_LM_KEYS))}")
    model = PagedToyLM(vocab, hidden, max_positions, seed, device=device)
    with torch.no_grad():
        for name in _PAGED_TOY_LM_KEYS:
            p = getattr(model, name)
            arr = np.array(np_weights[name], dtype=np.float32)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"paged_toy_lm_from_jax: {name} has shape "
                                 f"{arr.shape}, the model expects "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))
    return model


def static_state_from_jax(jax_program, jax_state: Dict[str, np.ndarray],
                          torch_program, device=None):
    """The port's ``static.Scope`` holding a JAX static program's
    persistables: parameters and BN statistics, and in a training program
    the learning-rate variable, the optimizer slots (moments, beta powers,
    accumulators) and the QAT activation-scale state, so a JAX scope at
    step k continues in the port as in JAX.

    ``jax_state`` is the JAX scope's ``{name: np.ndarray}``.  The two
    packages' ``unique_name`` counters differ, so names are not matched:
    the persistables of ``jax_program`` and ``torch_program`` (the same
    program built with each package) are paired in creation order, and
    each pair's shapes are checked.  ``device`` None means CUDA."""
    from .core.device import resolve_device
    from .static import Scope

    dev = resolve_device(device)
    src = [v for v in jax_program.list_vars() if v.persistable]
    dst = [v for v in torch_program.list_vars() if v.persistable]
    if len(src) != len(dst):
        raise ValueError(f"static_state_from_jax: the JAX program has "
                         f"{len(src)} persistables, the port's {len(dst)}")
    scope = Scope()
    for s, d in zip(src, dst):
        if tuple(s.shape) != tuple(d.shape):
            raise ValueError(f"static_state_from_jax: {s.name} has shape "
                             f"{tuple(s.shape)}, its counterpart {d.name} "
                             f"{tuple(d.shape)}")
        if s.name not in jax_state:
            raise KeyError(f"static_state_from_jax: no value for {s.name}")
        arr = np.asarray(jax_state[s.name])
        if tuple(arr.shape) != tuple(d.shape):
            raise ValueError(f"static_state_from_jax: the value of {s.name} "
                             f"has shape {arr.shape}, {d.name} expects "
                             f"{tuple(d.shape)}")
        scope.set(d.name, torch.from_numpy(np.array(arr)).to(
            device=dev, dtype=d.dtype))
    return scope
