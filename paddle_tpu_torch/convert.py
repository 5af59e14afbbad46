"""Weights and state from the JAX package into the port (counterpart of
paddle_tpu/autograd ``parameters_dict``; static programs' persistables;
optimizer, LR-scheduler and loss-scaler state mid-run).

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

from .autograd import parameters_dict  # noqa: F401 (re-exported)


def _checked_copy(own, np_values, what):
    missing = sorted(set(own) - set(np_values))
    unexpected = sorted(set(np_values) - set(own))
    if missing or unexpected:
        raise KeyError(f"from_jax_params: missing {what} {missing}, "
                       f"unexpected {what} {unexpected}")
    with torch.no_grad():
        for name, p in own.items():
            arr = np.asarray(np_values[name])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"from_jax_params: {name} has shape "
                                 f"{arr.shape}, the model expects "
                                 f"{tuple(p.shape)}")
            if arr.dtype.kind == "f" and arr.dtype != np.float64:
                arr = arr.astype(np.float32)
            p.copy_(torch.from_numpy(np.array(arr, order="C")))


def from_jax_params(np_params: Dict[str, np.ndarray], model: nn.Module,
                    dtype: Optional[torch.dtype] = None,
                    buffers: Optional[Dict[str, np.ndarray]] = None
                    ) -> nn.Module:
    """Copy the JAX package's ``parameters_dict(model)`` output (as numpy
    arrays) into ``model`` in place, with strict key and shape checks: an
    ERNIE, a ``Transformer``, or a model after ``ImperativeQuantAware``
    (whose wrapped weights are ``<layer>.inner.weight``).  ``buffers``, the
    JAX ``buffers_dict(model)`` (a QAT model's ``in_scale`` EMA scales),
    is copied into the model's buffers the same way.  ``dtype`` casts every
    floating parameter afterwards (bfloat16 to serve); tied parameters stay
    tied.  Returns ``model``."""
    _checked_copy(parameters_dict(model), np_params, "keys")
    if buffers is not None:
        _checked_copy(dict(model.named_buffers()), buffers, "buffers")
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


def _slots_to_torch(slots, like: torch.Tensor):
    """A JAX optimizer slot (an array, a tuple of arrays, a dict of arrays
    (Ftrl's, DGC's), ``()`` or None (Dpsgd's)) as tensors on ``like``'s
    device, each keeping its dtype."""
    if slots is None:
        return None
    if isinstance(slots, dict):
        return {k: _slots_to_torch(v, like) for k, v in slots.items()}
    if isinstance(slots, (tuple, list)):
        return tuple(_slots_to_torch(s, like) for s in slots)
    arr = np.array(slots)
    if arr.dtype.name == "bfloat16":          # ml_dtypes' numpy bfloat16
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=like.device, dtype=torch.bfloat16)
    return torch.from_numpy(arr).to(like.device)


def _slot_leaves(t):
    if t is None:
        return []
    if isinstance(t, dict):
        return [x for v in t.values() for x in _slot_leaves(v)]
    if isinstance(t, tuple):
        return [x for v in t for x in _slot_leaves(v)]
    return [t]


def _named_from_jax(jax_tree, params, what):
    """A JAX pytree over ``params``' names (a dict) as tensors by name,
    each shape-checked against its parameter."""
    if set(jax_tree) != set(params):
        raise KeyError(f"optimizer_state_from_jax: the {what} names differ "
                       f"from the parameters'")
    out = {}
    for name, p in params.items():
        t = _slots_to_torch(jax_tree[name], p)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"optimizer_state_from_jax: the {what} of "
                             f"{name} has shape {tuple(t.shape)}, the "
                             f"parameter {tuple(p.shape)}")
        out[name] = t.to(p.dtype)
    return out


def optimizer_state_from_jax(jax_state, params: Dict[str, torch.Tensor]):
    """The port's optimizer state for ``params`` ({name: tensor}) from a
    JAX ``opt.init`` / ``opt.update`` state over the same names.

    The JAX state's ``per_param`` is a list in ``tree_leaves`` order, which
    for a dict of parameters is sorted key order, and its ``step`` a traced
    int32; the port keys slots by name, so each slot is matched by name
    (never by the port dict's own order), shape-checked, and the step
    becomes an int.  A ``Lookahead`` state (``inner``, ``slow``, ``step``)
    converts its inner state the same way and its slow weights by name; an
    ``ExponentialMovingAverage`` / ``ModelAverage`` ``state_dict()``
    (``shadow``, ``step``) its shadow weights by name."""
    if "shadow" in jax_state:
        return {"shadow": _named_from_jax(jax_state["shadow"], params,
                                          "shadow"),
                "step": int(jax_state["step"])}
    if "slow" in jax_state:
        return {"inner": optimizer_state_from_jax(jax_state["inner"], params),
                "slow": _named_from_jax(jax_state["slow"], params, "slow"),
                "step": int(np.asarray(jax_state["step"]))}
    names = sorted(params)
    per = list(jax_state["per_param"])
    if len(per) != len(names):
        raise ValueError(f"optimizer_state_from_jax: the JAX state has "
                         f"{len(per)} slots, the port {len(names)} "
                         f"parameters")
    out = {}
    for name, slots in zip(names, per):
        t = _slots_to_torch(slots, params[name])
        for s in _slot_leaves(t):
            if tuple(s.shape) != tuple(params[name].shape):
                raise ValueError(f"optimizer_state_from_jax: a slot of "
                                 f"{name} has shape {tuple(s.shape)}, the "
                                 f"parameter {tuple(params[name].shape)}")
        out[name] = t
    return {"per_param": {n: out[n] for n in params},
            "step": int(np.asarray(jax_state["step"]))}


def scheduler_state_from_jax(jax_state: Dict) -> Dict:
    """A JAX ``LRScheduler.state_dict()`` as the port scheduler's
    ``set_state_dict`` argument (plain Python numbers)."""
    return {"last_epoch": int(jax_state["last_epoch"]),
            "last_lr": float(jax_state["last_lr"])}


def grad_scaler_state_from_jax(jax_state: Dict) -> Dict:
    """A JAX ``GradScaler.state_dict()`` as the port scaler's
    ``load_state_dict`` argument."""
    return {"scale": float(jax_state["scale"]),
            "incr_count": int(jax_state["incr_count"]),
            "decr_count": int(jax_state["decr_count"])}


def hybrid_params_from_jax(np_params: Dict[str, Dict[str, np.ndarray]],
                           trainer=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX ``HybridPretrainer``'s ``{"embed", "blocks" (stacked
    [L, ...]), "head"}`` parameters (numpy arrays) as the port's: whole
    fp32 CPU tensors, or with ``trainer`` (a port ``HybridPretrainer``)
    this rank's slices on its device (``trainer.place_params``), after a
    strict key and shape check against the trainer's own layout.  The
    names and layouts are the same in both packages (Linear weights
    (in, out); the tied decoder kept once, under "embed")."""
    whole = {g: {k: torch.from_numpy(np.array(
        np.asarray(v).astype(np.float32) if np.asarray(v).dtype.kind == "f"
        else np.asarray(v), order="C")) for k, v in leaves.items()}
        for g, leaves in np_params.items()}
    if trainer is None:
        return whole
    own = trainer.init_params_shapes()
    for g in sorted(set(own) | set(whole)):
        mine, theirs = own.get(g, {}), whole.get(g, {})
        missing = sorted(set(mine) - set(theirs))
        unexpected = sorted(set(theirs) - set(mine))
        if missing or unexpected:
            raise KeyError(f"hybrid_params_from_jax: {g}: missing "
                           f"{missing}, unexpected {unexpected}")
        for k, t in theirs.items():
            if tuple(t.shape) != tuple(mine[k].shape):
                raise ValueError(f"hybrid_params_from_jax: {g}/{k} has shape "
                                 f"{tuple(t.shape)}, the trainer expects "
                                 f"{tuple(mine[k].shape)}")
    return trainer.place_params(whole)
