"""Lowerings of paddle_tpu/static/ops_tail2.py that the layers DSL emits
(counterpart of that module; its collectives, RNN monoliths, fusion ops,
LoD arrays and PS data-plane ops wait for a later slice): ``fsp``,
``inplace_abn``, the host-IO ops ``save`` / ``save_combine`` / ``load`` /
``load_combine`` and ``py_func``, ``cross_entropy2`` and
``sample_logits``.

The port runs op by op, so the host-IO ops act when they run (the JAX
package needs ordered host callbacks under its trace); ``py_func`` calls
its Python function on numpy copies of its inputs and moves the results to
the device.  ``sample_logits`` draws from the Executor's per-op CPU
generator: its draws repeat for a fixed seed but cannot match
``jax.random``.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as tF

from ..core import dtype as _dtype_mod
from ..core import random as _random
from ..nn import functional as F
from .ops import _one
from .registry import register_op


@register_op("fsp")
def _fsp(ins, attrs, op):
    """ref fsp_op.cc (knowledge distillation): the normalized gram matrix
    of two feature maps, (B, C1, C2)."""
    x, y = _one(ins, "X"), _one(ins, "Y")
    hw = x.shape[2] * x.shape[3]
    return {"Out": [torch.einsum("bchw,bdhw->bcd", x, y) / hw]}


@register_op("inplace_abn")
def _inplace_abn(ins, attrs, op):
    """ref inplace_abn_op.cc: batch_norm + activation."""
    out, new_rm, new_rv = F.batch_norm(
        _one(ins, "X"), _one(ins, "Mean"), _one(ins, "Variance"),
        weight=_one(ins, "Scale"), bias=_one(ins, "Bias"),
        training=not attrs.get("is_test", False),
        momentum=attrs.get("momentum", 0.9),
        epsilon=attrs.get("epsilon", 1e-5))
    act = attrs.get("activation", "identity")
    if act == "leaky_relu":
        out = tF.leaky_relu(out, attrs.get("alpha", 0.01))
    elif act == "elu":
        out = tF.elu(out, attrs.get("alpha", 1.0))
    elif act != "identity":
        out = getattr(torch, act)(out)
    return {"Y": [out], "MeanOut": [new_rm], "VarianceOut": [new_rv]}


# -- host-IO ops (ref save_op.cc, load_op.cc, save_combine_op.cc,
#    load_combine_op.cc, py_func_op.cc) --------------------------------------

def _host(t) -> np.ndarray:
    from .io import _to_saved

    return _to_saved(t)


def _device(arr, like_device):
    from .io import _from_saved

    v = _from_saved(np.asarray(arr))
    return torch.as_tensor(v).to(like_device)


def _open_for_write(path):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return open(path, "wb")  # the exact path: np.save(str) appends .npy


@register_op("save")
def _save_op(ins, attrs, op):
    with _open_for_write(attrs["file_path"]) as f:
        np.save(f, _host(_one(ins, "X")))
    return {}


@register_op("save_combine")
def _save_combine_op(ins, attrs, op):
    with _open_for_write(attrs["file_path"]) as f:
        np.savez(f, **{str(n): _host(v)
                       for n, v in zip(op.inputs["X"], ins["X"])})
    return {}


@register_op("load")
def _load_op(ins, attrs, op):
    from .ops import current_device

    return {"Out": [_device(np.load(attrs["file_path"]), current_device())]}


@register_op("load_combine")
def _load_combine_op(ins, attrs, op):
    from .ops import current_device

    data = np.load(attrs["file_path"])
    return {"Out": [_device(data[str(n)], current_device())
                    for n in op.outputs["Out"]]}


_PY_FUNCS = {}


def register_py_func(fid: int, fn) -> None:
    """ref py_func_op.cc's python-callable registry."""
    _PY_FUNCS[int(fid)] = fn


@register_op("py_func")
def _py_func_op(ins, attrs, op):
    from .ops import current_device

    fn = _PY_FUNCS[int(attrs["forward_callable_id"])]
    out_dtypes = attrs.get("out_dtypes",
                           ["float32"] * len(attrs["out_shapes"]))
    r = fn(*[_host(x) for x in ins.get("X", [])])
    if not isinstance(r, (tuple, list)):
        r = (r,)
    return {"Out": [torch.as_tensor(np.asarray(v)).to(
        device=current_device(), dtype=_dtype_mod.convert_dtype(d))
        for v, d in zip(r, out_dtypes)]}


@register_op("cross_entropy2")
def _cross_entropy2(ins, attrs, op):
    """ref cross_entropy_op2.cc: hard-label CE over probabilities with the
    MatchX / XShape outputs of the paired grad kernel."""
    x = _one(ins, "X")
    label = _one(ins, "Label").reshape(x.shape[:-1]).long()
    match = torch.gather(x, -1, label[..., None])
    loss = -torch.log(torch.clamp_min(match, 1e-12))
    ignore = attrs.get("ignore_index", -100)
    loss = torch.where(label[..., None] == ignore, torch.zeros_like(loss),
                       loss)
    return {"Y": [loss], "MatchX": [match], "XShape": [x]}


@register_op("sample_logits")
def _sample_logits(ins, attrs, op):
    """ref sample_logits_op.cc (sampled softmax): the true-label logit plus
    ``num_samples`` uniform negatives, with the log-q correction."""
    logits = _one(ins, "Logits")   # (B, C)
    labels = _one(ins, "Labels").reshape(-1).long()
    n = attrs["num_samples"]
    B, C = logits.shape
    samples = torch.randint(0, C, (B, n),
                            generator=_random.current_generator())
    idx = torch.cat([labels[:, None], samples.to(labels.device)], dim=1)
    sampled = torch.gather(logits, 1, idx)
    out = sampled - float(np.log(np.float32(n / C)))
    out = torch.cat([sampled[:, :1], out[:, 1:]], dim=1)
    return {"SampledLogits": [out], "Samples": [idx.to(torch.int32)],
            "SampledLabels": [torch.zeros((B,), dtype=torch.int32,
                                          device=logits.device)]}
