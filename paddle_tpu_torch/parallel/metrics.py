"""Distributed metrics: cross-worker reductions of host metric values
(counterpart of paddle_tpu/parallel/metrics.py).

Reference parity: python/paddle/distributed/fleet/metrics/metric.py --
``sum``, ``max``, ``min``, ``auc``, ``mae``, ``rmse``, ``acc`` allreduced
across trainers.

Metric accumulation is host-side numpy (``paddle_tpu_torch.metric``);
each reduction here is an all-reduce over the dp group (``axis``, else
the mesh's dp dim when it holds more than one member), through the
group's device (the card under NCCL), and the identity in one process.
Results are CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..metric.metrics import Auc as _Auc
from . import collective as _coll
from . import mesh as _mesh

__all__ = ["sum", "max", "min", "acc", "mae", "rmse", "auc"]


def _reduce(value, op: str, axis: Optional[str] = None):
    ax = axis or _coll.bound_data_axis()
    x = torch.as_tensor(np.asarray(value))
    if ax is None:
        return x
    dev = _mesh.current_mesh().device
    out = _coll.all_reduce(x.to(dev), op=op, group=ax)
    return out.cpu()


def sum(value, axis: Optional[str] = None):
    """ref fleet/metrics/metric.py sum."""
    return _reduce(value, "sum", axis)


def max(value, axis: Optional[str] = None):
    return _reduce(value, "max", axis)


def min(value, axis: Optional[str] = None):
    return _reduce(value, "min", axis)


def _at_least_one(t):
    return torch.clamp(t, min=1)


def acc(correct, total, axis: Optional[str] = None):
    """Global accuracy = sum(correct) / sum(total) (ref metric.py acc)."""
    c = _reduce(correct, "sum", axis)
    t = _reduce(total, "sum", axis)
    return c / _at_least_one(t)


def mae(abserr_sum, total, axis: Optional[str] = None):
    return _reduce(abserr_sum, "sum", axis) / _at_least_one(
        _reduce(total, "sum", axis))


def rmse(sqrerr_sum, total, axis: Optional[str] = None):
    return torch.sqrt(_reduce(sqrerr_sum, "sum", axis) /
                      _at_least_one(_reduce(total, "sum", axis)))


def auc(stat_pos, stat_neg, axis: Optional[str] = None):
    """Global AUC from per-worker threshold histograms (ref metric.py auc:
    allreduce the pos/neg bucket stats, then integrate)."""
    pos = _reduce(np.asarray(stat_pos), "sum", axis).numpy()
    neg = _reduce(np.asarray(stat_neg), "sum", axis).numpy()
    m = _Auc(num_thresholds=len(pos) - 1)
    m._stat_pos = pos.astype(np.float64)
    m._stat_neg = neg.astype(np.float64)
    return m.accumulate()
