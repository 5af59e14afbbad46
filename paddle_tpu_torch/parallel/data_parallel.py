"""Dygraph DataParallel (counterpart of
paddle_tpu/parallel/data_parallel.py).

Reference parity: fluid/dygraph/parallel.py:236 ``DataParallel`` -- wraps
a Layer; after backward, ``apply_collective_grads`` coalesces gradient
buckets and allreduces them (imperative/all_reduce.cc).

The gradient average rides parallel/compress.py's bucketer:
``comm_buffer_size`` MB flat fp32 buckets in reverse flatten order with an
optional block-quantized wire payload -- the same bucketer fleet's
``DistributedStrategy.comm_quantize`` uses, so dygraph and fleet sync
agree bit for bit.  It averages over the mesh's dp group once
``init_parallel_env`` (or ``fleet.init``) has set the mesh, one-member
groups included; before that every method is the identity, so the same
script runs in one plain process.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from ..distributed import env as _env
from ..nn.layer.base import Layer
from . import collective as _coll
from . import compress as _compress
from . import mesh as _mesh

__all__ = ["DataParallel", "scale_loss", "apply_collective_grads",
           "shard_batch"]


def _live_axis(axis: Optional[str] = None) -> Optional[str]:
    """The mesh dim to reduce over: the explicit one, else the one named by
    ``data_axis_scope``, else the mesh's dp dim once the mesh has process
    groups; None in a process with no mesh."""
    ax = axis or _env.current_data_axis()
    if ax is not None:
        return ax
    m = _mesh.get_mesh()
    if m is None or m.device_mesh is None:
        return None
    return _mesh.DP_AXIS


def scale_loss(loss, axis: Optional[str] = None):
    """ref parallel.py scale_loss: divide by the trainer count.  The mean
    all-reduce makes it unnecessary; kept for scripts that pair it with a
    raw SUM all-reduce."""
    ax = _live_axis(axis)
    if ax is None:
        n = _env.get_world_size()
        return loss / n if n > 1 else loss
    return loss / _mesh.mesh_axis_size(ax)


def shard_batch(batch, mesh=None, batch_axes=None, seq_axis=None):
    """This rank's part of a host batch dict, on the rank's device, by the
    placement rule of the JAX package's ``ShardingPlan.feed_sharding``
    (ref: fluid/dygraph/parallel.py split-batch helpers): the leading dim
    split evenly over the mesh's batch dims (an indivisible one raises),
    and with ``seq_axis`` the second dim too where that mesh dim divides
    it; scalars, batch-1 leaves, and every leaf of a mesh with no batch
    dim are whole on every rank."""
    from . import sharding as _sharding

    mesh = mesh or _mesh.current_mesh()
    axes = tuple(a for a in (batch_axes or (_mesh.DP_AXIS,))
                 if a in mesh.axis_names)
    n = math.prod(mesh.shape[a] for a in axes)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        spec = ()
        if axes and t.dim() > 0 and t.shape[0] != 1:
            if t.shape[0] % n:
                raise ValueError(
                    f"data-parallel feed '{k}' batch dim {t.shape[0]} does "
                    f"not divide the {n} devices (the reference's "
                    "with_data_parallel requires an even split)")
            spec = (axes if len(axes) > 1 else axes[0],)
            if (seq_axis is not None and seq_axis in mesh.axis_names
                    and t.dim() > 1 and t.shape[1] > 1
                    and t.shape[1] % mesh.shape[seq_axis] == 0):
                spec += (seq_axis,)
        out[k] = _sharding.place(t, spec, mesh)
    return out


def apply_collective_grads(grads: Any, axis: Optional[str] = None,
                           comm_buffer_size: Optional[float] = None,
                           compress: Optional[str] = None,
                           hierarchy: Any = "auto"):
    """Average a gradient tree (a {name: tensor} dict, say) across the
    data-parallel ranks (ref DataParallel.apply_collective_grads); the
    averaged tree comes back, the input is not changed.  With no mesh set:
    the identity (one process).

    With ``comm_buffer_size`` (MB) or ``compress`` the leaves ride the
    shared bucketer (parallel/compress.py), optionally with a quantized
    wire payload (``compress="int8"/"fp8"``); else each leaf is averaged
    on its own."""
    ax = _live_axis(axis)
    if ax is None:
        return grads
    if comm_buffer_size is not None or compress is not None:
        return _compress.sync_gradients(
            grads, ax, compress=compress,
            buffer_mb=25.0 if comm_buffer_size is None else comm_buffer_size,
            hierarchy=hierarchy)
    leaves = _compress._flatten(grads)
    return _compress._unflatten(grads, iter(
        _compress.optimized_all_reduce(g, ax, hierarchy="off", mean=True)
        for _, g in leaves))


class DataParallel(Layer):
    """ref fluid/dygraph/parallel.py:236.

    Usage (mirrors the reference)::

        model = DataParallel(model)
        loss = loss_fn(model(x))
        grads = ...                      # autograd over the parameters
        grads = model.apply_collective_grads(grads)

    ``entry.make_train_step`` takes a DataParallel model and syncs each
    step's gradients through it before the optimizer's update.
    """

    def __init__(self, layers: Layer, strategy=None, comm_buffer_size: int = 25,
                 last_comm_buffer_size: int = 1, data_axis: Optional[str] = None,
                 comm_quantize: Optional[str] = None):
        super().__init__()
        if comm_buffer_size is None or float(comm_buffer_size) <= 0:
            raise ValueError(
                f"comm_buffer_size must be > 0 MB, got {comm_buffer_size!r}")
        self._layers = layers
        self.data_axis = data_axis
        self.comm_buffer_size = float(comm_buffer_size)
        # last_comm_buffer_size is parity-only: the reference uses a smaller
        # trailing bucket to flush stragglers; the greedy bucketer's natural
        # remainder bucket plays that role here
        self.comm_quantize = comm_quantize

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def scale_loss(self, loss):
        return scale_loss(loss, self.data_axis)

    def apply_collective_grads(self, grads):
        return apply_collective_grads(
            grads, self.data_axis, comm_buffer_size=self.comm_buffer_size,
            compress=self.comm_quantize)

    # delegate the Layer surface to the wrapped model (ref behavior)
    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)
