"""Mixture-of-experts FFN with expert parallelism over the ``ep`` mesh dim
(counterpart of paddle_tpu/nn/layer/moe.py).

The GShard / Switch formulation, as in the JAX package: gating with a
capacity per expert gives one-hot ``dispatch`` and weighted ``combine``
tensors [B, S, E, C], and the experts run as batched products over
``wi [E, D, F]`` / ``wo [E, F, D]``.  The JAX package shards the expert
dim over ``ep`` and lets GSPMD lower the dispatch products to
all-to-alls.  The port writes the route out:

* under ``ep`` each rank holds ``E / ep`` experts and its own slice of
  the batch (ep doubles as a batch dim outside the experts, as in
  GShard); the tokens' expert inputs reach their experts' ranks by an
  all-to-all and come back by the inverse one, so every expert sees the
  tokens of every ep rank;
* under sequence parallelism (``seq_axis`` set) a rank holds ``S / sp``
  positions; the gating sees the whole sequence (the gate probabilities
  are all-gathered over sp), so capacity and each expert's slot order
  are those of the whole sequence; each rank's partial expert inputs are
  reduce-scattered over sp before the all-to-all and the expert outputs
  all-gathered after it;
* under ``tp`` the expert FFN's hidden dim is split (Megatron-style).

No Pallas kernel lies behind the JAX module: the products here are
plain torch.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as tF

from ...core import dtype as _dtype_mod
from .. import functional as F
from .. import initializer as init
from .base import Layer, Parameter

__all__ = ["MoEFFN", "switch_gating", "top2_gating"]


def _one_hot(x, n, dtype=torch.float32):
    """One-hot over ``n`` classes; an index >= n gives a zero row
    (``jax.nn.one_hot``'s semantics)."""
    x = x.long()
    return tF.one_hot(x.clamp(max=n), n + 1)[..., :n].to(dtype)


def _gate_top1(gates, capacity):
    e = gates.shape[-1]
    mask1 = _one_hot(gates.argmax(dim=-1), e)
    # each token's position in its expert's buffer (sequence order)
    pos1 = torch.cumsum(mask1, dim=1) * mask1 - mask1
    keep1 = mask1 * (pos1 < capacity)
    gate1 = (gates * keep1).sum(dim=-1)
    pos_in_expert = _one_hot(pos1.sum(dim=-1), capacity)
    dispatch = keep1[..., None] * pos_in_expert[:, :, None, :]
    combine = dispatch * gate1[..., None, None]
    return dispatch, combine, mask1.mean(dim=(0, 1)), gates.mean(dim=(0, 1))


def _gate_top2(gates, capacity):
    e = gates.shape[-1]
    mask1 = _one_hot(gates.argmax(dim=-1), e)
    mask2 = _one_hot((gates * (1.0 - mask1)).argmax(dim=-1), e)
    pos1 = torch.cumsum(mask1, dim=1) * mask1 - mask1
    # second choices queue behind every first choice of that expert
    used1 = mask1.sum(dim=1, keepdim=True)
    pos2 = (torch.cumsum(mask2, dim=1) * mask2 - mask2) + used1 * mask2
    keep1 = mask1 * (pos1 < capacity)
    keep2 = mask2 * (pos2 < capacity)
    g1 = (gates * keep1).sum(dim=-1)
    g2 = (gates * keep2).sum(dim=-1)
    denom = torch.clamp_min(g1 + g2, 1e-9)
    g1, g2 = g1 / denom, g2 / denom
    d1 = keep1[..., None] * _one_hot(pos1.sum(dim=-1), capacity)[:, :, None]
    d2 = keep2[..., None] * _one_hot(pos2.sum(dim=-1), capacity)[:, :, None]
    dispatch = torch.maximum(d1, d2)
    combine = d1 * g1[..., None, None] + d2 * g2[..., None, None]
    return dispatch, combine, mask1.mean(dim=(0, 1)), gates.mean(dim=(0, 1))


def _aux(density, proxy):
    """The Switch load-balancing loss: E * sum_e(density_e * proxy_e)."""
    return density.shape[-1] * (density * proxy).sum()


def switch_gating(gates, capacity: int):
    """Switch-Transformer top-1 gating.  gates: [B, S, E] probabilities.
    Returns (dispatch [B, S, E, C] one-hot, combine [B, S, E, C] weights,
    aux load-balancing loss)."""
    dispatch, combine, density, proxy = _gate_top1(gates, capacity)
    return dispatch, combine, _aux(density, proxy)


def top2_gating(gates, capacity: int):
    """GShard top-2 gating with capacity overflow drop; second choices
    queue behind first-choice traffic.  Returns (dispatch, combine, aux)
    as ``switch_gating``."""
    dispatch, combine, density, proxy = _gate_top2(gates, capacity)
    return dispatch, combine, _aux(density, proxy)


def _size(axis) -> int:
    from ...parallel import mesh as _mesh

    m = _mesh.get_mesh()
    return 1 if m is None else _mesh.mesh_axis_size(axis, m)


class MoEFFN(Layer):
    """Expert-parallel FFN block: y = combine . expert_ffn(dispatch . x).

    ``wi [E, D, F]`` / ``wo [E, F, D]`` carry ``sharding_axes`` (ep on the
    expert dim, tp on the FFN dim), which ``parallel.sharding`` reads; a
    rank bound to ``E / ep`` experts runs the all-to-all route (module
    docstring), and one bound to ``F / tp`` columns the tensor-parallel
    one.  ``seq_axis`` names the mesh dim splitting the sequence, or None.
    Parameters are drawn on the CPU from ``generator`` (keyword-only)."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 activation: str = "gelu", name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        from ...parallel.mesh import EP_AXIS, TP_AXIS

        if top_k not in (1, 2):
            raise ValueError("top_k must be 1 (Switch) or 2 (GShard)")
        self.d_model, self.d_ff = d_model, d_ff
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.activation = getattr(F, activation)
        self.seq_axis = None
        dtype = _dtype_mod.get_default_dtype()
        xavier = init.XavierUniform()

        def make(shape):
            return Parameter(xavier(shape, dtype, generator=generator),
                             initializer=xavier)

        self.gate_weight = make((d_model, num_experts))
        self.wi = make((num_experts, d_model, d_ff))
        self.wo = make((num_experts, d_ff, d_model))
        self.wi.sharding_axes = (EP_AXIS, None, TP_AXIS)
        self.wo.sharding_axes = (EP_AXIS, TP_AXIS, None)
        self.aux_loss = torch.zeros(())  # the last forward's aux loss

    def capacity(self, seq_len: int) -> int:
        c = int(self.top_k * seq_len * self.capacity_factor /
                self.num_experts)
        return max(c, 1)

    def forward(self, x):
        """x: [B, S, D] -> [B, S, D]; the load-balancing loss is
        ``self.aux_loss`` afterwards (``forward_with_aux`` returns it)."""
        y, aux = self.forward_with_aux(x)
        self.aux_loss = aux
        return y

    def forward_with_aux(self, x):
        from ...parallel import collective as C
        from ...parallel.mesh import DP_AXIS, EP_AXIS, TP_AXIS

        b, s_local, dm = x.shape
        e = self.num_experts
        sp = 1 if self.seq_axis is None else _size(self.seq_axis)
        ep = e // self.wi.shape[0]
        tp = self.d_ff // self.wi.shape[2]
        cap = self.capacity(s_local * sp)
        logits = torch.einsum("bsd,de->bse", x, self.gate_weight)
        gates = torch.softmax(logits.float(), dim=-1)
        if sp > 1:  # the gating sees the whole sequence
            gates = C.all_gather(gates, group=self.seq_axis, axis=1)
        gate = _gate_top1 if self.top_k == 1 else _gate_top2
        dispatch, combine, density, proxy = gate(gates, cap)
        batch_axes = tuple(a for a in (DP_AXIS, EP_AXIS) if _size(a) > 1)
        if batch_axes:  # the whole batch's statistics on every rank
            n = 1
            for a in batch_axes:
                n *= _size(a)
            density = C.all_reduce(density, group=batch_axes) / n
            proxy = C.all_reduce(proxy, group=batch_axes) / n
        aux = _aux(density, proxy)
        if sp > 1:
            r = C.axis_index(self.seq_axis)
            dispatch = dispatch[:, r * s_local:(r + 1) * s_local]
            combine = combine[:, r * s_local:(r + 1) * s_local]
        dispatch = dispatch.to(x.dtype)
        combine = combine.to(x.dtype)
        # route: [B, S, E, C] x [B, S, D] -> [E, B*C, D]
        ein = torch.einsum("bsec,bsd->ebcd", dispatch, x).reshape(
            e, b * cap, dm)
        if sp > 1:
            ein = C.reduce_scatter(ein, group=self.seq_axis, axis=1)
        if ep > 1:
            ein = C.all_to_all(ein, group=EP_AXIS, split_axis=0,
                               concat_axis=1)
        if tp > 1:
            ein = C.copy_to_group(ein, TP_AXIS)
        h = self.activation(torch.einsum("end,edf->enf", ein, self.wi))
        eout = torch.einsum("enf,efd->end", h, self.wo)
        if tp > 1:
            eout = C.all_reduce(eout, group=TP_AXIS)
        if ep > 1:
            eout = C.all_to_all(eout, group=EP_AXIS, split_axis=1,
                                concat_axis=0)
        if sp > 1:
            eout = C.all_gather(eout, group=self.seq_axis, axis=1)
        eout = eout.reshape(e, b, cap, dm)
        return torch.einsum("bsec,ebcd->bsd", combine, eout), aux
