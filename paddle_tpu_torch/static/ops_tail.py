"""Lowerings of the reference's long tail of ops (counterpart of
paddle_tpu/static/ops_tail.py).  Ported so far: the frozen-scale fake
quant op that post-training quantization inserts (slim/quant_static.py).
"""
from __future__ import annotations

from .ops import _one
from .registry import register_op


def qmax(bits) -> float:
    """The largest level of a symmetric ``bits``-bit grid (127 for 8)."""
    return float(2 ** (int(bits) - 1) - 1)


@register_op("fake_quantize_dequantize_fixed_scale")
def _fake_qdq_fixed_scale(ins, attrs, op):
    """Frozen-scale quant-dequant: ``q = round(clip(x / scale, -1, 1) *
    qmax) / qmax * scale`` in x's dtype, in the straight-through form
    ``x + (q - x).detach()`` (forward q up to that sum's rounding,
    gradient the identity), as the JAX lowering computes it."""
    x = _one(ins, "X")
    qm = qmax(attrs.get("bit_length", 8))
    scale = attrs["scale"]
    q = (x / scale).clamp(-1.0, 1.0).mul(qm).round().div(qm).mul(scale)
    return {"Out": [x + (q - x).detach()]}
