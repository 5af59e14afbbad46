"""Lowerings of paddle_tpu/static/ops_tail5.py that the layers DSL emits
(counterpart of that module; the rest waits for a later slice): ``fc``,
the fused inference op that ``layers.fc`` builds under some passes."""
from __future__ import annotations

import numpy as np
import torch

from .ops import _one
from .registry import register_op


@register_op("fc")
def _fc_op(ins, attrs, op):
    """ref fc_op.h: flatten the leading ``in_num_col_dims`` dims, x @ W +
    b, optional relu."""
    x, w, b = _one(ins, "Input"), _one(ins, "W"), _one(ins, "Bias")
    lead = tuple(x.shape[:int(attrs.get("in_num_col_dims", 1))])
    out = x.reshape(int(np.prod(lead)) if lead else 1, -1) @ w
    if b is not None:
        out = out + b.reshape(1, -1)
    if attrs.get("activation_type", "") == "relu":
        out = torch.relu(out)
    return {"Out": [out.reshape(lead + (w.shape[1],))]}
