"""Concrete optimizers (counterpart of paddle_tpu/optimizer/optimizers.py).

Only Adam is ported so far; SGD, Momentum, AdamW and the rest wait for a
later slice (ROADMAP.md).  The JAX package leaves the update to XLA, which
fuses it into the step; the port writes it as PyTorch ``_foreach`` ops, a
handful of launches for the whole parameter list.
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer


class Adam(Optimizer):
    """Bias-corrected Adam with fp32 moments whatever the parameter type,
    as the JAX package's: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
    t = step as fp32 (1 at the first update), p = (p.float() - lr m_hat /
    (sqrt(v_hat) + eps)).to(p.dtype).  Parameters and moments are updated
    in place."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None):
        super().__init__(learning_rate, parameters)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_param_state(self, p):
        return (torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                torch.zeros(p.shape, dtype=torch.float32, device=p.device))

    def apply_updates(self, grads, params, slots, lr, step):
        if not params:
            return
        ms = [s[0] for s in slots]
        vs = [s[1] for s in slots]
        g32 = [g.float() for g in grads]
        torch._foreach_mul_(ms, self.beta1)
        torch._foreach_add_(ms, g32, alpha=1 - self.beta1)
        torch._foreach_mul_(vs, self.beta2)
        torch._foreach_addcmul_(vs, g32, g32, value=1 - self.beta2)
        # bias corrections in fp32, as the JAX package's fp32 step count
        t = np.float32(step)
        bc1 = float(np.float32(1) - np.float32(self.beta1) ** t)
        bc2 = float(np.float32(1) - np.float32(self.beta2) ** t)
        m_hat = torch._foreach_div(ms, bc1)
        denom = torch._foreach_sqrt(torch._foreach_div(vs, bc2))
        torch._foreach_add_(denom, self.epsilon)
        upd = torch._foreach_mul(m_hat, float(np.float32(lr)))
        torch._foreach_div_(upd, denom)
        fp32 = [i for i, p in enumerate(params) if p.dtype == torch.float32]
        if fp32:
            torch._foreach_sub_([params[i] for i in fp32],
                                [upd[i] for i in fp32])
        for i, p in enumerate(params):
            if p.dtype != torch.float32:
                p.copy_(p.float() - upd[i])
