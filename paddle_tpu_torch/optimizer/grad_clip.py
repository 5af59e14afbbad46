"""Gradient clipping (counterpart of paddle_tpu/optimizer/grad_clip.py).

Each clip is a callable over a {name: tensor} dict or a list of tensors,
returning new tensors in the same structure and dtypes.  Norms are fp32
over ``_foreach`` ops, and every scale stays on the device: no clip reads
the card.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm"]


def _apply(grads, fn):
    """``fn(list of tensors) -> list`` over a dict's values or a list."""
    if isinstance(grads, dict):
        return dict(zip(grads, fn(list(grads.values()))))
    return fn(list(grads))


def _scaled(grads, scales):
    """Each gradient times its fp32 scale (a 0-d device tensor), in fp32,
    then back to the gradient's dtype."""
    g32 = [g.float() for g in grads]
    out = torch._foreach_mul(g32, scales)
    return [o.to(g.dtype) for o, g in zip(out, grads)]


class ClipGradByValue:
    """Each element clipped to [min, max] (``min`` defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, grads):
        return _apply(grads, lambda gs: [g.clamp(self.min, self.max)
                                         for g in gs])


class ClipGradByNorm:
    """Each tensor scaled by min(1, clip_norm / max(||g||, 1e-12))."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _clip(self, grads):
        if not grads:
            return []
        norms = torch.stack(torch._foreach_norm([g.float() for g in grads]))
        scales = torch.clamp(self.clip_norm / norms.clamp_min(1e-12), max=1.0)
        return _scaled(grads, list(scales.unbind()))

    def __call__(self, grads):
        return _apply(grads, self._clip)


class ClipGradByGlobalNorm:
    """Every tensor scaled by clip_norm / max(global norm, clip_norm), the
    global norm sqrt(sum of every squared element) in fp32."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def global_norm(self, grads):
        """The fp32 global norm as a 0-d device tensor."""
        norms = torch._foreach_norm([g.float() for g in grads])
        return torch.stack(norms).square().sum().sqrt()

    def _clip(self, grads):
        if not grads:
            return []
        norm = self.global_norm(grads)
        scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
        return _scaled(grads, [scale] * len(grads))

    def __call__(self, grads):
        return _apply(grads, self._clip)


GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm
