"""Automatic mixed precision (counterpart of paddle_tpu/amp).

As in the JAX package, ``auto_cast`` is a value cast, not an op-level
autocast: inside the context ``amp_cast`` casts floating tensors to the
compute dtype (bfloat16 by default), and the functional ops keep their
norms, softmaxes and losses in fp32 themselves.  ``decorate`` at O2 casts
the models' parameters; at O1 it leaves them fp32.  ``GradScaler`` is the
reference's dynamic loss-scale state machine: the scale grows by
``incr_ratio`` after ``incr_every_n_steps`` finite steps and shrinks by
``decr_ratio`` (never below 1) after ``decr_every_n_nan_or_inf``
non-finite ones, whose update is skipped.  The JAX package reads each
gradient's finiteness on the host, one tensor at a time; the port reduces
all of them on the device and reads one flag a step.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional

import torch

from ..core import dtype as _dtype

__all__ = ["auto_cast", "amp_guard", "GradScaler", "AmpScaler", "decorate",
           "amp_state", "amp_cast", "WHITE_LIST", "BLACK_LIST"]

# ops safe in low precision / kept in fp32 (informational, as in the JAX
# package: the functional ops pin their fp32 parts themselves)
WHITE_LIST = ("matmul", "conv2d", "mul", "fc", "attention")
BLACK_LIST = ("softmax", "layer_norm", "batch_norm", "cross_entropy",
              "mean", "sum", "exp", "log")


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"


_state = _AmpState()


def amp_state():
    return _state


def _torch_dtype(dtype):
    return dtype if isinstance(dtype, torch.dtype) else \
        _dtype.convert_dtype(dtype)


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: str = "bfloat16"):
    """Within the context, ``amp_cast`` casts to ``dtype``."""
    old = (_state.enabled, _state.dtype, _state.level)
    _state.enabled = enable
    _state.dtype = _torch_dtype(dtype)
    _state.level = level
    try:
        yield
    finally:
        _state.enabled, _state.dtype, _state.level = old


amp_guard = auto_cast


def amp_cast(tree, dtype=None):
    """Every floating tensor of a nested dict / list / tuple cast to the AMP
    compute dtype (unchanged when autocast is off and no dtype given)."""
    if dtype is None:
        if not _state.enabled:
            return tree
        dtype = _state.dtype
    dtype = _torch_dtype(dtype)

    def cast(x):
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cast(v) for v in x)
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    return cast(tree)


def decorate(models, optimizers=None, level: str = "O2",
             dtype: str = "bfloat16", master_weight: Optional[bool] = None):
    """O2 casts the models' parameters to ``dtype`` in place; O1 leaves
    them fp32 (compute is cast by ``auto_cast``).  Returns ``models``, or
    ``(models, optimizers)`` when optimizers are given."""
    if level not in ("O1", "O2"):
        raise ValueError("level must be O1 or O2")
    model_list = models if isinstance(models, (list, tuple)) else [models]
    if level == "O2":
        for m in model_list:
            m.to(dtype=_torch_dtype(dtype))
    if optimizers is None:
        return models
    return models, optimizers


def _all_finite(grads) -> bool:
    """One host read for the whole list: a non-finite element makes its
    ``g * 0`` NaN, and so the sum of their norms."""
    if not grads:
        return True
    zeros = torch._foreach_mul([g.float() for g in grads], 0.0)
    return bool(torch.stack(torch._foreach_norm(zeros)).sum().isfinite())


class GradScaler:
    """Dynamic loss scaling: ``scale(loss)``, then ``step(optimizer)`` (or
    ``minimize``) unscales the gradients, skips the update when any is
    non-finite and advances the state machine through ``update()``."""

    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good = 0
        self._bad = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def get_scale(self) -> float:
        return self._scale

    def scale(self, loss):
        """The loss times the current scale (fp32), before backward."""
        if not self._enable:
            return loss
        return loss * torch.tensor(self._scale, dtype=torch.float32,
                                   device=loss.device)

    def unscale_(self, grads):
        """Gradients divided by the scale (new tensors, same structure);
        records whether any is non-finite."""
        if not self._enable:
            return grads
        inv = 1.0 / self._scale
        if isinstance(grads, dict):
            vals = torch._foreach_mul(list(grads.values()), inv)
            out = dict(zip(grads, vals))
        else:
            vals = torch._foreach_mul(list(grads), inv)
            out = vals
        self._found_inf = not _all_finite(vals)
        return out

    def update(self):
        """Advance the loss-scale state machine."""
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad += 1
            self._good = 0
            if self._bad >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad = 0
        else:
            self._good += 1
            self._bad = 0
            if self._good >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good = 0

    def step(self, optimizer, grads=None):
        """Unscale, then ``optimizer.step`` unless a gradient is
        non-finite.  With ``grads=None`` the bound parameters' ``.grad``
        (from ``scaler.scale(loss).backward()``) are unscaled in place
        first.  Returns whether the update ran."""
        if grads is None:
            params = [p for p in (optimizer._parameters or [])
                      if p.grad is not None]
            if self._enable:
                unscaled = self.unscale_([p.grad for p in params])
                for p, g in zip(params, unscaled):
                    p.grad = g
            if not self._found_inf:
                optimizer.step(None)
            return not self._found_inf
        grads = self.unscale_(grads)
        if not self._found_inf:
            optimizer.step(grads)
        return not self._found_inf

    def minimize(self, optimizer, scaled_loss_grads=None):
        """The reference's ``minimize(optimizer, scaled_loss)``: the loss
        tensor means "gradients from backward"; a list / tuple / dict is
        taken as explicit gradients."""
        if scaled_loss_grads is not None and not isinstance(
                scaled_loss_grads, (list, tuple, dict)):
            scaled_loss_grads = None
        return self.step(optimizer, scaled_loss_grads)

    def state_dict(self) -> Dict[str, Any]:
        return {"scale": self._scale, "incr_count": self._good,
                "decr_count": self._bad}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good = state.get("incr_count", 0)
        self._bad = state.get("decr_count", 0)


AmpScaler = GradScaler
