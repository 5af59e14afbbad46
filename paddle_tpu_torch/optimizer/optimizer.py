"""Optimizer base (counterpart of paddle_tpu/optimizer/optimizer.py).

Each optimizer is the functional pair ``init(params) -> state`` and
``update(grads, state, params, lr) -> (params, state)`` over a
{name: tensor} dict, plus a stateful facade that binds parameters so eager
code can call ``step()`` after ``loss.backward()``.  Unlike the JAX
package's pure update, the port updates parameters and slots in place
(under ``torch.no_grad``) and returns the same dict objects: a step
allocates no second copy of the model.  The state keys its slots by
parameter name (``convert.optimizer_state_from_jax`` maps the JAX
package's list, which follows sorted names).

``update`` applies, in the reference's order: the gradient clip, then the
L2 decay added to the gradients (``g + wd * p`` where ``_decay_applies``),
then the optimizer's rule, at the LR of step ``state["step"] + 1`` when
the LR is a scheduler.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .lr import LRScheduler


class Optimizer:
    """Base: subclasses implement ``init_param_state`` and
    ``apply_updates(grads, params, slots, lr, step)`` over aligned lists
    (``lr`` an ``np.float32``, ``step`` the 1-based int)."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._lr = learning_rate
        self._parameters: Optional[List[torch.Tensor]] = (
            list(parameters) if parameters else None)
        self.weight_decay = weight_decay or 0.0
        self.grad_clip = grad_clip
        self._state = None
        self._step_count = 0
        self.name = name

    # -- learning rate -------------------------------------------------------
    def get_lr(self, step: Optional[int] = None):
        """The LR: a scheduler's at ``step`` (default: the facade's step
        count), else the number given."""
        if isinstance(self._lr, LRScheduler):
            return self._lr.get_lr_at(self._step_count if step is None
                                      else step)
        return self._lr

    def set_lr(self, lr):
        self._lr = lr

    def set_state_dict(self, state):
        self._state = state.get("state", self._state)
        self._step_count = state.get("step", self._step_count)

    def state_dict(self):
        return {"state": self._state, "step": self._step_count}

    # -- functional core -----------------------------------------------------
    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """{name: tensor} -> optimizer state {"per_param": {name: slots},
        "step": 0}."""
        return {"per_param": {name: self.init_param_state(p)
                              for name, p in params.items()},
                "step": 0}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: Dict[str, Any],
               params: Dict[str, torch.Tensor], lr=None):
        """Apply ``grads`` to ``params`` in place; returns ``(params,
        state)``, the same objects, with ``state["step"]`` advanced."""
        step = state["step"] + 1
        if lr is None:
            lr = (self._lr.get_lr_at(step) if isinstance(self._lr, LRScheduler)
                  else self._lr)
        names = list(params)
        p_list = [params[n] for n in names]
        g_list = [grads[n] for n in names]
        if self.grad_clip is not None:
            g_list = self.grad_clip(g_list)
        if self.weight_decay:
            g_list = self._l2_decay(g_list, p_list)
        self.apply_updates(g_list, p_list,
                           [state["per_param"][n] for n in names],
                           np.float32(lr), step)
        state["step"] = step
        return params, state

    def _l2_decay(self, grads, params):
        """``g + wd * p.astype(g.dtype)`` with fp32 ``wd``: at least fp32,
        as the JAX package's promotion gives."""
        wd = float(np.float32(self.weight_decay))
        out = []
        for g, p in zip(grads, params):
            if self._decay_applies(p):
                dt = torch.promote_types(g.dtype, torch.float32)
                g = g.to(dt) + wd * p.to(g.dtype).to(dt)
            out.append(g)
        return out

    def _decay_applies(self, p):
        return True

    # -- subclass interface --------------------------------------------------
    def init_param_state(self, p) -> Any:
        return ()

    def apply_updates(self, grads, params, slots, lr, step: int):
        raise NotImplementedError

    # -- stateful facade -----------------------------------------------------
    def _param_list(self):
        if self._parameters is None:
            raise ValueError("Optimizer created without parameters; pass "
                             "parameters= or use the functional init/update "
                             "API")
        return self._parameters

    def _bound_state(self, params):
        if self._state is None:
            self._state = self.init({str(i): p for i, p in enumerate(params)})
        return self._state

    def step(self, grads=None):
        """Apply ``grads`` (a list aligned with the bound parameters, or a
        dict in that order) to them in place.  With ``grads=None`` the
        gradients are the parameters' ``.grad`` from ``loss.backward()``;
        parameters without one are skipped, as the reference skips
        parameters the loss never reached."""
        params = self._param_list()
        state = self._bound_state(params)
        if grads is None:
            idx = [i for i, p in enumerate(params)
                   if p.requires_grad and p.grad is not None]
            if not idx:
                raise ValueError("no parameter has a gradient; call "
                                 "loss.backward() first (or pass grads)")
            grads = {str(i): params[i].grad for i in idx}
        else:
            if isinstance(grads, dict):
                grads = list(grads.values())
            idx = range(len(params))
            grads = {str(i): g for i, g in enumerate(grads)}
        sub = {"per_param": {str(i): state["per_param"][str(i)] for i in idx},
               "step": state["step"]}
        self.update(grads, sub, {str(i): params[i] for i in idx})
        state["step"] = sub["step"]
        self._step_count += 1

    def clear_grad(self):
        """Drop the bound parameters' accumulated gradients."""
        for p in self._parameters or ():
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Apply the gradients that ``loss.backward()`` accumulated (the
        dygraph ``loss.backward(); opt.minimize(loss)`` contract).  Returns
        ``([], [])``, the static (optimize_ops, params_grads) shape."""
        del loss, startup_program, parameters, no_grad_set
        self.step(None)
        return [], []
