"""Optimizer base (counterpart of paddle_tpu/optimizer/optimizer.py).

Each optimizer is the functional pair ``init(params) -> state`` and
``update(grads, state, params, lr) -> (params, state)`` over a
{name: tensor} dict, plus a stateful facade that binds parameters so eager
code can call ``step(grads)``.  Unlike the JAX package's pure update, the
port updates parameters and moments in place (under ``torch.no_grad``) and
returns the same dict objects: a step allocates no second copy of the
model.  Weight decay, gradient clipping and LR schedules are not ported
yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch


class Optimizer:
    """Base: subclasses implement ``init_param_state`` and
    ``apply_updates``."""

    def __init__(self, learning_rate=0.001, parameters=None):
        self._lr = learning_rate
        self._parameters: Optional[List[torch.Tensor]] = (
            list(parameters) if parameters is not None else None)
        self._state = None

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
        lr = self._lr if lr is None else lr
        names = list(params)
        self.apply_updates([grads[n] for n in names],
                           [params[n] for n in names],
                           [state["per_param"][n] for n in names],
                           float(lr), step)
        state["step"] = step
        return params, state

    # -- subclass interface --------------------------------------------------
    def init_param_state(self, p) -> Any:
        return ()

    def apply_updates(self, grads, params, slots, lr: float, step: int):
        raise NotImplementedError

    # -- stateful facade -----------------------------------------------------
    def step(self, grads):
        """Apply ``grads`` (a list aligned with the bound parameters, or a
        dict in that order) to the bound parameters in place."""
        if self._parameters is None:
            raise ValueError("Optimizer created without parameters; pass "
                             "parameters= or use the functional init/update "
                             "API")
        if isinstance(grads, dict):
            grads = list(grads.values())
        params = {str(i): p for i, p in enumerate(self._parameters)}
        if self._state is None:
            self._state = self.init(params)
        self.update({str(i): g for i, g in enumerate(grads)}, self._state,
                    params)
