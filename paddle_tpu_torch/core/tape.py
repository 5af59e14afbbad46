"""The eager gradient surface on torch autograd (counterpart of
paddle_tpu/core/tape.py; ref varbase_patch_methods.py:131 ``backward``,
partial_grad_engine.cc).

The JAX package records a replay tape of API-boundary calls under
``dygraph.guard()`` and re-linearises each node in ``backward()``.  Here
tensors are ``torch.Tensor`` and torch autograd records the graph, so
there is no replay tape: ``backward`` and ``partial_grad`` are
``torch.autograd.backward`` / ``torch.autograd.grad`` with the reference's
checks, ``no_grad_ctx`` is ``torch.no_grad``, and recording is torch's
grad mode (``enable`` / ``disable`` / ``enabled``).  One difference stays:
torch records by default, where the JAX tape records only inside
``guard()``.

``stop_gradient`` is installed on ``torch.Tensor`` as a property, the
negation of ``requires_grad`` (torch has no attribute of that name, so
none is shadowed), with ``clear_gradient`` / ``clear_grad``
(``.grad = None``), as the JAX package installs them on its array class.
Setting ``stop_gradient = True`` on a tensor that is not a leaf detaches
it in place.
"""
from __future__ import annotations

from typing import List

import torch

no_grad_ctx = torch.no_grad


def enabled() -> bool:
    """Whether operations record gradients (torch's grad mode)."""
    return torch.is_grad_enabled()


def enable() -> None:
    torch.set_grad_enabled(True)


def disable() -> None:
    torch.set_grad_enabled(False)


def _get_stop_gradient(self):
    return not self.requires_grad


def _set_stop_gradient(self, value):
    if value:
        if self.is_leaf:
            self.requires_grad_(False)
        else:
            self.detach_()
    else:
        self.requires_grad_(True)


def _clear_gradient(self):
    self.grad = None


def _install() -> None:
    if torch.Tensor.__dict__.get("_paddle_tpu_torch_tape"):
        return
    for name in ("stop_gradient", "clear_gradient", "clear_grad"):
        if hasattr(torch.Tensor, name):
            raise RuntimeError(f"torch.Tensor already has {name!r}; the "
                               f"port does not shadow torch's names")
    torch.Tensor.stop_gradient = property(_get_stop_gradient,
                                          _set_stop_gradient)
    torch.Tensor.clear_gradient = _clear_gradient
    torch.Tensor.clear_grad = _clear_gradient
    torch.Tensor._paddle_tpu_torch_tape = True


_install()


def backward(loss, grad_tensor=None, retain_graph=False) -> None:
    """ref varbase_patch_methods.py:131: accumulate d``loss`` into every
    reachable leaf's ``.grad``.  A non-scalar ``loss`` needs
    ``grad_tensor``."""
    if grad_tensor is None:
        if loss.numel() != 1:
            raise ValueError(
                "backward() on a non-scalar tensor requires grad_tensor "
                "(reference: VarBase._run_backward scalar contract)")
        grad_tensor = torch.ones_like(loss)
    else:
        grad_tensor = torch.as_tensor(grad_tensor, dtype=loss.dtype,
                                      device=loss.device)
    torch.autograd.backward(loss, grad_tensor, retain_graph=retain_graph)


def partial_grad(outputs, inputs, grad_outputs=None, retain_graph=False,
                 allow_unused=False) -> List:
    """ref paddle.grad / PartialGradEngine: the gradients of ``outputs``
    with respect to ``inputs``, leaving every ``.grad`` alone.  An input
    the outputs do not reach raises unless ``allow_unused``, which gives
    None for it."""
    outs = list(outputs) if isinstance(outputs, (list, tuple)) else [outputs]
    ins = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is None:
        grad_outputs = [torch.ones_like(o) for o in outs]
    elif not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    grad_outputs = [torch.as_tensor(g, dtype=o.dtype, device=o.device)
                    for o, g in zip(outs, grad_outputs)]
    live = [i for i, x in enumerate(ins) if x.requires_grad]
    got = torch.autograd.grad(outs, [ins[i] for i in live], grad_outputs,
                              retain_graph=retain_graph,
                              allow_unused=True) if live else ()
    result = [None] * len(ins)
    for i, g in zip(live, got):
        result[i] = g
    if not allow_unused and any(g is None for g in result):
        raise ValueError(
            "an input tensor is not reachable from outputs (pass "
            "allow_unused=True to get None instead)")
    return result
