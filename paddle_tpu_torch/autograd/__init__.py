"""The functional bridge between the Layer tree and torch autograd, and
activation recompute (counterpart of paddle_tpu/autograd).

* ``parameters_dict`` / ``buffers_dict`` take a Layer's tensors out by
  qualified name; ``load_parameters`` / ``load_buffers`` copy a dict back
  in place.
* ``functional_call(layer, params, args, kwargs, rng, buffers)`` calls the
  layer with those tensors bound in place of its own
  (``torch.func.functional_call``), under ``rng`` (a CPU
  ``torch.Generator``) as the active generator when given.
* ``value_and_grad(layer, loss_fn, has_aux)`` builds ``compute(params,
  *args, rng=None) -> (loss, grads)``: ``loss_fn(*args)`` run with
  ``params`` bound (whatever calls it makes to the layer), its gradients
  by ``torch.autograd.grad``; ``grad`` keeps the gradients alone.  The
  JAX package's ``jax.value_and_grad`` over a pytree becomes a dict of
  tensors in, a dict of gradients out.
* ``backward``, ``no_grad`` and ``partial_grad`` are ``core.tape``'s.

``recompute(fn, *args, policy=...)`` runs ``fn`` now and runs it again
inside the backward to rebuild what the policy did not keep, through
``torch.utils.checkpoint`` (non-reentrant).  The JAX package gets the
replay's dropout for free: ``jax.checkpoint`` replays the same key.  Here
dropout seeds are ints drawn from the active host generator
(core/random.py), which torch's checkpoint does not restore, so
``recompute`` saves that generator's state on entry, runs the forward under
a copy of it (then moves the active generator on to where the copy ended)
and the replay under a second copy from the same state: the replay draws
the forward's seeds, so its dropout masks are the forward's, and the
active generator ends as it would without recompute.

Policies (``RecomputeConfig.policy`` names):

* None, ``""``, ``"nothing_saveable"``: keep nothing, replay all of ``fn``;
* ``"everything_saveable"``: keep everything, so ``fn`` just runs;
* ``"dots_saveable"``: keep the outputs of matrix products (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``), through torch's selective-checkpoint
  contexts; ``"dots_with_no_batch_dims_saveable"``: of ``mm`` and
  ``addmm`` only.  The kernels run through ctypes inside autograd
  Functions, which a selective-checkpoint policy does not see as matrix
  products: they run again in the replay, as a ``pallas_call`` is not a
  dot to the JAX policies either.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch
import torch.utils.checkpoint as _ckpt

from ..core import random as _random

from ..core.tape import backward, no_grad_ctx as no_grad  # noqa: F401
from ..core.tape import partial_grad  # noqa: F401  (paddle.grad engine)

__all__ = ["parameters_dict", "buffers_dict", "load_parameters",
           "load_buffers", "functional_call", "value_and_grad", "grad",
           "backward", "no_grad", "partial_grad", "recompute",
           "checkpoint_policy", "replaying"]


def parameters_dict(layer, trainable_only: bool = True):
    """{qualified_name: parameter}, each tied tensor once (under its first
    name); frozen parameters too when ``trainable_only`` is False."""
    return {name: p for name, p in layer.named_parameters()
            if p.requires_grad or not trainable_only}


def buffers_dict(layer):
    """{qualified_name: buffer}, persistable or not."""
    return dict(layer.named_buffers())


def _copy_into(own, values):
    with torch.no_grad():
        for name, t in own.items():
            if name in values and values[name] is not t:
                t.copy_(values[name])


def load_parameters(layer, params) -> None:
    """Copy ``params`` ({name: tensor}) into the layer's parameters in
    place (the names it lacks are ignored)."""
    _copy_into(dict(layer.named_parameters()), params)


def load_buffers(layer, bufs) -> None:
    _copy_into(dict(layer.named_buffers()), bufs)


def _scope(rng):
    return (_random.rng_scope(rng) if rng is not None
            else contextlib.nullcontext())


def functional_call(layer, params, args=(), kwargs=None, rng=None,
                    buffers=None):
    """``layer(*args, **kwargs)`` with ``params`` (and ``buffers``) bound in
    place of the layer's own; names not given keep the layer's.  ``rng``,
    a CPU ``torch.Generator``, is the active generator inside (dropout
    seeds are drawn from it)."""
    bound = dict(params)
    if buffers:
        bound.update(buffers)
    if not isinstance(args, tuple):
        args = (args,)
    with _scope(rng):
        return torch.func.functional_call(layer, bound, args, kwargs or {})


class _Closure(torch.nn.Module):
    """Holds ``layer`` as its one child so that ``functional_call`` binds
    the layer's tensors while ``fn`` runs (``fn`` may call the layer any
    number of times, or call other code that does)."""

    def __init__(self, layer, fn):
        super().__init__()
        self.layer = layer
        object.__setattr__(self, "_fn", fn)

    def forward(self, *args):
        return self._fn(*args)


def value_and_grad(layer, loss_fn, has_aux: bool = False):
    """``compute(params, *args, rng=None) -> (loss, grads)`` (``((loss,
    aux), grads)`` with ``has_aux``): ``loss_fn(*args)`` with ``params``
    ({name: tensor}) bound in the layer, and the gradients of the loss
    with respect to each of them, by name.  ``loss`` comes back
    detached."""
    closure = _Closure(layer, loss_fn)

    def compute(params, *args, rng=None):
        names = list(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        with _scope(rng):
            out = torch.func.functional_call(
                closure, {f"layer.{k}": v for k, v in leaves.items()}, args)
        loss, aux = (out[0], out[1]) if has_aux else (out, None)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(leaves[k]) if g is None else g)
                 for k, g in zip(names, grads)}
        value = (loss.detach(), aux) if has_aux else loss.detach()
        return value, grads

    return compute


def grad(layer, loss_fn):
    """``compute(params, *args, rng=None) -> grads`` of ``value_and_grad``."""
    vag = value_and_grad(layer, loss_fn)

    def compute(params, *args, rng=None):
        return vag(params, *args, rng=rng)[1]

    return compute

_aten = torch.ops.aten
_DOTS = frozenset({_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                   _aten.baddbmm.default})
_DOTS_NO_BATCH = frozenset({_aten.mm.default, _aten.addmm.default})


def _saving(ops):
    def policy(ctx, op, *args, **kwargs):
        return (_ckpt.CheckpointPolicy.MUST_SAVE if op in ops
                else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def _keep_nothing(ctx, op, *args, **kwargs):
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _keep_everything(ctx, op, *args, **kwargs):
    return _ckpt.CheckpointPolicy.MUST_SAVE


_POLICIES = {
    None: None,
    "": None,
    "nothing_saveable": _keep_nothing,
    "everything_saveable": _keep_everything,
    "dots_saveable": _saving(_DOTS),
    "dots_with_no_batch_dims_saveable": _saving(_DOTS_NO_BATCH),
}


def checkpoint_policy(name):
    """A policy name -> a selective-checkpoint policy function ``(ctx, op,
    *args, **kwargs) -> CheckpointPolicy``, or None (replay everything)
    for None and ``""``.  Unknown names raise ValueError."""
    if name not in _POLICIES:
        raise ValueError(
            f"unknown recompute policy {name!r}; one of "
            f"{sorted(k for k in _POLICIES if k)}")
    return _POLICIES[name]


class _Replay(threading.local):
    def __init__(self):
        self.depth = 0


_replay = _Replay()


def replaying() -> bool:
    """True while ``recompute`` runs a function again inside the backward
    (on the thread that runs it)."""
    return _replay.depth > 0


@contextlib.contextmanager
def _replay_scope(on):
    _replay.depth += int(on)
    try:
        yield
    finally:
        _replay.depth -= int(on)


def recompute(fn, *args, policy=None, **kwargs):
    """``fn(*args, **kwargs)``, its activations rebuilt in the backward
    under ``policy`` (see the module docstring), with the same dropout
    draws in the replay as in the forward."""
    resolved = checkpoint_policy(policy)
    if policy == "everything_saveable" or not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    outer = _random.current_generator()
    start = outer.get_state()
    calls = [0]

    def run(*a, **kw):
        replay = calls[0] > 0
        calls[0] += 1
        gen = torch.Generator()
        gen.set_state(start)
        with _random.rng_scope(gen), _replay_scope(replay):
            out = fn(*a, **kw)
        if not replay:
            outer.set_state(gen.get_state())
        return out

    extra = {}
    if resolved is not None and policy != "nothing_saveable":
        extra["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, resolved)
    return _ckpt.checkpoint(run, *args, use_reentrant=False, **extra,
                            **kwargs)
