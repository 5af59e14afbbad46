"""Activation recompute (counterpart of paddle_tpu/autograd ``recompute``
and ``checkpoint_policy``).  The tape, ``no_grad`` and ``functional_call``
of the JAX package's autograd are not ported here: the port uses torch's
autograd and ``torch.func.functional_call``.

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

__all__ = ["recompute", "checkpoint_policy", "replaying"]

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
