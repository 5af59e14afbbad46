"""Imperative (dygraph) mode (counterpart of paddle_tpu/dygraph; ref
python/paddle/fluid/dygraph/ ``guard``, ``to_variable``, ``no_grad``).

Tensors are ``torch.Tensor`` and torch autograd is the tape
(``core/tape.py``), so the book's loop runs as written::

    with paddle_tpu_torch.dygraph.guard():
        model = ErnieForSequenceClassification(cfg, num_classes=2)
        opt = AdamW(2e-5, parameters=model.parameters())
        loss = pd.mean(F.cross_entropy(model(ids, types), labels))
        loss.backward(); opt.minimize(loss); model.clear_gradients()

``guard()`` and ``enable_tape()`` turn torch's grad mode on (``guard``
restores it on exit); ``disable_tape()`` turns it off.  Unlike the JAX
package, where the tape records only inside ``guard()``, torch records by
default, so the loop also runs outside one.
"""
from __future__ import annotations

import contextlib

from ..core import tape as _tape
from ..core.tape import backward, enabled  # noqa: F401
from ..core.tape import partial_grad as grad  # noqa: F401
from ..nn.layer.base import Layer, Parameter  # noqa: F401

no_grad = _tape.no_grad_ctx


def enable_tape() -> None:
    """Turn gradient recording (torch's grad mode) on."""
    _tape.enable()


def disable_tape() -> None:
    """Turn gradient recording off (gradients already in ``.grad``
    stay)."""
    _tape.disable()


# paddle 2.0 aliases
enable_dygraph = enable_tape
disable_dygraph = disable_tape


@contextlib.contextmanager
def guard(place=None):
    """ref fluid.dygraph.guard: imperative mode with gradient recording on
    for the block (``place`` is accepted; the current device is
    ``set_device``'s, as the JAX package leaves placement to its default
    device)."""
    del place
    was_on = _tape.enabled()
    _tape.enable()
    try:
        yield
    finally:
        if not was_on:
            _tape.disable()


def to_variable(value, name=None, zero_copy=None, dtype=None):
    """ref fluid.dygraph.to_variable: data -> a tensor on the current
    device."""
    del name, zero_copy
    from ..ops.creation import to_tensor

    return to_tensor(value, dtype=dtype)
