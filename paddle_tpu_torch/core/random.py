"""Random streams (counterpart of paddle_tpu/core/random.py).

The JAX package threads splittable keys; the port threads host-side
``torch.Generator``s.  Every draw that steers a kernel is a Python int taken
from a generator on the CPU, so drawing never waits for the card:

* ``seed(n)`` reseeds the process-global generator;
* ``rng_scope(generator)`` makes ``generator`` the active one for a region
  (the train step opens it with the step's generator, as the JAX package's
  ``functional_call(..., rng=key)`` pushes the step's key);
* ``draw_seed()`` takes one int32 from the active generator (the in-kernel
  dropout seeds);
* ``device_generator(device)`` gives a generator on ``device`` seeded by
  one such draw, for the plain ops that draw their masks with ``torch.rand``
  (the embedding dropout, the plain attention's dropout).
"""
from __future__ import annotations

import threading
from typing import List

import torch

_INT32_MIN = -2 ** 31
_INT32_MAX = 2 ** 31 - 1


class _State(threading.local):
    def __init__(self):
        self.global_generator = torch.Generator().manual_seed(0)
        self.stack: List[torch.Generator] = []


_state = _State()


def seed(value: int) -> None:
    """Reseed the global generator (``paddle.seed``)."""
    _state.global_generator = torch.Generator().manual_seed(int(value))


def current_generator() -> torch.Generator:
    """The innermost active generator, else the global one."""
    return _state.stack[-1] if _state.stack else _state.global_generator


class rng_scope:
    """Make a CPU ``torch.Generator`` the active one inside the block."""

    def __init__(self, generator: torch.Generator):
        if generator.device.type != "cpu":
            raise ValueError("rng_scope takes a CPU torch.Generator: seeds "
                             "are drawn on the host, never from the card")
        self._generator = generator

    def __enter__(self):
        _state.stack.append(self._generator)
        return self._generator

    def __exit__(self, *exc):
        _state.stack.pop()
        return False


def draw_seed() -> int:
    """One signed int32 from the active generator, as a Python int."""
    return int(torch.randint(_INT32_MIN, _INT32_MAX, (1,),
                             generator=current_generator()))


def device_generator(device) -> torch.Generator:
    """A generator on ``device`` seeded from the active generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(draw_seed() & 0xFFFFFFFF)
    return gen
