"""Places and the current device (counterpart of paddle_tpu/core/device.py).

The port runs on the card unless the caller asks for the CPU: the current
device is CUDA until ``set_device("cpu")`` (or a ``device_guard``) says
otherwise, ``None`` resolves to the current device, and asking for CUDA
where there is none raises.  Nothing here quietly builds on the CPU.

A ``Place`` is a hashable handle on a ``torch.device``.  ``TPUPlace`` is
kept as an alias of ``CUDAPlace``: in the port the accelerator is the card.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch


class Place:
    """A device handle: ``CUDAPlace(0)``, ``CPUPlace()``."""

    _type = ""

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def get_device(self) -> torch.device:
        return torch.device(self._type, self.device_id)

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"


class CPUPlace(Place):
    _type = "cpu"

    def get_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    _type = "cuda"


TPUPlace = CUDAPlace

_NAMES = {"cpu": CPUPlace, "gpu": CUDAPlace, "cuda": CUDAPlace,
          "tpu": CUDAPlace, "xpu": CUDAPlace}


class _Current(threading.local):
    def __init__(self):
        self.place: Optional[Place] = None


_current = _Current()


def _to_place(place) -> Place:
    if isinstance(place, Place):
        return place
    if isinstance(place, torch.device):
        place = str(place)
    if isinstance(place, str):
        name, _, idx = place.partition(":")
        cls = _NAMES.get(name)
        if cls is None:
            raise ValueError(f"Unknown device string {place!r}")
        return cls(int(idx) if idx else 0)
    raise TypeError(f"not a place: {place!r}")


def set_device(place) -> Place:
    """Set the current place: a ``Place``, a ``torch.device`` or a string
    (``"cpu"``, ``"gpu"``, ``"gpu:1"``, ``"cuda"``, ``"tpu"``).  Returns
    the place."""
    p = _to_place(place)
    _current.place = p
    return p


def get_device() -> Place:
    """The current place: ``CUDAPlace(0)`` until ``set_device`` says
    otherwise."""
    return _current.place if _current.place is not None else CUDAPlace(0)


def is_compiled_with_tpu() -> bool:
    """Whether an accelerator (here: a CUDA card) is present."""
    return torch.cuda.is_available()


@contextlib.contextmanager
def device_guard(place):
    """Scoped current-place override (ref: fluid.device_guard)."""
    prev = _current.place
    try:
        set_device(place)
        yield
    finally:
        _current.place = prev


def resolve_device(device=None) -> torch.device:
    """``device`` (a ``torch.device``, a string or a ``Place``) as a
    ``torch.device``; None means the current device.  CUDA where there is
    no card raises."""
    if device is None:
        device = get_device()
    if isinstance(device, Place):
        device = device.get_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (or call set_device('cpu')) to run "
            "the plain PyTorch path")
    return dev
