"""Kernel bookkeeping shared by the wrappers (counterpart of
paddle_tpu/ops/pallas/config.py).

* **Launch counts.** Each wrapper calls ``record_call(name)`` exactly where
  it launches its CUDA kernel, and nowhere else, so a run can prove that a
  path went through the kernels.  A call on CPU tensors runs the plain
  version and counts nothing.
* **Fingerprint.** ``fingerprint()`` names the effective kernel set (flag
  on and a CUDA device present), for logs and result lines.
* **Weight layouts.** ``cached_layout`` keeps a weight's kernel layout on
  the weight per version, so repeated calls do not copy it again.

There is no interpret mode and no fallback counter: on a CUDA tensor a
wrapper launches its kernel or raises.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable, Dict, Tuple

import torch

from ...core import flags

_SCHEMA = 1


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One ported kernel: its launch-count name, its ``csrc/<source>.cu``,
    the TPU function it replaces, its wrapper (kernel on CUDA tensors,
    plain version on CPU tensors) and its plain PyTorch version."""
    name: str
    source: str
    replaces: str
    wrapper: Callable
    plain: Callable

# (short tag, flag name) for every ported kernel family, sorted by tag.
_KERNEL_FLAGS: Tuple[Tuple[str, str], ...] = (
    ("conv", "use_pallas_conv_fused"),
    ("fa", "use_flash_attention"),
    ("int8", "use_pallas_int8"),
    ("ln", "use_fused_layer_norm"),
    ("pgat", "use_paged_attention"),
    ("pool", "use_pallas_pool"),
)

_lock = threading.Lock()
_counts: Dict[str, int] = collections.Counter()


def record_call(kernel: str) -> None:
    with _lock:
        _counts[kernel] += 1


def launch_counts() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def reset_counts() -> None:
    with _lock:
        _counts.clear()


def cached_layout(w, attr: str, make: Callable):
    """``make(w)`` (detached, made contiguous), made once per version and
    storage of ``w`` and kept on ``w`` itself under ``attr``, so it lives as
    long as the weight: a wrapper's weight laid out for its kernel."""
    key = (w._version, w.data_ptr())
    hit = getattr(w, attr, None)
    if hit is not None and hit[0] == key:
        return hit[1]
    wk = make(w.detach()).contiguous()
    setattr(w, attr, (key, wk))
    return wk


def kernel_enabled(flag_name: str) -> bool:
    return bool(flags.get_flag(flag_name)) and torch.cuda.is_available()


def fingerprint() -> str:
    """Effective kernel set, e.g.
    ``tk1:conv=1,fa=1,int8=1,ln=1,pgat=1,pool=1``
    (all zero off CUDA)."""
    bits = ",".join(f"{tag}={int(kernel_enabled(name))}"
                    for tag, name in _KERNEL_FLAGS)
    return f"tk{_SCHEMA}:{bits}"
