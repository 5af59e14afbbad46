"""Typed global flags (counterpart of paddle_tpu/core/flags.py).

Only the two kernel flags of the ported path live here, with the JAX
package's names, defaults and env passthrough (``PDTPU_FLAGS_<name>``).
A flag that is on selects the kernel on CUDA tensors; off selects the plain
PyTorch composition on every device.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict

_lock = threading.Lock()
_FLAGS: Dict[str, Any] = {}
_DEFS: Dict[str, tuple] = {}  # name -> (default, type, help)

_ENV_PREFIX = "PDTPU_FLAGS_"
_TRUE_STRINGS = frozenset(("1", "true", "yes", "on"))
_FALSE_STRINGS = frozenset(("0", "false", "no", "off", ""))


def _coerce(name: str, value, type_: Callable):
    if type_ is bool and isinstance(value, str):
        low = value.lower()
        if low in _TRUE_STRINGS:
            return True
        if low in _FALSE_STRINGS:
            return False
        raise ValueError(
            f"flag {name!r}: cannot parse {value!r} as bool (use one of "
            f"{sorted(_TRUE_STRINGS | _FALSE_STRINGS)})")
    return type_(value)


def define_flag(name: str, default, help: str = "", type_: Callable = None):
    type_ = type_ or type(default)
    _DEFS[name] = (default, type_, help)
    env = os.environ.get(_ENV_PREFIX + name)
    _FLAGS[name] = default if env is None else _coerce(name, env, type_)


def get_flag(name: str):
    try:
        return _FLAGS[name]
    except KeyError:
        raise KeyError(f"Unknown flag {name!r}; known: {sorted(_FLAGS)}") from None


def set_flags(flags: Dict[str, Any]):
    with _lock:
        for name, value in flags.items():
            if name not in _FLAGS:
                raise KeyError(f"Unknown flag {name!r}; known: {sorted(_FLAGS)}")
            _, type_, _ = _DEFS[name]
            if value is not None and not isinstance(value, type_):
                value = _coerce(name, value, type_)
            _FLAGS[name] = value


define_flag("use_flash_attention", True, "Use the packed flash-attention "
            "CUDA kernel (ops/kernels/flash_attention_packed.py) on CUDA "
            "tensors where the attention semantics allow it.")
define_flag("use_fused_layer_norm", True, "Use the LayerNorm and the "
            "residual+dropout+LayerNorm CUDA kernels (ops/kernels/"
            "layer_norm.py) on CUDA tensors: one pass over device memory "
            "per call.")
