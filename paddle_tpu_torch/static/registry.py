"""Op lowering registry: op type -> torch rule (counterpart of
paddle_tpu/static/registry.py).

Reference parity: the op registry (paddle/fluid/framework/op_registry.h:223
REGISTER_OPERATOR).  An op's "kernel" is a *lowering rule* the Executor
calls op by op: it receives ``{slot: [tensors]}`` plus attrs and returns
``{slot: [tensors]}``.
"""
from __future__ import annotations

import difflib
from typing import Any, Callable, Dict, List, Optional, Sequence

Lowering = Callable[..., Dict[str, List[Any]]]

_REGISTRY: Dict[str, Lowering] = {}


def register_op(type_name: str):
    """Decorator: register `fn(inputs, attrs, op) -> outputs_by_slot`."""

    def deco(fn: Lowering) -> Lowering:
        if type_name in _REGISTRY:
            raise ValueError(f"op {type_name!r} registered twice")
        _REGISTRY[type_name] = fn
        return fn

    return deco


def get_lowering(type_name: str) -> Lowering:
    try:
        return _REGISTRY[type_name]
    except KeyError:
        from ..core.errors import UnimplementedError

        suggestion = suggest_names(type_name)
        raise UnimplementedError(
            f"no lowering registered for op type {type_name!r} "
            f"({len(_REGISTRY)} ops registered)"
            + (f"; {suggestion}" if suggestion else "")) from None


def suggest_names(name: str, candidates: Optional[Sequence[str]] = None,
                  n: int = 3) -> Optional[str]:
    """Nearest-name hint for a miss against `candidates` (default: the
    registry)."""
    pool = list(_REGISTRY) if candidates is None else list(candidates)
    close = difflib.get_close_matches(name, pool, n=n, cutoff=0.6)
    if not close:
        return None
    return "did you mean " + " / ".join(repr(c) for c in close) + "?"


def is_registered(type_name: str) -> bool:
    return type_name in _REGISTRY


def registered_ops() -> List[str]:
    return sorted(_REGISTRY)
