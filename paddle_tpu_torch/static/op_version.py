"""Op version registry: checkpoint/program compatibility across op changes
(counterpart of paddle_tpu/static/op_version.py, pure Python, copied).

Reference parity: ``paddle/fluid/framework/op_version_registry.h`` —
``REGISTER_OP_VERSION(op).AddCheckpoint(note, changes...)`` records each
op's version history; saved programs carry the op-version map and loaders
compare it against the running registry (``op_version_proto``,
``save/load`` compatibility checks).

The registry also carries optional CONVERTERS — pure
functions upgrading a saved op's ``(inputs, outputs, attrs)`` dicts from
version N to N+1 — so ``static.load`` doesn't merely detect skew, it
migrates old packages forward at load time (the part the reference leaves
to manual release notes).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["register_op_version", "op_version", "op_version_map",
           "apply_converters", "check_compatible", "OpVersionDesc"]


class OpVersionDesc:
    __slots__ = ("version", "note", "converter")

    def __init__(self, version: int, note: str,
                 converter: Optional[Callable] = None):
        self.version = version
        self.note = note
        # converter(inputs: dict, outputs: dict, attrs: dict) -> same
        # triple, upgrading FROM version-1 TO version
        self.converter = converter


# op_type -> ordered checkpoints (versions 1..n; absent = version 0)
_REGISTRY: Dict[str, List[OpVersionDesc]] = {}


def register_op_version(op_type: str, note: str,
                        converter: Optional[Callable] = None) -> int:
    """Add a checkpoint to ``op_type``'s history (ref AddCheckpoint);
    returns the new current version."""
    cps = _REGISTRY.setdefault(op_type, [])
    cps.append(OpVersionDesc(len(cps) + 1, note, converter))
    return len(cps)


def op_version(op_type: str) -> int:
    return len(_REGISTRY.get(op_type, ()))


def op_version_map() -> Dict[str, int]:
    """Current {op_type: version} for every versioned op — what ``save``
    stamps into the package (ref op_version_proto pb map)."""
    return {t: len(cps) for t, cps in _REGISTRY.items()}


def apply_converters(op_type: str, saved_version: int, inputs: dict,
                     outputs: dict, attrs: dict
                     ) -> Tuple[dict, dict, dict]:
    """Upgrade one op desc from ``saved_version`` to the current version,
    running each checkpoint's converter in order.  A checkpoint without a
    converter is a semantic note only (reference behavior: detection, no
    migration) and passes the desc through unchanged."""
    for desc in _REGISTRY.get(op_type, ())[saved_version:]:
        if desc.converter is not None:
            inputs, outputs, attrs = desc.converter(inputs, outputs, attrs)
    return inputs, outputs, attrs


def check_compatible(saved_map: Dict[str, int]) -> List[str]:
    """Problems loading a package saved with ``saved_map``: ops saved with
    a NEWER version than this runtime knows (forward-incompatible)."""
    problems = []
    for op_type, v in saved_map.items():
        cur = op_version(op_type)
        if v > cur:
            problems.append(
                f"op {op_type!r} was saved at version {v} but this runtime "
                f"knows version {cur} — upgrade the package to load it")
    return problems


# -- seeded history (mirrors reference op_version.yaml-era checkpoints for
#    ops whose semantics changed across this rebuild's rounds) --------------

def _seq_pad_rename(inputs, outputs, attrs):
    # round-3 packages used attr "max_len"; current op takes "maxlen"
    if "max_len" in attrs and "maxlen" not in attrs:
        attrs = dict(attrs)
        attrs["maxlen"] = attrs.pop("max_len")
    return inputs, outputs, attrs


register_op_version(
    "sequence_pad",
    "rename attr max_len -> maxlen (dense-layout contract)",
    _seq_pad_rename)
register_op_version(
    "multiclass_nms",
    "drop the unproduced Index output slot (executor binds Out/NmsRoisNum)",
    lambda i, o, a: (i, {k: v for k, v in o.items() if k != "Index"}, a))
register_op_version(
    "linspace",
    "Num moved from a (traced) input tensor to the static attr 'num'")
