"""Typed global flags (counterpart of paddle_tpu/core/flags.py).

Only the flags of the ported paths live here, with the JAX package's
names, defaults and env passthrough (``PDTPU_FLAGS_<name>``).  A kernel
flag that is on selects the kernel on CUDA tensors; off selects the plain
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


def get_flags(names=None) -> Dict[str, Any]:
    """{name: value} of ``names`` (one name or a list), else of every
    flag."""
    if names is None:
        return dict(_FLAGS)
    if isinstance(names, str):
        names = [names]
    return {n: get_flag(n) for n in names}


define_flag("use_flash_attention", True, "Use the flash-attention CUDA "
            "kernels on CUDA tensors where the attention semantics allow "
            "it: packed (ops/kernels/flash_attention_packed.py) and "
            "(batch, heads, seq, head_dim) (ops/kernels/flash_attention.py).")
define_flag("use_fused_layer_norm", True, "Use the LayerNorm and the "
            "residual+dropout+LayerNorm CUDA kernels (ops/kernels/"
            "layer_norm.py) on CUDA tensors: one pass over device memory "
            "per call.")
define_flag("use_paged_attention", True, "Use the paged-attention decode "
            "CUDA kernel (ops/kernels/paged_attention.py) in the paged "
            "decoder: one-token attention gathered block by block through "
            "a per-sequence block table, online softmax, in-kernel int8 KV "
            "dequant.  Off: the plain gather + masked softmax on every "
            "device.")
define_flag("use_pallas_conv_fused", True, "Use the fused conv + BN + "
            "activation CUDA kernel (ops/kernels/conv_fused.py) for the "
            "inference fused_conv2d_bn_act op where the JAX package's shape "
            "gate holds: the BN transform a * x + b and the activation as "
            "an epilogue on the conv's output tiles.  Off or refused by the "
            "gate: the weight-space fold and one cuDNN convolution.  In "
            "training mode the flag selects the batch-statistics and scale "
            "+ act kernels (ops/kernels/bn_act_train.py) after the library "
            "conv.  The JAX package's name is kept.")
define_flag("use_pallas_pool", True, "Use the NHWC max / average pooling "
            "CUDA kernel (ops/kernels/pooling.py) where the JAX package's "
            "shape gate holds.  Off or refused by the gate: PyTorch's "
            "pooling.  The JAX package's name is kept.")
define_flag("use_pallas_int8", True, "Run the quant_conv2d / quant_mul "
            "ops (static/ops_fused.py) on the int8 CUDA kernels (ops/"
            "kernels/int8.py) where the JAX package's shape gate holds: "
            "int8 operands, int32 sums, an fp32 per-channel dequant "
            "epilogue.  Off or refused by the gate: the simulate route "
            "(fixed-scale fake quant + the float op), bit for bit the "
            "program before the quant_infer rewrite.  The JAX package's "
            "name is kept.")
define_flag("opt_passes", "", "Graph-rewrite pass pipeline applied to "
            "Programs on the Executor's first run of a (program, feeds, "
            "fetches) key (static/passes.py).  Empty (default): off.  "
            "'1'/'default': the default pipeline (constant_folding, cse, "
            "conv+BN+act and matmul+bias+act fusion, NHWC layout "
            "propagation, dce).  A comma list runs exactly those passes.  "
            "A pipeline that fails its check rolls back to the original "
            "program and counts passes.rollbacks.")
define_flag("metrics", True, "Collect runtime telemetry into the metrics "
            "registry (utils/monitor.py).  Off (PDTPU_FLAGS_metrics=0): "
            "instrumented paths still run but record nothing.")
