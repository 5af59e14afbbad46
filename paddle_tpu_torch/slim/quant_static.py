"""Static post-training quantization (counterpart of
paddle_tpu/slim/quant_static.py ``PostTrainingQuantization``).

Reference parity: ``post_training_quantization.py`` — calibration batches
collect the abs-max of every quantizable op's activation inputs, then the
program is rewritten with fixed-scale quant-dequant ops on those inputs and
the weights are replaced in the scope by their int8-simulated values
(channel-wise, on the output-channel axis of slim/quant.py), with
``weight_scale`` / ``weight_bits`` attrs on the op.  The ``quant_infer``
pass (static/passes.py) then folds these artifacts into ``quant_conv2d`` /
``quant_mul``.

Ported: the ``program=`` route.  The ``model_prefix`` route loads a saved
program with ``static.io``, which is not ported yet (ROADMAP), and raises.
The QAT passes (``QuantizationTransformPass`` / ``QuantizationFreezePass``)
are not ported yet either.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..static.executor import global_scope, to_numpy
from ..static.framework import Operator, Parameter, Program
from .quant import weight_quant_axis

# op type -> (weight slot, activation slots) (ref
# QuantizationTransformPass._quantizable_ops + op IO conventions)
_QUANTIZABLE: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "conv2d": ("Filter", ("Input",)),
    "depthwise_conv2d": ("Filter", ("Input",)),
    "conv3d": ("Filter", ("Input",)),
    "mul": ("Y", ("X",)),
    "matmul": ("Y", ("X",)),
    "matmul_v2": ("Y", ("X",)),
}


def _is_param(block, name: str) -> bool:
    try:
        return isinstance(block.var(name), Parameter)
    except KeyError:
        return False


class PostTrainingQuantization:
    """PTQ of a program (ref post_training_quantization.py): run
    ``batch_nums`` calibration batches through ``executor`` collecting the
    abs-max at every quantizable op's activation inputs, then rewrite with
    fixed-scale quant-dequant ops and int8-simulated weights.  Mutates the
    program and the scope's weights in place."""

    def __init__(self, executor, model_prefix: Optional[str] = None,
                 program: Optional[Program] = None,
                 feed_names: Optional[Sequence[str]] = None,
                 batch_generator=None, batch_nums: Optional[int] = None,
                 weight_bits: int = 8, activation_bits: int = 8,
                 quantizable_op_type: Sequence[str] = tuple(_QUANTIZABLE),
                 scope=None):
        if program is None:
            if model_prefix is None:
                raise ValueError("pass model_prefix or program")
            raise NotImplementedError(
                "PostTrainingQuantization(model_prefix=...) loads a saved "
                "program with static.io, which paddle_tpu_torch does not "
                "port yet; pass program= (and feed_names=) instead")
        self.exe = executor
        self.scope = scope or global_scope()
        self.program = program
        self.feed_names = list(feed_names or [])
        self.batch_generator = batch_generator
        self.batch_nums = batch_nums
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.op_types = set(quantizable_op_type)
        self._act_scales: Dict[str, float] = {}

    def _activation_vars(self) -> List[str]:
        block = self.program.global_block()
        names: List[str] = []
        for op in block.ops:
            if op.type in self.op_types and op.type in _QUANTIZABLE:
                _, aslots = _QUANTIZABLE[op.type]
                for slot in aslots:
                    for n in op.inputs.get(slot, []):
                        if not _is_param(block, n) and n not in names:
                            names.append(n)
        return names

    def _calibrate(self, act_vars: List[str]) -> None:
        for bi, batch in enumerate(self.batch_generator()):
            if self.batch_nums is not None and bi >= self.batch_nums:
                break
            feed = (batch if isinstance(batch, dict)
                    else dict(zip(self.feed_names, batch)))
            outs = self.exe.run(self.program, feed=feed, fetch_list=act_vars,
                                scope=self.scope)
            for name, arr in zip(act_vars, outs):
                cur = float(np.abs(np.asarray(arr)).max())
                self._act_scales[name] = max(
                    self._act_scales.get(name, 0.0), cur)

    def _simulate_weight(self, op_type: str, wname: str) -> List[float]:
        """Replace the weight in the scope by its int8-simulated value;
        return its per-channel abs-max scales."""
        value = self.scope.find_var(wname)
        w = to_numpy(value)
        qmax = float(2 ** (self.weight_bits - 1) - 1)
        qaxis = weight_quant_axis(op_type, w.ndim)
        red = tuple(i for i in range(w.ndim) if i != qaxis)
        scale = np.maximum(np.abs(w).max(axis=red), 1e-8)
        rs_shape = [1] * w.ndim
        rs_shape[qaxis] = -1
        rs = scale.reshape(rs_shape)
        sim = (np.round(w / rs * qmax) / qmax * rs).astype(w.dtype)
        if isinstance(value, torch.Tensor):
            sim = torch.from_numpy(sim).to(device=value.device,
                                           dtype=value.dtype)
        self.scope.set(wname, sim)
        return scale.tolist()

    def quantize(self) -> Program:
        act_vars = self._activation_vars()
        if self.batch_generator is not None and act_vars:
            self._calibrate(act_vars)
        block = self.program.global_block()
        new_ops: List[Operator] = []
        quantized: Dict[str, str] = {}
        done_weights = set()
        for op in block.ops:
            if op.type in self.op_types and op.type in _QUANTIZABLE:
                wslot, aslots = _QUANTIZABLE[op.type]
                for wname in op.inputs.get(wslot, []):
                    if _is_param(block, wname) and wname not in done_weights:
                        op.attrs["weight_scale"] = self._simulate_weight(
                            op.type, wname)
                        op.attrs["weight_bits"] = self.weight_bits
                        done_weights.add(wname)
                for slot in aslots:
                    for i, name in enumerate(op.inputs.get(slot, [])):
                        if _is_param(block, name) \
                                or name not in self._act_scales:
                            continue  # a weight, or never observed
                        qname = quantized.get(name)
                        if qname is None:
                            v = block.var(name)
                            out = block.create_var(
                                name=f"{name}.quantized", shape=v.shape,
                                dtype=v.dtype)
                            new_ops.append(Operator(
                                block, "fake_quantize_dequantize_fixed_scale",
                                {"X": [name]}, {"Out": [out.name]},
                                {"bit_length": self.activation_bits,
                                 "scale": self._act_scales[name]}))
                            qname = quantized[name] = out.name
                        op.inputs[slot][i] = qname
            new_ops.append(op)
        block.set_ops(new_ops)
        return self.program
