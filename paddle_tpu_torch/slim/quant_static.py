"""Static quantization: the QAT program rewrites and post-training
quantization (counterpart of paddle_tpu/slim/quant_static.py).

Reference parity: ``fluid/contrib/slim/quantization/quantization_pass.py``.
``QuantizationTransformPass`` inserts trainable fake-quant-dequant ops
ahead of every quantizable op's inputs: channel-wise abs-max on the
weights, moving-average abs-max on the activations, whose EMA scale is a
persistable variable the op updates each step like an optimizer slot.
The ops' gradients are straight-through (static/ops_tail.py).
``QuantizationFreezePass`` folds a trained program: the weights become
their int8-simulated values in the scope, with per-channel
``weight_scale`` / ``weight_bits`` on their consumer op, and the
activation ops become fixed-scale quant-dequant at the trained scale;
the form PTQ leaves, which ``quant_infer`` turns into the int8 ops.

``post_training_quantization.py``: calibration batches
collect the abs-max of every quantizable op's activation inputs, then the
program is rewritten with fixed-scale quant-dequant ops on those inputs and
the weights are replaced in the scope by their int8-simulated values
(channel-wise, on the output-channel axis of slim/quant.py), with
``weight_scale`` / ``weight_bits`` attrs on the op.  The ``quant_infer``
pass (static/passes.py) then folds these artifacts into ``quant_conv2d`` /
``quant_mul``.

Both routes are ported: ``program=``, and ``model_prefix=``, which loads a
program and its state saved by ``static.save`` (``static.io.load``), as
``save_quantized_model`` writes them.
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


def _int8_simulated(w: np.ndarray, qaxis: int, bits: int):
    """(``w`` rounded to its per-channel ``bits``-bit grid, the abs-max
    scales) over every axis but ``qaxis``."""
    qmax = float(2 ** (bits - 1) - 1)
    red = tuple(i for i in range(w.ndim) if i != qaxis)
    scale = np.maximum(np.abs(w).max(axis=red), 1e-8)
    rs_shape = [1] * w.ndim
    rs_shape[qaxis] = -1
    rs = scale.reshape(rs_shape)
    return (np.round(w / rs * qmax) / qmax * rs).astype(w.dtype), scale


def _set_like(scope, name, value: np.ndarray, like) -> None:
    """Store ``value`` under ``name`` as ``like`` is stored: a tensor on
    its device and in its dtype, or a numpy array."""
    if isinstance(like, torch.Tensor):
        value = torch.from_numpy(value).to(device=like.device,
                                           dtype=like.dtype)
    scope.set(name, value)


class QuantizationTransformPass:
    """Insert trainable fake-quant-dequant ops (ref quantization_pass.py
    ``QuantizationTransformPass.apply``): channel-wise abs-max on weights,
    moving-average abs-max (persistable scale state, initialised to 0 by
    ``startup_program``) on activations.  The op list and variable names
    are the JAX package's."""

    def __init__(self, scope=None, place=None, weight_bits: int = 8,
                 activation_bits: int = 8,
                 activation_quantize_type: str = "moving_average_abs_max",
                 weight_quantize_type: str = "channel_wise_abs_max",
                 moving_rate: float = 0.9,
                 quantizable_op_type: Sequence[str] = tuple(_QUANTIZABLE)):
        del scope, place  # state lives in the program's scope vars
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.act_type = activation_quantize_type
        self.weight_type = weight_quantize_type
        self.moving_rate = moving_rate
        self.op_types = set(quantizable_op_type)

    def apply(self, program: Program,
              startup_program: Optional[Program] = None) -> Program:
        block = program.global_block()
        quantized: Dict[str, str] = {}  # var name -> qdq output name
        new_ops: List[Operator] = []
        for op in block.ops:
            if op.type in self.op_types and op.type in _QUANTIZABLE:
                wslot, aslots = _QUANTIZABLE[op.type]
                for slot in (wslot,) + tuple(aslots):
                    for i, name in enumerate(op.inputs.get(slot, [])):
                        qname = quantized.get(name)
                        if qname is None:
                            if _is_param(block, name):
                                qname = self._insert_weight_quant(
                                    block, new_ops, name,
                                    op.type if slot == wslot else "conv2d")
                            else:
                                qname = self._insert_act_quant(
                                    block, new_ops, name, startup_program)
                            quantized[name] = qname
                        op.inputs[slot][i] = qname
            new_ops.append(op)
        block.set_ops(new_ops)
        return program

    def _insert_weight_quant(self, block, new_ops, name: str,
                             consumer_type: str = "conv2d") -> str:
        v = block.var(name)
        out = block.create_var(name=f"{name}.quantized", shape=v.shape,
                               dtype=v.dtype)
        if self.weight_type == "channel_wise_abs_max":
            # per-OUTPUT-channel scales (the scale-axis contract of
            # slim/quant.py)
            qaxis = weight_quant_axis(consumer_type, v.ndim)
            n_scale = v.shape[qaxis] if v.ndim else 1
            scale = block.create_var(name=f"{name}.quant_scale",
                                     shape=(n_scale,), dtype="float32")
            new_ops.append(Operator(
                block, "fake_channel_wise_quantize_dequantize_abs_max",
                {"X": [name]}, {"Out": [out.name], "OutScale": [scale.name]},
                {"bit_length": self.weight_bits, "quant_axis": qaxis}))
        else:  # abs_max
            scale = block.create_var(name=f"{name}.quant_scale", shape=(1,),
                                     dtype="float32")
            new_ops.append(Operator(
                block, "fake_quantize_dequantize_abs_max",
                {"X": [name]}, {"Out": [out.name], "OutScale": [scale.name]},
                {"bit_length": self.weight_bits}))
        return out.name

    def _insert_act_quant(self, block, new_ops, name: str,
                          startup_program) -> str:
        v = block.var(name)
        out = block.create_var(name=f"{name}.quantized", shape=v.shape,
                               dtype=v.dtype)
        state_name = f"{name}@quant_moving_scale"
        block.create_var(name=state_name, shape=(1,), dtype="float32",
                         persistable=True)
        if startup_program is not None:
            sb = startup_program.global_block()
            sb.create_var(name=state_name, shape=(1,), dtype="float32",
                          persistable=True)
            sb.append_op("fill_constant", outputs={"Out": [state_name]},
                         attrs={"shape": (1,), "dtype": "float32",
                                "value": 0.0})
        # OutScale writes back to the state var: a persistable updated in
        # place each step, the optimizer-slot pattern
        new_ops.append(Operator(
            block, "fake_quantize_dequantize_moving_average_abs_max",
            {"X": [name], "InScale": [state_name]},
            {"Out": [out.name], "OutScale": [state_name]},
            {"bit_length": self.activation_bits,
             "moving_rate": self.moving_rate}))
        return out.name


class QuantizationFreezePass:
    """Fold trained quantization into the program (ref
    quantization_pass.py ``QuantizationFreezePass``): weights become their
    int8-simulated values in ``scope`` with per-channel scales recorded on
    the consumer op; moving-average activation quant ops become
    fixed-scale quant-dequant at the trained scale.  Mutates the program
    and the scope's weights in place."""

    def __init__(self, scope, place=None, weight_bits: int = 8,
                 activation_bits: int = 8):
        self.scope = scope
        del place
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits

    def apply(self, program: Program) -> Program:
        block = program.global_block()
        renames: Dict[str, str] = {}
        scales: Dict[str, np.ndarray] = {}
        kept: List[Operator] = []
        for op in block.ops:
            if op.type == "fake_channel_wise_quantize_dequantize_abs_max" \
                    and _is_param(block, op.inputs["X"][0]):
                wname = op.inputs["X"][0]
                value = self.scope.find_var(wname)
                w = to_numpy(value)
                qaxis = int(op.attrs.get("quant_axis", 0)) % max(w.ndim, 1)
                wq, scales[wname] = _int8_simulated(w, qaxis,
                                                    self.weight_bits)
                _set_like(self.scope, wname, wq, value)
                renames[op.outputs["Out"][0]] = wname
                continue  # drop the op: the weight is int8-simulated now
            if op.type == "fake_quantize_dequantize_moving_average_abs_max":
                state = to_numpy(self.scope.find_var(op.inputs["InScale"][0]))
                op.type = "fake_quantize_dequantize_fixed_scale"
                op.attrs = {"bit_length": self.activation_bits,
                            "scale": float(state.reshape(-1)[0])}
                op.inputs.pop("InScale", None)
                op.outputs.pop("OutScale", None)
            kept.append(op)
        for op in kept:  # rewire consumers of dropped weight-qdq outputs
            for slot, names in op.inputs.items():
                op.inputs[slot] = [renames.get(n, n) for n in names]
            wslot = _QUANTIZABLE.get(op.type, (None,))[0]
            if wslot and op.inputs.get(wslot):
                wname = op.inputs[wslot][0]
                if wname in scales:
                    op.attrs["weight_scale"] = scales[wname].tolist()
                    op.attrs["weight_bits"] = self.weight_bits
        block.set_ops(kept)
        return program


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
        self.exe = executor
        self.scope = scope or global_scope()
        if program is None:
            if model_prefix is None:
                raise ValueError("pass model_prefix or program")
            from ..static import io as static_io

            program, feeds, _ = static_io.load(model_prefix, executor,
                                               scope=self.scope)
            if not feed_names:
                feed_names = feeds
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
        sim, scale = _int8_simulated(w, weight_quant_axis(op_type, w.ndim),
                                     self.weight_bits)
        _set_like(self.scope, wname, sim, value)
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

    def save_quantized_model(self, model_prefix: str) -> None:
        """The quantized program and its state as ``static.save`` writes
        them (``<prefix>.pdmodel`` / ``<prefix>.pdparams``, the JAX
        package's format); ``static.load`` or ``model_prefix=`` read it
        back."""
        from ..static import io as static_io

        static_io.save(self.program, model_prefix, self.exe,
                       scope=self.scope)
