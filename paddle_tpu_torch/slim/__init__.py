"""paddle_tpu_torch.slim — model compression (counterpart of
paddle_tpu.slim): static post-training quantization to int8.

Ported: the scale-axis contract and ``quant_int8`` (``quant``), and the
static ``PostTrainingQuantization`` over a Program (``quant_static``).
Still to port (ROADMAP): the QAT passes and fake-quant layers, the
dygraph PTQ and ``Int8Linear``.
"""
from . import quant_static
from .quant import conv_quant_axis, quant_int8, weight_quant_axis
from .quant_static import PostTrainingQuantization

__all__ = ["quant_static", "PostTrainingQuantization", "conv_quant_axis",
           "quant_int8", "weight_quant_axis"]
