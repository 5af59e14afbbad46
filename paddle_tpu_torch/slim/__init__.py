"""paddle_tpu_torch.slim — model compression (counterpart of
paddle_tpu.slim): static quantization to int8.

Ported: the scale-axis contract, the fake-quant functions and
``quant_int8`` (``quant``); the static QAT passes
``QuantizationTransformPass`` / ``QuantizationFreezePass`` and
``PostTrainingQuantization`` over a Program (``quant_static``).  Still to
port (ROADMAP): the dygraph QAT (``ImperativeQuantAware`` and the
quantized layers), the dygraph PTQ and ``Int8Linear``.
"""
from . import quant_static
from .quant import (conv_quant_axis, fake_channel_wise_quant_dequant_abs_max,
                    fake_quant_dequant_abs_max,
                    fake_quant_dequant_moving_average_abs_max, quant_int8,
                    weight_quant_axis)
from .quant_static import (PostTrainingQuantization, QuantizationFreezePass,
                           QuantizationTransformPass)

__all__ = ["quant_static", "PostTrainingQuantization",
           "QuantizationFreezePass", "QuantizationTransformPass",
           "conv_quant_axis", "fake_channel_wise_quant_dequant_abs_max",
           "fake_quant_dequant_abs_max",
           "fake_quant_dequant_moving_average_abs_max", "quant_int8",
           "weight_quant_axis"]
