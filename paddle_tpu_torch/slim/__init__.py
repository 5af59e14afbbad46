"""paddle_tpu_torch.slim -- model compression (counterpart of
paddle_tpu.slim): quantization to int8.

``quant``: the scale-axis contract, the fake-quant functions and
``quant_int8``; the dygraph QAT (``ImperativeQuantAware``,
``QuantizedLinear``, ``QuantizedConv2D``) and PTQ
(``PostTrainingQuantization``, ``Int8Linear``).  ``quant_static``: the
static QAT passes ``QuantizationTransformPass`` /
``QuantizationFreezePass`` and the static ``PostTrainingQuantization`` over
a Program.  As in the JAX package, ``slim.PostTrainingQuantization`` is
the dygraph one.
"""
from . import quant_static
from .quant import (ImperativeQuantAware, Int8Linear,
                    PostTrainingQuantization, QuantizedConv2D,
                    QuantizedLinear, conv_quant_axis,
                    fake_channel_wise_quant_dequant_abs_max,
                    fake_quant_dequant_abs_max,
                    fake_quant_dequant_moving_average_abs_max, quant_int8,
                    weight_quant_axis)
from .quant_static import QuantizationFreezePass, QuantizationTransformPass

__all__ = ["quant_static", "ImperativeQuantAware", "Int8Linear",
           "PostTrainingQuantization", "QuantizedConv2D", "QuantizedLinear",
           "QuantizationFreezePass", "QuantizationTransformPass",
           "conv_quant_axis", "fake_channel_wise_quant_dequant_abs_max",
           "fake_quant_dequant_abs_max",
           "fake_quant_dequant_moving_average_abs_max", "quant_int8",
           "weight_quant_axis"]
