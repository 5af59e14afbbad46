"""Functional ops of the port (counterpart of paddle_tpu.nn.functional)."""
from ...ops.attention import flash_attention, scaled_dot_product_attention
from .activation import (celu, elu, gelu, glu, hardshrink, hardsigmoid,
                         hardswish, hardtanh, leaky_relu, log_sigmoid,
                         log_softmax, mish, prelu, relu, relu6, selu,
                         sigmoid, silu, softmax, softplus, softshrink,
                         softsign, swish, tanh, tanhshrink)
from .common import dropout, linear
from .conv import conv2d
from .input import embedding
from .loss import (binary_cross_entropy, binary_cross_entropy_with_logits,
                   cross_entropy, hinge_loss, kl_div, l1_loss, log_loss,
                   margin_ranking_loss, mse_loss, nll_loss,
                   smooth_l1_loss, softmax_with_cross_entropy,
                   square_error_cost)
from .norm import batch_norm, bn_inference_scale_bias, layer_norm
from .pooling import (adaptive_avg_pool2d, adaptive_max_pool2d, avg_pool1d,
                      avg_pool2d, max_pool1d, max_pool2d)

__all__ = ["celu", "elu", "gelu", "glu", "hardshrink", "hardsigmoid",
           "hardswish", "hardtanh", "leaky_relu", "log_sigmoid",
           "log_softmax", "mish", "prelu", "relu", "relu6", "selu",
           "sigmoid", "silu", "softmax", "softplus", "softshrink",
           "softsign", "swish", "tanh", "tanhshrink", "dropout", "linear", "conv2d", "embedding",
           "cross_entropy", "softmax_with_cross_entropy", "nll_loss",
           "mse_loss", "square_error_cost", "l1_loss", "smooth_l1_loss",
           "binary_cross_entropy", "binary_cross_entropy_with_logits",
           "kl_div", "log_loss", "hinge_loss", "margin_ranking_loss", "batch_norm",
           "bn_inference_scale_bias", "layer_norm", "max_pool1d",
           "max_pool2d", "avg_pool1d", "avg_pool2d", "adaptive_avg_pool2d",
           "adaptive_max_pool2d", "flash_attention",
           "scaled_dot_product_attention"]
