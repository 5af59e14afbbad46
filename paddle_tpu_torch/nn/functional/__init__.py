"""Functional ops of the port (counterpart of paddle_tpu.nn.functional)."""
from ...ops.attention import flash_attention, scaled_dot_product_attention
from .activation import (celu, elu, gelu, glu, hardshrink, hardsigmoid,
                         hardswish, hardtanh, leaky_relu, log_sigmoid,
                         log_softmax, mish, prelu, relu, relu6, selu,
                         sigmoid, silu, softmax, softplus, softshrink,
                         softsign, swish, tanh, tanhshrink)
from .common import (cosine_similarity, dropout, dropout2d, interpolate,
                     linear, pad, unfold, upsample)
from .conv import (conv1d, conv2d, conv2d_transpose, conv3d,
                   conv3d_transpose)
from .input import embedding, one_hot
from .loss import (binary_cross_entropy, binary_cross_entropy_with_logits,
                   cross_entropy, ctc_loss, hinge_loss, kl_div, l1_loss,
                   log_loss, margin_ranking_loss, mse_loss, nll_loss,
                   smooth_l1_loss, softmax_with_cross_entropy,
                   square_error_cost)
from .norm import (batch_norm, bn_inference_scale_bias, group_norm,
                   instance_norm, layer_norm, normalize, rms_norm)
from .pooling import (adaptive_avg_pool2d, adaptive_avg_pool3d,
                      adaptive_max_pool2d, avg_pool1d, avg_pool2d, avg_pool3d,
                      max_pool1d, max_pool2d, max_pool3d)
from .rnn import birnn, rnn

# The JAX package's functional names not ported yet: none.
_DEFERRED = ()

__all__ = ["celu", "elu", "gelu", "glu", "hardshrink", "hardsigmoid",
           "hardswish", "hardtanh", "leaky_relu", "log_sigmoid",
           "log_softmax", "mish", "prelu", "relu", "relu6", "selu",
           "sigmoid", "silu", "softmax", "softplus", "softshrink",
           "softsign", "swish", "tanh", "tanhshrink", "dropout", "dropout2d",
           "linear", "pad", "interpolate", "upsample", "cosine_similarity",
           "unfold", "conv1d", "conv2d", "conv3d", "conv2d_transpose",
           "conv3d_transpose", "embedding", "one_hot",
           "cross_entropy", "softmax_with_cross_entropy", "nll_loss",
           "mse_loss", "square_error_cost", "l1_loss", "smooth_l1_loss",
           "binary_cross_entropy", "binary_cross_entropy_with_logits",
           "kl_div", "log_loss", "hinge_loss", "margin_ranking_loss",
           "ctc_loss", "batch_norm", "bn_inference_scale_bias", "layer_norm",
           "rms_norm", "group_norm", "instance_norm", "normalize",
           "max_pool1d", "max_pool2d", "avg_pool1d", "avg_pool2d",
           "adaptive_avg_pool2d", "adaptive_max_pool2d", "max_pool3d",
           "avg_pool3d", "adaptive_avg_pool3d", "rnn", "birnn",
           "flash_attention", "scaled_dot_product_attention"]
