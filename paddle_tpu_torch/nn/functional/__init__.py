"""Functional ops of the port (counterpart of paddle_tpu.nn.functional)."""
from ...ops.attention import flash_attention, scaled_dot_product_attention
from .activation import gelu, relu
from .common import dropout, linear
from .conv import conv2d
from .input import embedding
from .loss import cross_entropy, softmax_with_cross_entropy
from .norm import batch_norm, bn_inference_scale_bias, layer_norm
from .pooling import (adaptive_avg_pool2d, adaptive_max_pool2d, avg_pool1d,
                      avg_pool2d, max_pool1d, max_pool2d)

__all__ = ["gelu", "relu", "dropout", "linear", "conv2d", "embedding",
           "cross_entropy", "softmax_with_cross_entropy", "batch_norm",
           "bn_inference_scale_bias", "layer_norm", "max_pool1d",
           "max_pool2d", "avg_pool1d", "avg_pool2d", "adaptive_avg_pool2d",
           "adaptive_max_pool2d", "flash_attention",
           "scaled_dot_product_attention"]
