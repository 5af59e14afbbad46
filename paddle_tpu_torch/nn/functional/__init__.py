"""Functional ops of the port (counterpart of paddle_tpu.nn.functional)."""
from .activation import gelu, relu
from .common import dropout, linear
from .input import embedding
from .loss import cross_entropy, softmax_with_cross_entropy
from .norm import layer_norm

__all__ = ["gelu", "relu", "dropout", "linear", "embedding",
           "cross_entropy", "softmax_with_cross_entropy", "layer_norm"]
