"""Functional ops of the port (counterpart of paddle_tpu.nn.functional)."""
from .activation import gelu, relu
from .common import dropout, linear
from .input import embedding
from .norm import layer_norm

__all__ = ["gelu", "relu", "dropout", "linear", "embedding",
           "layer_norm"]
