"""Layers and functional ops of the port (counterpart of paddle_tpu.nn)."""
from . import functional
from .layer.common import Dropout, Embedding, Linear
from .layer.norm import LayerNorm
from .layer.transformer import (
    MultiHeadAttention,
    TransformerEncoder,
    TransformerEncoderLayer,
)

__all__ = ["functional", "Dropout", "Embedding", "Linear", "LayerNorm",
           "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer"]
