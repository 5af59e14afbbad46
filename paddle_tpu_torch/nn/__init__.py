"""Layers and functional ops of the port (counterpart of paddle_tpu.nn)."""
from . import functional, initializer
from .layer.common import Dropout, Embedding, Linear
from .layer.conv import Conv2D
from .layer.loss import (BCELoss, BCEWithLogitsLoss, CrossEntropyLoss,
                         KLDivLoss, L1Loss, MarginRankingLoss, MSELoss,
                         NLLLoss, SmoothL1Loss)
from .layer.norm import LayerNorm
from .layer.transformer import (
    MultiHeadAttention,
    Transformer,
    TransformerDecoder,
    TransformerDecoderLayer,
    TransformerEncoder,
    TransformerEncoderLayer,
)

__all__ = ["functional", "initializer", "Dropout", "Embedding", "Linear",
           "Conv2D", "LayerNorm", "MultiHeadAttention", "Transformer",
           "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer",
           "CrossEntropyLoss", "MSELoss", "L1Loss", "SmoothL1Loss",
           "BCELoss", "BCEWithLogitsLoss", "NLLLoss", "KLDivLoss",
           "MarginRankingLoss"]
