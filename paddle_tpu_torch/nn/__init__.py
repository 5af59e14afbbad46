"""Layers and functional ops of the port (counterpart of paddle_tpu.nn)."""
from . import functional, initializer
from .layer.activation import (CELU, ELU, GELU, Hardshrink, Hardsigmoid,
                               Hardswish, Hardtanh, LeakyReLU, LogSigmoid,
                               LogSoftmax, Mish, PReLU, ReLU, ReLU6, SELU,
                               Sigmoid, SiLU, Softmax, Softplus, Softshrink,
                               Softsign, Tanh, Tanhshrink)
from .layer.base import Layer, LayerList, Parameter, ParameterList, Sequential
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

__all__ = ["functional", "initializer", "Layer", "LayerList", "Parameter",
           "ParameterList", "Sequential", "CELU", "ELU", "GELU",
           "Hardshrink", "Hardsigmoid", "Hardswish", "Hardtanh", "LeakyReLU",
           "LogSigmoid", "LogSoftmax", "Mish", "PReLU", "ReLU", "ReLU6",
           "SELU", "Sigmoid", "SiLU", "Softmax", "Softplus", "Softshrink",
           "Softsign", "Tanh", "Tanhshrink", "Dropout", "Embedding", "Linear",
           "Conv2D", "LayerNorm", "MultiHeadAttention", "Transformer",
           "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer",
           "CrossEntropyLoss", "MSELoss", "L1Loss", "SmoothL1Loss",
           "BCELoss", "BCEWithLogitsLoss", "NLLLoss", "KLDivLoss",
           "MarginRankingLoss"]
