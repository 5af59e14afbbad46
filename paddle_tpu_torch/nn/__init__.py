"""Layers and functional ops of the port (counterpart of paddle_tpu.nn)."""
from . import functional, initializer
from .decode import BeamSearchDecoder, dynamic_decode, gather_tree
from .layer.activation import (CELU, ELU, GELU, Hardshrink, Hardsigmoid,
                               Hardswish, Hardtanh, LeakyReLU, LogSigmoid,
                               LogSoftmax, Mish, PReLU, ReLU, ReLU6, SELU,
                               Sigmoid, SiLU, Softmax, Softplus, Softshrink,
                               Softsign, Tanh, Tanhshrink)
from .layer.base import Layer, LayerList, Parameter, ParameterList, Sequential
from .layer.common import (Dropout, Dropout2D, Embedding, Flatten, Linear,
                           Pad2D, Upsample)
from .layer.conv import Conv1D, Conv2D, Conv2DTranspose, Conv3D
from .layer.extras import (AdaptiveAvgPool3D, AlphaDropout, AvgPool3D,
                           Bilinear, BilinearTensorProduct, Conv3DTranspose,
                           CosineSimilarity, CTCLoss, Dropout3D, Identity,
                           InstanceNorm1D, InstanceNorm3D, LocalResponseNorm,
                           MaxPool3D, Pad1D, Pad3D, PairwiseDistance,
                           PixelShuffle, RowConv, SpectralNorm, Unfold,
                           ZeroPad2D)
from .layer.moe import MoEFFN
from .layer.loss import (BCELoss, BCEWithLogitsLoss, CrossEntropyLoss,
                         KLDivLoss, L1Loss, MarginRankingLoss, MSELoss,
                         NLLLoss, SmoothL1Loss)
from .layer.norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                         GroupNorm, InstanceNorm2D, LayerNorm, RMSNorm,
                         SyncBatchNorm)
from .layer.pooling import (AdaptiveAvgPool2D, AdaptiveMaxPool2D, AvgPool1D,
                            AvgPool2D, MaxPool1D, MaxPool2D)
from .layer.rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell,
                        RNNCellBase, SimpleRNN, SimpleRNNCell)
from .layer.transformer import (
    MultiHeadAttention,
    Transformer,
    TransformerDecoder,
    TransformerDecoderLayer,
    TransformerEncoder,
    TransformerEncoderLayer,
)

# The JAX package's nn names not ported yet (ROADMAP.md Queue 1): none.
_DEFERRED = ()

__all__ = [n for n in dir() if not n.startswith("_")]
