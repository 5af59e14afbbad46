"""Optimizers of the port (counterpart of paddle_tpu.optimizer): the
optimizer base with weight decay, gradient clipping and LR schedules, the
ten optimizers, the long-tail ones and the parameter averages
(``extras``), the clips and the schedulers (``lr``)."""
from . import lr
from .extras import (DGCMomentum, Dpsgd, ExponentialMovingAverage, Ftrl,
                     Lookahead, ModelAverage, dgc_compress)
from .grad_clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                        ClipGradByValue, GradientClipByGlobalNorm,
                        GradientClipByNorm, GradientClipByValue)
from .optimizer import Optimizer
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                         LarsMomentum, Momentum, RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "LarsMomentum",
           "Ftrl", "Dpsgd", "DGCMomentum", "dgc_compress",
           "ExponentialMovingAverage", "ModelAverage", "Lookahead",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm"]
