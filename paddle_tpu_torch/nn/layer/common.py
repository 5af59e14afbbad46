"""Linear, Embedding, the dropouts, Flatten, Pad2D and Upsample
(counterpart of paddle_tpu/nn/layer/common.py).

Parameters are made on the CPU from an explicit ``torch.Generator`` (the
global one when none is given), so one seed gives one set of weights on
every device; a model moves them to its device afterwards.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import functional as F
from .. import initializer as I
from .base import Layer, Parameter


def param_init(attr, default):
    """The initializer of a ``weight_attr`` / ``bias_attr``: any object with
    an ``.initializer`` (the JAX package has no ParamAttr class and reads
    the attribute), else ``default``."""
    return getattr(attr, "initializer", None) or default


def make_param(module, name, init, shape,
               generator: Optional[torch.Generator] = None):
    """Register ``name`` on ``module``: a ``Parameter`` drawn from ``init``,
    which it records (``Parameter.initializer``), so a cloned stack can
    draw its copies anew from it (transformer ``_reinit``)."""
    setattr(module, name, Parameter(init(shape, generator=generator),
                                    initializer=init))


class Linear(Layer):
    """y = x W + b with W: (in_features, out_features), Paddle's layout
    (not torch's (out, in)), so converted weights keep their shape.  The
    weight is XavierUniform and the bias 0 unless ``weight_attr`` /
    ``bias_attr`` carry an initializer; ``bias_attr=False`` means no bias.
    ``name`` is accepted (a module has no parameter names of its own)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        make_param(self, "weight", param_init(weight_attr, I.XavierUniform()),
                   (in_features, out_features), generator)
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            make_param(self, "bias", param_init(bias_attr, I.Constant(0.0)),
                       (out_features,), generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}"


class Embedding(Layer):
    """ref nn/layer/common.py Embedding, with the reference's parameter
    order.  ``padding_idx`` zeroes that id's output row.  The weight is
    drawn from ``weight_attr``'s initializer, else N(0, ``std``) (``std``
    and ``generator`` keyword-only; the reference's default is N(0, 1)).
    ``sparse`` is accepted and the gradient is dense either way
    (``F.embedding``); ``name`` is accepted (a module has no parameter
    names of its own)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, std=1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.sparse = sparse
        make_param(self, "weight", param_init(weight_attr, I.Normal(0.0, std)),
                   (num_embeddings, embedding_dim), generator)

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx,
                           sparse=self.sparse)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(Layer):
    """Dropout in the reference's modes (``upscale_in_train``,
    ``downgrade_in_infer``)."""

    def __init__(self, p=0.5, mode="upscale_in_train"):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, training=self.training, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    """Channel-wise dropout (``F.dropout2d``)."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Pad2D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW"):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.data_format)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners

    def forward(self, x):
        return F.interpolate(x, size=self.size,
                             scale_factor=self.scale_factor, mode=self.mode,
                             align_corners=self.align_corners)
