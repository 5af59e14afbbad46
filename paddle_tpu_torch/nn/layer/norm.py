"""Norm layers: LayerNorm, the BatchNorms, SyncBatchNorm, RMSNorm,
GroupNorm and InstanceNorm2D (counterpart of paddle_tpu/nn/layer/norm.py).

The BatchNorm layers call ``F.batch_norm``, as the JAX package's do (the
fused train-mode kernels are reached only through ``F.batch_norm_act``),
and keep their running statistics in the buffers ``_mean`` / ``_variance``,
updated in place in training.
"""
from __future__ import annotations

import torch

from ...core import dtype as _dtype
from .. import functional as F
from .. import initializer as I
from .base import Layer, Parameter
from .common import param_init


class LayerNorm(Layer):
    """Scale 1 and shift 0 over ``normalized_shape``; ``weight_attr`` /
    ``bias_attr`` False drop the scale / the shift, as in the JAX package
    (which reads no initializer from them)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        dt = _dtype.get_default_dtype()
        self.weight = None if weight_attr is False else Parameter(
            torch.ones(self.normalized_shape, dtype=dt))
        self.bias = None if bias_attr is False else Parameter(
            torch.zeros(self.normalized_shape, dtype=dt))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            epsilon=self.epsilon)

    def extra_repr(self):
        return f"{self.normalized_shape}"


class _BatchNormBase(Layer):
    """Scale (1, or ``weight_attr``'s initializer) and shift (0, or
    ``bias_attr``'s), False dropping either; running mean 0 and variance
    1.  ``use_global_stats=True`` normalises with the running statistics
    in training too."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        dt = _dtype.get_default_dtype()
        for name, attr, default in (("weight", weight_attr, I.Constant(1.0)),
                                    ("bias", bias_attr, I.Constant(0.0))):
            if attr is False:
                self.register_parameter(name, None)
            else:
                init = param_init(attr, default)
                setattr(self, name, Parameter(init((num_features,), dt),
                                              initializer=init))
        self.register_buffer("_mean", torch.zeros(num_features, dtype=dt))
        self.register_buffer("_variance", torch.ones(num_features, dtype=dt))

    def forward(self, x):
        training = self.training and self.use_global_stats is not True
        out, new_rm, new_rv = F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=training, momentum=self.momentum, epsilon=self.epsilon,
            data_format=self.data_format)
        if training:
            with torch.no_grad():
                self._mean.copy_(new_rm)
                self._variance.copy_(new_rv)
        return out


class BatchNorm(_BatchNormBase):
    """The Fluid-era name, any rank (ref fluid/dygraph/nn.py BatchNorm)."""


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica BatchNorm (ref operators/sync_batch_norm_op.cu).  In
    training, when the dp group holds more than one member, the batch mean
    and mean of squares (over N and the spatial dims of an NC... input) are
    averaged over it, differentiably, and normalise this rank's batch, as
    the JAX package's ``pmean`` inside a sharded step; as there, the
    running statistics are not updated on that route (ROADMAP.md Queue 3).
    Otherwise it is BatchNorm."""

    def forward(self, x):
        from ...parallel import collective as _coll

        axis = _coll.bound_data_axis()
        if axis is None or not self.training:
            return super().forward(x)
        reduce_axes = (0,) + tuple(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        mean = _coll.group_mean(x.mean(dim=reduce_axes), axis)
        mean_sq = _coll.group_mean(x.square().mean(dim=reduce_axes), axis)
        var = mean_sq - mean.square()
        out = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape)
                                                     + self.epsilon)
        if self.weight is not None:
            out = out * self.weight.reshape(shape)
        if self.bias is not None:
            out = out + self.bias.reshape(shape)
        return out

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """Every BatchNorm of ``layer``'s tree as a SyncBatchNorm holding its
        parameters and statistics."""
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            new = cls(layer.num_features, layer.momentum, layer.epsilon,
                      data_format=layer.data_format)
            with torch.no_grad():
                for name in ("weight", "bias"):
                    if getattr(layer, name) is None:
                        new.register_parameter(name, None)
                    else:
                        getattr(new, name).copy_(getattr(layer, name))
                new._mean.copy_(layer._mean)
                new._variance.copy_(layer._variance)
            return new.to(layer._mean.device)
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer


class RMSNorm(Layer):
    """The JAX package's own addition for LLM blocks: scale 1."""

    def __init__(self, hidden_size, epsilon=1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.weight = Parameter(torch.ones(hidden_size,
                                           dtype=_dtype.get_default_dtype()))

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self.epsilon)


class GroupNorm(Layer):
    """Scale 1 and shift 0 per channel (False drops either)."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        dt = _dtype.get_default_dtype()
        self.weight = None if weight_attr is False else Parameter(
            torch.ones(num_channels, dtype=dt))
        self.bias = None if bias_attr is False else Parameter(
            torch.zeros(num_channels, dtype=dt))

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            epsilon=self.epsilon)


class InstanceNorm2D(Layer):
    """Scale 1 and shift 0 per channel; ``F.instance_norm`` is rank
    generic, so InstanceNorm1D / 3D share this class's body."""

    def __init__(self, num_features, epsilon=1e-5):
        super().__init__()
        self.epsilon = epsilon
        dt = _dtype.get_default_dtype()
        self.weight = Parameter(torch.ones(num_features, dtype=dt))
        self.bias = Parameter(torch.zeros(num_features, dtype=dt))

    def forward(self, x):
        return F.instance_norm(x, self.weight, self.bias,
                               epsilon=self.epsilon)
