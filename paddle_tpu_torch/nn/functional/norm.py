"""LayerNorm, BatchNorm, RMSNorm, GroupNorm, InstanceNorm and normalize
(counterpart of paddle_tpu/nn/functional/norm.py).

With ``use_fused_layer_norm`` on, a last-axis norm with weight and bias goes
to kernel B (ops/kernels/layer_norm.py): the kernel on CUDA tensors, its
plain version on CPU tensors.  Otherwise the composition below runs, as in
the JAX package: fp32 statistics, the normalised value cast back to x's
dtype, then scale and shift.

BatchNorm has no kernel in the JAX package outside the fused training op.
Inference folds the running statistics into a per-channel ``a * x + b``;
training takes one-pass fp32 batch statistics (E[x^2] - E[x]^2) and
returns the running statistics updated with ``momentum``, as the JAX
package does.  Its backward is the JAX package's hand-written one (dx
from dbeta = sum(dy) and dgamma = sum(dy xhat), ``_bn_train``'s VJP), not
autograd through the one-pass variance, which computes another sum.
``batch_norm_act`` is training-mode ``act(batch_norm(x))`` as one unit
(the training half of the fused conv op): with ``use_pallas_conv_fused``
on and the JAX gate ``train_supported`` holding, the batch-statistics and
scale + act kernels of ops/kernels/bn_act_train.py (their plain versions
on CPU tensors); otherwise ``batch_norm`` and the activation.  The running
statistics are returned, never updated in place.
"""
from __future__ import annotations

import torch

from ...core import flags
from ...ops.kernels import bn_act_train as _bn_train
from ...ops.kernels import layer_norm as _fused
from . import activation as _act_mod


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    normalized_shape = tuple(normalized_shape)
    if (weight is not None and bias is not None
            and flags.get_flag("use_fused_layer_norm")
            and len(normalized_shape) == 1
            and x.shape[-1] == normalized_shape[0]):
        return _fused.fused_layer_norm(x, weight, bias, epsilon)
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = xf.var(dim=dims, keepdim=True, unbiased=False)
    out = ((xf - mean) / torch.sqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def bn_inference_scale_bias(mean, var, weight, bias, epsilon):
    """Inference BatchNorm folded to a per-channel ``a * x + b`` (fp32 a and
    b): ``a = weight / sqrt(var + eps)``, ``b = bias - mean * a``.  Shared
    by ``batch_norm`` and the fused conv op (static/ops_fused.py)."""
    inv = 1.0 / torch.sqrt(var.float() + epsilon)
    a = inv if weight is None else inv * weight.float()
    b = -mean.float() * a
    if bias is not None:
        b = b + bias.float()
    return a, b


class _BNTrain(torch.autograd.Function):
    """Training-mode BatchNorm over ``axes``: ``(out, mean, var)`` with
    fp32 statistics, and the JAX package's ``_bn_train`` VJP."""

    @staticmethod
    def forward(ctx, x, weight, bias, axes, shape, epsilon):
        xf = x.float()
        mean = xf.mean(dim=axes)
        var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean, min=0.0)
        inv = 1.0 / torch.sqrt(var + epsilon)
        a = inv if weight is None else inv * weight.float()
        b = -mean * a
        if bias is not None:
            b = b + bias.float()
        out = x * a.to(x.dtype).reshape(shape) + b.to(x.dtype).reshape(shape)
        ctx.save_for_backward(x, weight, mean, inv)
        ctx.axes, ctx.shape = axes, shape
        ctx.has_bias = bias is not None
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, dmean, dvar):
        x, weight, mean, inv = ctx.saved_tensors
        axes, shape = ctx.axes, ctx.shape
        m = x.numel() // mean.numel()
        mean_b, inv_b = mean.reshape(shape), inv.reshape(shape)
        xf = x.float()
        dof = dout.float()
        xhat = (xf - mean_b) * inv_b
        dbeta = dof.sum(dim=axes)
        dgamma = (dof * xhat).sum(dim=axes)
        g = inv if weight is None else weight.float() * inv
        dx = g.reshape(shape) * (dof - (dbeta / m).reshape(shape)
                                 - xhat * (dgamma / m).reshape(shape))
        if dmean is not None:
            dx = dx + (dmean / m).reshape(shape)
        if dvar is not None:
            dx = dx + dvar.reshape(shape) * 2.0 * (xf - mean_b) / m
        dw = None if weight is None else dgamma.to(weight.dtype)
        db = dbeta.to(x.dtype) if ctx.has_bias else None
        return dx.to(x.dtype), dw, db, None, None, None


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW"):
    """Returns ``(out, new_running_mean, new_running_var)``."""
    if data_format in ("NCHW", "NCL", "NC"):
        axes = (0,) + tuple(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
    else:  # channels last
        axes = tuple(range(x.dim() - 1))
        shape = [1] * (x.dim() - 1) + [-1]
    if training:
        out, mean, var = _BNTrain.apply(x, weight, bias, axes, shape,
                                        float(epsilon))
        mean = mean.detach().to(running_mean.dtype)
        var = var.detach().to(running_var.dtype)
        new_rm = momentum * running_mean + (1 - momentum) * mean
        new_rv = momentum * running_var + (1 - momentum) * var
        return out, new_rm, new_rv
    a, b = bn_inference_scale_bias(running_mean, running_var, weight, bias,
                                   epsilon)
    # b + x * a in one op: no x-sized temporary beside the output
    out = torch.addcmul(b.to(x.dtype).reshape(shape), x,
                        a.to(x.dtype).reshape(shape))
    return out, running_mean, running_var


def _use_fused_bn_act(x, act, data_format) -> bool:
    """The flag and the JAX package's gate of the fused train-mode BN +
    act kernels."""
    return (bool(flags.get_flag("use_pallas_conv_fused"))
            and _bn_train.train_supported(x, act, data_format))


def batch_norm_act(x, running_mean, running_var, weight=None, bias=None,
                   momentum=0.9, epsilon=1e-5, act="", data_format="NHWC"):
    """Training-mode ``act(batch_norm(x))`` as one unit.  Returns ``(out,
    new_running_mean, new_running_var)``; the batch statistics enter the
    running ones detached."""
    if _use_fused_bn_act(x, act, data_format):
        c = x.shape[-1]
        gamma = torch.ones(c, device=x.device) if weight is None else weight
        beta = torch.zeros(c, device=x.device) if bias is None else bias
        out, mean, var = _bn_train.fused_bn_act_train(x, gamma, beta,
                                                      float(epsilon), act)
        mean = mean.detach().to(running_mean.dtype)
        var = var.detach().to(running_var.dtype)
        new_rm = momentum * running_mean + (1 - momentum) * mean
        new_rv = momentum * running_var + (1 - momentum) * var
        return out, new_rm, new_rv
    out, new_rm, new_rv = batch_norm(
        x, running_mean, running_var, weight=weight, bias=bias,
        training=True, momentum=momentum, epsilon=epsilon,
        data_format=data_format)
    if act:
        # paddle op names vs functional names: hard_swish -> hardswish
        fn = getattr(_act_mod, act, None) \
            or getattr(_act_mod, act.replace("_", ""))
        out = fn(out)
    return out, new_rm, new_rv


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last axis, fp32 statistics, cast back to x's dtype
    before the scale (the JAX package's own addition; the reference has
    none)."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    out = (xf / torch.sqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


def _affine(out, weight, bias):
    shape = [1, out.shape[1]] + [1] * (out.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5):
    """x (N, C, *spatial): statistics over each group of C / num_groups
    channels and the spatial dims, in x's dtype, as the JAX package."""
    n, c = x.shape[0], x.shape[1]
    g = x.reshape(n, num_groups, c // num_groups, *x.shape[2:])
    dims = tuple(range(2, g.dim()))
    mean = g.mean(dim=dims, keepdim=True)
    var = g.var(dim=dims, keepdim=True, unbiased=False)
    out = ((g - mean) / torch.sqrt(var + epsilon)).reshape(x.shape)
    return _affine(out, weight, bias)


def instance_norm(x, weight=None, bias=None, epsilon=1e-5):
    """Statistics over the spatial dims of each (sample, channel)."""
    dims = tuple(range(2, x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, unbiased=False)
    return _affine((x - mean) / torch.sqrt(var + epsilon), weight, bias)


def normalize(x, p=2, axis=1, epsilon=1e-12):
    """x over its p-norm along ``axis``, the norm floored at ``epsilon``."""
    norm = torch.sum(x.abs() ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(norm, min=epsilon)
