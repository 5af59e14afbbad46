"""Concrete optimizers (counterpart of paddle_tpu/optimizer/optimizers.py).

The JAX package leaves each update to XLA, which fuses it into the step;
the port writes it as PyTorch ``_foreach`` ops over the whole parameter
list, a handful of launches a step, in place under ``torch.no_grad``.
Moments are fp32 whatever the parameter's type (Momentum's velocity keeps
the parameter's type, as the reference's ``zeros_like(p)`` does), and the
arithmetic follows the reference's dtypes: an fp32 update rounded once to
the parameter's type, or, for SGD and Momentum, the LR cast to the
parameter's type first.  Per-tensor norms (Lamb, LARS) stay on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
           "Adadelta", "RMSProp", "Lamb", "LarsMomentum"]


def _zeros32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _cast_scalar(x, dtype):
    """The float ``x`` rounded to ``dtype`` (the JAX ``lr.astype(p.dtype)``)."""
    return float(torch.tensor(float(x), dtype=torch.float32).to(dtype))


def _write(params, new32):
    """``p <- new.astype(p.dtype)`` for each pair, in place."""
    same = [i for i, p in enumerate(params) if p.dtype == new32[i].dtype]
    if same:
        torch._foreach_copy_([params[i] for i in same],
                             [new32[i] for i in same])
    for i, p in enumerate(params):
        if p.dtype != new32[i].dtype:
            p.copy_(new32[i])


def _sub_fp32(params, upd):
    """``p <- (p.float() - upd).astype(p.dtype)``, ``upd`` fp32."""
    fp32 = [i for i, p in enumerate(params) if p.dtype == torch.float32]
    if fp32:
        torch._foreach_sub_([params[i] for i in fp32], [upd[i] for i in fp32])
    for i, p in enumerate(params):
        if p.dtype != torch.float32:
            p.copy_(p.float() - upd[i])


def _bias_corrections(beta1, beta2, step):
    """1 - beta^t in fp32, t the fp32 step (1 at the first update)."""
    t = np.float32(step)
    return (float(np.float32(1) - np.float32(beta1) ** t),
            float(np.float32(1) - np.float32(beta2) ** t))


class SGD(Optimizer):
    """p = p - lr.astype(p.dtype) * g."""

    def apply_updates(self, grads, params, slots, lr, step):
        for p, g in zip(params, grads):
            p.copy_(p - _cast_scalar(lr, p.dtype) * g)


class Momentum(Optimizer):
    """v = momentum v + g; p = p - lr v, or with ``use_nesterov`` p = p -
    lr (g + momentum v)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def init_param_state(self, p):
        return torch.zeros_like(p)

    def apply_updates(self, grads, params, slots, lr, step):
        for p, g, v in zip(params, grads, slots):
            # a Python scalar meets a bf16 array as bf16 in JAX
            mu = _cast_scalar(self.momentum, v.dtype)
            v_new = mu * v + g
            lr_p = _cast_scalar(lr, p.dtype)
            if self.use_nesterov:
                mu = _cast_scalar(self.momentum, v_new.dtype)
                p.copy_(p - lr_p * (g + mu * v_new))
            else:
                p.copy_(p - lr_p * v_new)
            v.copy_(v_new)


class Adam(Optimizer):
    """Bias-corrected Adam: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
    t = step as fp32, p = (p.float() - lr m_hat / (sqrt(v_hat) + eps))
    .to(p.dtype).  ``lazy_mode`` is accepted (the sparse-rows update is the
    dense one here, as in the JAX package)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, lazy_mode=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_mode = lazy_mode

    def init_param_state(self, p):
        return (_zeros32(p), _zeros32(p))

    def _adam_update(self, grads, slots, lr, step):
        """The fp32 update ``lr m_hat / (sqrt(v_hat) + eps)`` per
        parameter, the moments advanced in place."""
        ms = [s[0] for s in slots]
        vs = [s[1] for s in slots]
        g32 = [g.float() for g in grads]
        torch._foreach_mul_(ms, self.beta1)
        torch._foreach_add_(ms, g32, alpha=1 - self.beta1)
        torch._foreach_mul_(vs, self.beta2)
        torch._foreach_addcmul_(vs, g32, g32, value=1 - self.beta2)
        bc1, bc2 = _bias_corrections(self.beta1, self.beta2, step)
        m_hat = torch._foreach_div(ms, bc1)
        denom = torch._foreach_sqrt(torch._foreach_div(vs, bc2))
        torch._foreach_add_(denom, self.epsilon)
        upd = torch._foreach_mul(m_hat, float(lr))
        torch._foreach_div_(upd, denom)
        return upd

    def apply_updates(self, grads, params, slots, lr, step):
        if params:
            _sub_fp32(params, self._adam_update(grads, slots, lr, step))


class AdamW(Adam):
    """Adam with decoupled weight decay: p_new = adam(p) - (lr wd) p, the
    decay taken from the parameter before the update and computed in its
    own dtype, as the reference's ``p_new - (lr.astype(p.dtype) * wd) * p``.
    ``apply_decay_param_fun`` is stored and, as in the JAX package, not
    called (every parameter decays; ROADMAP.md Queue 3)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, name=None, apply_decay_param_fun=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, name)
        self._decoupled_wd = weight_decay
        self.apply_decay_param_fun = apply_decay_param_fun

    def apply_updates(self, grads, params, slots, lr, step):
        if not params:
            return
        decay = {}
        for i, p in enumerate(params):
            d = torch.tensor(_cast_scalar(lr, p.dtype), dtype=p.dtype) * \
                torch.tensor(_cast_scalar(self._decoupled_wd, p.dtype),
                             dtype=p.dtype)
            decay.setdefault(p.dtype, float(d))
        dec = [p * decay[p.dtype] for p in params]     # from the old p
        super().apply_updates(grads, params, slots, lr, step)
        torch._foreach_sub_(params, dec)


class Adamax(Optimizer):
    """m = b1 m + (1 - b1) g; u = max(b2 u, |g| + eps); p -= lr / (1 -
    b1^t) m / u."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_param_state(self, p):
        return (_zeros32(p), _zeros32(p))

    def apply_updates(self, grads, params, slots, lr, step):
        if not params:
            return
        ms = [s[0] for s in slots]
        us = [s[1] for s in slots]
        g32 = [g.float() for g in grads]
        torch._foreach_mul_(ms, self.beta1)
        torch._foreach_add_(ms, g32, alpha=1 - self.beta1)
        torch._foreach_mul_(us, self.beta2)
        absg = torch._foreach_abs(g32)
        torch._foreach_add_(absg, self.epsilon)
        torch._foreach_maximum_(us, absg)
        bc1, _ = _bias_corrections(self.beta1, self.beta2, step)
        scale = float(np.float32(lr) / np.float32(bc1))
        upd = torch._foreach_mul(ms, scale)
        torch._foreach_div_(upd, us)
        _sub_fp32(params, upd)


class Adagrad(Optimizer):
    """acc += g^2; p -= lr g / (sqrt(acc) + eps)."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self.epsilon = epsilon
        self.initial_accumulator_value = initial_accumulator_value

    def init_param_state(self, p):
        return torch.full(p.shape, self.initial_accumulator_value,
                          dtype=torch.float32, device=p.device)

    def apply_updates(self, grads, params, slots, lr, step):
        if not params:
            return
        g32 = [g.float() for g in grads]
        torch._foreach_addcmul_(slots, g32, g32)
        denom = torch._foreach_sqrt(slots)
        torch._foreach_add_(denom, self.epsilon)
        upd = torch._foreach_mul(g32, float(lr))
        torch._foreach_div_(upd, denom)
        _sub_fp32(params, upd)


class Adadelta(Optimizer):
    """E[g^2] = rho E[g^2] + (1 - rho) g^2; u = sqrt(E[u^2] + eps) /
    sqrt(E[g^2] + eps) g; E[u^2] = rho E[u^2] + (1 - rho) u^2; p -= lr u."""

    def __init__(self, learning_rate=1.0, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self.epsilon, self.rho = epsilon, rho

    def init_param_state(self, p):
        return (_zeros32(p), _zeros32(p))

    def apply_updates(self, grads, params, slots, lr, step):
        if not params:
            return
        sq_g = [s[0] for s in slots]
        sq_u = [s[1] for s in slots]
        g32 = [g.float() for g in grads]
        torch._foreach_mul_(sq_g, self.rho)
        torch._foreach_addcmul_(sq_g, g32, g32, value=1 - self.rho)
        num = torch._foreach_sqrt(torch._foreach_add(sq_u, self.epsilon))
        den = torch._foreach_sqrt(torch._foreach_add(sq_g, self.epsilon))
        upd = torch._foreach_div(num, den)
        torch._foreach_mul_(upd, g32)
        torch._foreach_mul_(sq_u, self.rho)
        torch._foreach_addcmul_(sq_u, upd, upd, value=1 - self.rho)
        _sub_fp32(params, torch._foreach_mul(upd, float(lr)))


class RMSProp(Optimizer):
    """ms = rho ms + (1 - rho) g^2 (``centered``: mg = rho mg + (1 - rho)
    g, denominator sqrt(ms - mg^2 + eps), else sqrt(ms + eps)); mom =
    momentum mom + lr g / denominator; p -= mom."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self.rho, self.epsilon, self.momentum, self.centered = (
            rho, epsilon, momentum, centered)

    def init_param_state(self, p):
        return (_zeros32(p), _zeros32(p), _zeros32(p))

    def apply_updates(self, grads, params, slots, lr, step):
        if not params:
            return
        ms = [s[0] for s in slots]
        mg = [s[1] for s in slots]
        mom = [s[2] for s in slots]
        g32 = [g.float() for g in grads]
        torch._foreach_mul_(ms, self.rho)
        torch._foreach_addcmul_(ms, g32, g32, value=1 - self.rho)
        if self.centered:
            torch._foreach_mul_(mg, self.rho)
            torch._foreach_add_(mg, g32, alpha=1 - self.rho)
            denom = torch._foreach_sub(ms, torch._foreach_mul(mg, mg))
            torch._foreach_add_(denom, self.epsilon)
        else:
            denom = torch._foreach_add(ms, self.epsilon)
        denom = torch._foreach_sqrt(denom)
        step_ = torch._foreach_mul(g32, float(lr))
        torch._foreach_div_(step_, denom)
        torch._foreach_mul_(mom, self.momentum)
        torch._foreach_add_(mom, step_)
        _sub_fp32(params, mom)


def _norms(tensors):
    """Per-tensor fp32 L2 norms as one device vector."""
    return torch.stack(torch._foreach_norm(tensors))


class Lamb(Optimizer):
    """Adam's direction plus ``lamb_weight_decay`` p, rescaled by the trust
    ratio ||p|| / ||r|| (1 where either norm is 0).
    ``exclude_from_weight_decay_fn`` is stored and, as in the JAX package,
    not called (ROADMAP.md Queue 3)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self.lamb_weight_decay = lamb_weight_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.exclude_fn = exclude_from_weight_decay_fn

    def init_param_state(self, p):
        return (_zeros32(p), _zeros32(p))

    def apply_updates(self, grads, params, slots, lr, step):
        if not params:
            return
        ms = [s[0] for s in slots]
        vs = [s[1] for s in slots]
        g32 = [g.float() for g in grads]
        p32 = [p.float() for p in params]
        torch._foreach_mul_(ms, self.beta1)
        torch._foreach_add_(ms, g32, alpha=1 - self.beta1)
        torch._foreach_mul_(vs, self.beta2)
        torch._foreach_addcmul_(vs, g32, g32, value=1 - self.beta2)
        bc1, bc2 = _bias_corrections(self.beta1, self.beta2, step)
        r = torch._foreach_div(ms, bc1)
        denom = torch._foreach_sqrt(torch._foreach_div(vs, bc2))
        torch._foreach_add_(denom, self.epsilon)
        torch._foreach_div_(r, denom)
        torch._foreach_add_(r, torch._foreach_mul(p32, self.lamb_weight_decay))
        pn, rn = _norms(p32), _norms(r)
        trust = torch.where((pn > 0) & (rn > 0), pn / rn,
                            torch.ones_like(pn))
        torch._foreach_mul_(r, list((float(lr) * trust).unbind()))
        _write(params, torch._foreach_sub(p32, r))


class LarsMomentum(Optimizer):
    """Layer-wise adaptive rate: local_lr = coeff ||p|| / (||g|| + wd ||p||
    + eps) (1 where either norm is 0); v = momentum v + lr local_lr (g +
    wd p); p -= v."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 epsilon=1e-9, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self.momentum = momentum
        self.lars_coeff = lars_coeff
        self.lars_weight_decay = lars_weight_decay
        self.epsilon = epsilon

    def init_param_state(self, p):
        return _zeros32(p)

    def apply_updates(self, grads, params, slots, lr, step):
        if not params:
            return
        g32 = [g.float() for g in grads]
        p32 = [p.float() for p in params]
        pn, gn = _norms(p32), _norms(g32)
        wd = self.lars_weight_decay
        local = torch.where(
            (pn > 0) & (gn > 0),
            self.lars_coeff * pn / (gn + wd * pn + self.epsilon),
            torch.ones_like(pn))
        d = torch._foreach_add(g32, torch._foreach_mul(p32, wd))
        torch._foreach_mul_(d, list((float(lr) * local).unbind()))
        torch._foreach_mul_(slots, self.momentum)
        torch._foreach_add_(slots, d)
        _write(params, torch._foreach_sub(p32, slots))
