"""Lowerings of the reference's long tail of ops (counterpart of
paddle_tpu/static/ops_tail.py).  Ported so far: the optimizer updates
beyond sgd / momentum / adam (static/ops.py), and the fake-quant ops of
static quantization: the trainable quant-dequant ops that
``QuantizationTransformPass`` inserts, with straight-through gradients,
and the frozen-scale op that ``QuantizationFreezePass`` and
post-training quantization leave (slim/quant_static.py).

Each optimizer update copies the JAX lowering's fp32 master math term for
term; ``dpsgd``'s noise comes from the Executor's per-op CPU generator, so
its draws repeat for a fixed seed but cannot match ``jax.random``.
"""
from __future__ import annotations

import torch

from ..core import random as _random
from .ops import _adam, _one, current_device
from .registry import register_op


def qmax(bits) -> float:
    """The largest level of a symmetric ``bits``-bit grid (127 for 8)."""
    return float(2 ** (int(bits) - 1) - 1)


def _norm(x):
    """The 2-norm of every element (``jnp.linalg.norm`` of a vector or
    the Frobenius norm of a matrix)."""
    return torch.linalg.vector_norm(x)


# -- optimizer updates (ref operators/optimizers/*.h) ------------------------

@register_op("adamax")
def _adamax(ins, attrs, op):
    p, g = _one(ins, "Param"), _one(ins, "Grad")
    m, u = _one(ins, "Moment"), _one(ins, "InfNorm")
    lr = _one(ins, "LearningRate").float()
    b1p = _one(ins, "Beta1Pow").float()
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    g32 = g.float()
    m_new = b1 * m + (1 - b1) * g32
    u_new = torch.maximum(b2 * u, g32.abs() + eps)
    p_new = p.float() - lr / (1 - b1p) * m_new / u_new
    return {"ParamOut": [p_new.to(p.dtype)], "MomentOut": [m_new],
            "InfNormOut": [u_new]}


@register_op("adamw")
def _adamw(ins, attrs, op):
    coeff = attrs.get("coeff", 0.01)
    out = _adam(ins, attrs, op)
    p = _one(ins, "Param")
    lr = _one(ins, "LearningRate").float()
    p_new = out["ParamOut"][0].float() - lr * coeff * p.float()
    out["ParamOut"] = [p_new.to(p.dtype)]
    return out


@register_op("adagrad")
def _adagrad(ins, attrs, op):
    p, g, acc = _one(ins, "Param"), _one(ins, "Grad"), _one(ins, "Moment")
    lr = _one(ins, "LearningRate").float()
    eps = attrs.get("epsilon", 1e-6)
    g32 = g.float()
    acc_new = acc + g32 * g32
    p_new = p.float() - lr * g32 / (torch.sqrt(acc_new) + eps)
    return {"ParamOut": [p_new.to(p.dtype)], "MomentOut": [acc_new]}


@register_op("decayed_adagrad")
def _decayed_adagrad(ins, attrs, op):
    p, g, acc = _one(ins, "Param"), _one(ins, "Grad"), _one(ins, "Moment")
    lr = _one(ins, "LearningRate").float()
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g32 = g.float()
    acc_new = decay * acc + (1 - decay) * g32 * g32
    p_new = p.float() - lr * g32 / (torch.sqrt(acc_new) + eps)
    return {"ParamOut": [p_new.to(p.dtype)], "MomentOut": [acc_new]}


@register_op("adadelta")
def _adadelta(ins, attrs, op):
    p, g = _one(ins, "Param"), _one(ins, "Grad")
    avg_sq_g = _one(ins, "AvgSquaredGrad")
    avg_sq_u = _one(ins, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g32 = g.float()
    avg_sq_g_new = rho * avg_sq_g + (1 - rho) * g32 * g32
    upd = torch.sqrt(avg_sq_u + eps) / torch.sqrt(avg_sq_g_new + eps) * g32
    avg_sq_u_new = rho * avg_sq_u + (1 - rho) * upd * upd
    p_new = p.float() - upd
    return {"ParamOut": [p_new.to(p.dtype)],
            "AvgSquaredGradOut": [avg_sq_g_new],
            "AvgSquaredUpdateOut": [avg_sq_u_new]}


@register_op("rmsprop")
def _rmsprop(ins, attrs, op):
    p, g = _one(ins, "Param"), _one(ins, "Grad")
    ms, mg = _one(ins, "MeanSquare"), _one(ins, "MeanGrad")
    mom = _one(ins, "Moment")
    lr = _one(ins, "LearningRate").float()
    rho = attrs.get("decay", 0.9)
    eps = attrs.get("epsilon", 1e-10)
    momentum = attrs.get("momentum", 0.0)
    g32 = g.float()
    ms_new = rho * ms + (1 - rho) * g32 * g32
    if attrs.get("centered", False):
        mg_new = rho * mg + (1 - rho) * g32
        denom = torch.sqrt(ms_new - mg_new * mg_new + eps)
    else:
        mg_new = mg
        denom = torch.sqrt(ms_new + eps)
    mom_new = momentum * mom + lr * g32 / denom
    p_new = p.float() - mom_new
    return {"ParamOut": [p_new.to(p.dtype)], "MeanSquareOut": [ms_new],
            "MeanGradOut": [mg_new], "MomentOut": [mom_new]}


@register_op("ftrl")
def _ftrl(ins, attrs, op):
    p, g = _one(ins, "Param"), _one(ins, "Grad")
    sq, lin = _one(ins, "SquaredAccumulator"), _one(ins, "LinearAccumulator")
    lr = _one(ins, "LearningRate").float()
    l1, l2 = attrs.get("l1", 0.0), attrs.get("l2", 0.0)
    lr_power = attrs.get("lr_power", -0.5)
    g32, p32 = g.float(), p.float()
    sq_new = sq + g32 * g32
    pow_old = sq ** (-lr_power)
    pow_new = sq_new ** (-lr_power)
    sigma = (pow_new - torch.where(sq > 0, pow_old,
                                   torch.zeros_like(pow_old))) / lr
    lin_new = lin + g32 - sigma * p32
    quad = pow_new / lr + 2 * l2
    pre = torch.clamp(lin_new, -l1, l1) - lin_new
    p_new = torch.where(lin_new.abs() > l1, pre / quad,
                        torch.zeros_like(p32))
    return {"ParamOut": [p_new.to(p.dtype)], "SquaredAccumOut": [sq_new],
            "LinearAccumOut": [lin_new]}


@register_op("lamb")
def _lamb(ins, attrs, op):
    p, g = _one(ins, "Param"), _one(ins, "Grad")
    m, v = _one(ins, "Moment1"), _one(ins, "Moment2")
    lr = _one(ins, "LearningRate").float()
    b1p = _one(ins, "Beta1Pow").float()
    b2p = _one(ins, "Beta2Pow").float()
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    g32, p32 = g.float(), p.float()
    m_new = b1 * m + (1 - b1) * g32
    v_new = b2 * v + (1 - b2) * g32 * g32
    mhat = m_new / (1 - b1p * b1)
    vhat = v_new / (1 - b2p * b2)
    r = mhat / (torch.sqrt(vhat) + eps) + wd * p32
    p_norm, r_norm = _norm(p32), _norm(r)
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        torch.ones_like(p_norm))
    p_new = p32 - lr * trust * r
    return {"ParamOut": [p_new.to(p.dtype)], "Moment1Out": [m_new],
            "Moment2Out": [v_new], "Beta1PowOut": [b1p * b1],
            "Beta2PowOut": [b2p * b2]}


@register_op("lars_momentum")
def _lars_momentum(ins, attrs, op):
    p, g, vel = _one(ins, "Param"), _one(ins, "Grad"), _one(ins, "Velocity")
    lr = _one(ins, "LearningRate").float()
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    wd = attrs.get("lars_weight_decay", 0.0005)
    eps = attrs.get("epsilon", 1e-9)
    g32, p32 = g.float(), p.float()
    p_norm, g_norm = _norm(p32), _norm(g32)
    local_lr = torch.where((p_norm > 0) & (g_norm > 0),
                           coeff * p_norm / (g_norm + wd * p_norm + eps),
                           torch.ones_like(p_norm))
    v_new = mu * vel + lr * local_lr * (g32 + wd * p32)
    p_new = p32 - v_new
    return {"ParamOut": [p_new.to(p.dtype)], "VelocityOut": [v_new]}


@register_op("dpsgd")
def _dpsgd(ins, attrs, op):
    """Clip the gradient to norm ``clip``, add N(0, (sigma * clip)^2)
    noise (drawn on the host from the op's generator) and step."""
    p, g = _one(ins, "Param"), _one(ins, "Grad")
    lr = _one(ins, "LearningRate").float()
    clip = attrs.get("clip", 10.0)
    sigma = attrs.get("sigma", 1.0)
    g32 = g.float()
    g_clip = g32 / torch.clamp_min(_norm(g32) / clip, 1.0)
    draw = torch.randn(tuple(g32.shape),
                       generator=_random.current_generator())
    noise = sigma * clip * draw.to(current_device())
    p_new = p.float() - lr * (g_clip + noise)
    return {"ParamOut": [p_new.to(p.dtype)]}


# -- fake quantization (ref operators/fake_quantize_op.cc) -------------------

@register_op("fake_quantize_dequantize_abs_max")
def _fake_qdq_abs_max(ins, attrs, op):
    from ..slim.quant import fake_quant_dequant_abs_max

    y, scale = fake_quant_dequant_abs_max(_one(ins, "X"),
                                          attrs.get("bit_length", 8))
    return {"Out": [y], "OutScale": [scale.reshape(1)]}


@register_op("fake_channel_wise_quantize_dequantize_abs_max")
def _fake_cw_qdq_abs_max(ins, attrs, op):
    from ..slim.quant import fake_channel_wise_quant_dequant_abs_max

    y, scale = fake_channel_wise_quant_dequant_abs_max(
        _one(ins, "X"), attrs.get("bit_length", 8),
        quant_axis=attrs.get("quant_axis", 0))
    return {"Out": [y], "OutScale": [scale]}


@register_op("fake_quantize_dequantize_moving_average_abs_max")
def _fake_qdq_moving_avg(ins, attrs, op):
    """Activation quant-dequant against an EMA of the batch abs-max: the
    state ``InScale`` (0 before the first batch) becomes ``rate * state +
    (1 - rate) * amax``; ``q = round(clip(x / scale, -1, 1) * qmax) / qmax
    * scale``, as ``x + (q - x).detach()`` (straight-through).  The new
    scale is state, written back detached."""
    x = _one(ins, "X")
    state = _one(ins, "InScale").reshape(())
    rate = attrs.get("moving_rate", 0.9)
    qm = qmax(attrs.get("bit_length", 8))
    cur = x.detach().abs().amax().clamp_min(1e-8)
    scale = torch.where(state > 0, rate * state + (1 - rate) * cur, cur)
    q = (x / scale).clamp(-1.0, 1.0).mul(qm).round().div(qm).mul(scale)
    return {"Out": [x + (q - x).detach()], "OutScale": [scale.reshape(1)]}


@register_op("fake_quantize_dequantize_fixed_scale")
def _fake_qdq_fixed_scale(ins, attrs, op):
    """Frozen-scale quant-dequant: ``q = round(clip(x / scale, -1, 1) *
    qmax) / qmax * scale`` in x's dtype, in the straight-through form
    ``x + (q - x).detach()`` (forward q up to that sum's rounding,
    gradient the identity), as the JAX lowering computes it."""
    x = _one(ins, "X")
    qm = qmax(attrs.get("bit_length", 8))
    scale = attrs["scale"]
    q = (x / scale).clamp(-1.0, 1.0).mul(qm).round().div(qm).mul(scale)
    return {"Out": [x + (q - x).detach()]}
