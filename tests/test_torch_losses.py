"""The port's losses (paddle_tpu_torch.nn.functional and the loss layers)
against the JAX package's, on the CPU: every loss function and layer, each
reduction, class weights and ``pos_weight`` where taken, and the gradient
of the summed loss with respect to the input; values and gradients at
rtol 1e-6 (atol 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF

TOL = 1e-6
REDUCTIONS = ["mean", "sum", "none"]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    n, c = 7, 5
    logits = rng.normal(0, 2, (n, c)).astype(np.float32)
    log_probs = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))
                 ).astype(np.float32)
    label = np.array([1, 4, -100, 0, 3, -100, 2], np.int32)
    x = rng.normal(0, 1, (n, c)).astype(np.float32)
    y = rng.normal(0, 1, (n, c)).astype(np.float32)
    prob = rng.uniform(0.02, 0.98, (n, c)).astype(np.float32)
    binary = rng.integers(0, 2, (n, c)).astype(np.float32)
    target_dist = rng.dirichlet(np.ones(c), n).astype(np.float32)
    weight = rng.uniform(0.2, 2.0, (c,)).astype(np.float32)
    elem_w = rng.uniform(0.2, 2.0, (n, c)).astype(np.float32)
    pos_w = rng.uniform(0.5, 3.0, (c,)).astype(np.float32)
    sign = np.where(rng.random(n) > 0.5, 1.0, -1.0).astype(np.float32)
    return dict(logits=logits, log_probs=log_probs, label=label, x=x, y=y,
                prob=prob, binary=binary, target_dist=target_dist,
                weight=weight, elem_w=elem_w, pos_w=pos_w, sign=sign,
                x1=x[:, 0].copy(), y1=y[:, 0].copy())


# name -> (differentiated input, other inputs, keyword options)
CASES = {
    "nll_loss": ("log_probs", ["label"], {}),
    "nll_loss_weighted": ("log_probs", ["label", "weight"], {}),
    "mse_loss": ("x", ["y"], {}),
    "l1_loss": ("x", ["y"], {}),
    "smooth_l1_loss": ("x", ["y"], {"delta": 0.7}),
    "binary_cross_entropy": ("prob", ["binary"], {}),
    "binary_cross_entropy_weighted": ("prob", ["binary", "elem_w"], {}),
    "binary_cross_entropy_with_logits": ("x", ["binary"], {}),
    "binary_cross_entropy_with_logits_pos": ("x", ["binary", None],
                                             {"pos_weight": "pos_w"}),
    "kl_div": ("log_probs", ["target_dist"], {}),
    "margin_ranking_loss": ("x1", ["y1", "sign"], {"margin": 0.3}),
}
NO_REDUCTION = {
    "square_error_cost": ("x", ["y"], {}),
    "log_loss": ("prob", ["binary"], {"epsilon": 1e-4}),
    "hinge_loss": ("x", ["binary"], {}),
}


def _fn(mod, name):
    for suffix in ("_weighted", "_pos"):
        name = name.replace(suffix, "")
    return getattr(mod, name)


def _run(name, spec, reduction, data):
    arg, others, kw = spec
    jkw = {k: (jnp.asarray(data[v]) if isinstance(v, str) and v in data
               else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(data[v]) if isinstance(v, str) and v in data
               else v) for k, v in kw.items()}
    if reduction is not None:
        jkw["reduction"] = tkw["reduction"] = reduction
    jo = [None if o is None else jnp.asarray(data[o]) for o in others]
    to = [None if o is None else torch.from_numpy(data[o]) for o in others]
    jf, tf = _fn(JF, name), _fn(TF, name)
    ref = jf(jnp.asarray(data[arg]), *jo, **jkw)
    jgrad = jax.grad(lambda a: jnp.sum(jf(a, *jo, **jkw)))(
        jnp.asarray(data[arg]))
    x = torch.from_numpy(data[arg]).requires_grad_()
    got = tf(x, *to, **tkw)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_function_matches_jax(name, reduction):
    _run(name, CASES[name], reduction, _inputs())


def test_kl_div_batchmean():
    _run("kl_div", CASES["kl_div"], "batchmean", _inputs(1))


@pytest.mark.parametrize("name", sorted(NO_REDUCTION))
def test_unreduced_loss_function_matches_jax(name):
    _run(name, NO_REDUCTION[name], None, _inputs(2))


def _layer_cases(d):
    return {
        "CrossEntropyLoss": (dict(weight="weight", ignore_index=-100),
                             ["logits", "label"]),
        "MSELoss": ({}, ["x", "y"]),
        "L1Loss": ({}, ["x", "y"]),
        "SmoothL1Loss": (dict(delta=0.5), ["x", "y"]),
        "BCELoss": (dict(weight="elem_w"), ["prob", "binary"]),
        "BCEWithLogitsLoss": (dict(pos_weight="pos_w"), ["x", "binary"]),
        "NLLLoss": (dict(weight="weight"), ["log_probs", "label"]),
        "KLDivLoss": ({}, ["log_probs", "target_dist"]),
        "MarginRankingLoss": (dict(margin=0.2), ["x1", "y1", "sign"]),
    }


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name", sorted(_layer_cases(None)))
def test_loss_layer_matches_jax(name, reduction):
    data = _inputs(3)
    kw, args = _layer_cases(data)[name]
    jkw = {k: jnp.asarray(data[v]) if isinstance(v, str) else v
           for k, v in kw.items()}
    tkw = {k: torch.from_numpy(data[v]) if isinstance(v, str) else v
           for k, v in kw.items()}
    jl = getattr(jnn, name)(reduction=reduction, **jkw)
    tl = getattr(tnn, name)(reduction=reduction, **tkw)
    ref = jl(*[jnp.asarray(data[a]) for a in args])
    got = tl(*[torch.from_numpy(data[a]) for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
