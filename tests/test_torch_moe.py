"""``nn.MoEFFN`` and its gating against the JAX package's.

* ``switch_gating`` / ``top2_gating`` on the same gate probabilities
  (capacities that drop tokens and ones that keep all): ``dispatch``,
  ``combine`` and ``aux`` within 1e-6.
* ``MoEFFN`` (top-2 and top-1) with the same weights, ep=1 in this
  process: the output, the gradients of <cotangent, output> for the input
  and every weight, and the aux loss against ``jax.grad`` through the JAX
  layer (rtol 1e-5, atol 1e-6).
* ep=2 on 2 gloo ranks (the shared 2-rank job of
  tests/torch_parallel_job.py), each rank on half the batch with half
  the experts, tokens reaching their experts by all-to-all: each rank's
  output and input gradient against the JAX layer's rows, the gate's
  gradient summed over the ranks, each rank's expert gradients against
  the JAX ones of its experts, the aux loss (the whole batch's) -- at the
  same tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.nn.layer import moe as JM
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.nn.layer import moe as TMoE
from paddle_tpu_torch.parallel import mesh as TM
import torch_parallel_job as J

EXACT = 1e-6
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _no_mesh():
    old = TM.get_mesh()
    TM.set_mesh(None)
    yield
    TM.set_mesh(old)


def _gates(seed, b=3, s=10, e=4):
    logits = np.random.default_rng(seed).normal(0, 2, (b, s, e))
    g = np.exp(logits - logits.max(-1, keepdims=True))
    return (g / g.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("name", ["switch_gating", "top2_gating"])
@pytest.mark.parametrize("capacity", [2, 5, 20])
def test_gating_matches_jax(name, capacity):
    g = _gates(capacity)
    want = getattr(JM, name)(jnp.asarray(g), capacity)
    got = getattr(TMoE, name)(torch.from_numpy(g), capacity)
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=0,
                                   atol=EXACT)


def _jax_moe(top_k, x, ct):
    w, _, _ = J.moe_inputs()
    layer = jnn.MoEFFN(J.MOE["d"], J.MOE["f"], num_experts=J.MOE["experts"],
                       top_k=top_k, capacity_factor=J.MOE["capacity_factor"])
    params = {k: jnp.asarray(v) for k, v in w.items()}

    def fwd(p, x_):
        layer.gate_weight.value = p["gate_weight"]
        layer.wi.value, layer.wo.value = p["wi"], p["wo"]
        return layer.forward_with_aux(x_)

    (y, aux) = fwd(params, jnp.asarray(x))
    grads = jax.grad(lambda p, x_: jnp.sum(fwd(p, x_)[0] * ct),
                     argnums=(0, 1))(params, jnp.asarray(x))
    return (np.asarray(y), float(aux),
            {k: np.asarray(v) for k, v in grads[0].items()},
            np.asarray(grads[1]))


@pytest.fixture(scope="module")
def jax_moe():
    _, x, ct = J.moe_inputs()
    return {k: _jax_moe(k, x, jnp.asarray(ct)) for k in (2, 1)}


@pytest.mark.parametrize("top_k", [2, 1])
def test_moe_ffn_matches_jax_ep1(jax_moe, top_k):
    w, x, ct = J.moe_inputs()
    y, aux, gw, gx = jax_moe[top_k]
    layer = tnn.MoEFFN(J.MOE["d"], J.MOE["f"], J.MOE["experts"],
                       top_k=top_k, capacity_factor=J.MOE["capacity_factor"])
    layer.set_state_dict(w)
    xt = torch.from_numpy(x).requires_grad_()
    out = layer(xt)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), y, **TOL)
    np.testing.assert_allclose(layer.aux_loss.item(), aux, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), gx, **TOL)
    for k in ("gate_weight", "wi", "wo"):
        np.testing.assert_allclose(getattr(layer, k).grad.numpy(), gw[k],
                                   **TOL)
    assert layer.wi.sharding_axes == ("ep", None, "tp")
    assert layer.wo.sharding_axes == ("ep", "tp", None)


@pytest.fixture(scope="module")
def job():
    out, rc, log = J.pair_job()
    assert rc == 0, log[-4000:]
    return out


@pytest.mark.parametrize("top_k", [2, 1])
def test_moe_ffn_matches_jax_ep2(job, jax_moe, top_k):
    y, aux, gw, gx = jax_moe[top_k]
    half, e_half = J.MOE["batch"] // 2, J.MOE["experts"] // 2
    for r in range(2):
        got = J.result(job, "moe_ep2", r)
        rows = slice(r * half, (r + 1) * half)
        mine = slice(r * e_half, (r + 1) * e_half)
        tag = f"top{top_k}"
        np.testing.assert_allclose(got[f"{tag}/y"], y[rows], **TOL)
        np.testing.assert_allclose(got[f"{tag}/dx"], gx[rows], **TOL)
        np.testing.assert_allclose(got[f"{tag}/aux"], aux, **TOL)
        np.testing.assert_allclose(got[f"{tag}/dgate"], gw["gate_weight"],
                                   **TOL)
        np.testing.assert_allclose(got[f"{tag}/dwi"], gw["wi"][mine], **TOL)
        np.testing.assert_allclose(got[f"{tag}/dwo"], gw["wo"][mine], **TOL)


def test_moe_ffn_rejects_top3():
    with pytest.raises(ValueError, match="top_k"):
        tnn.MoEFFN(8, 16, 4, top_k=3)
    assert tnn.MoEFFN(8, 16, 4, capacity_factor=1.25).capacity(10) == \
        jnn.MoEFFN(8, 16, 4, capacity_factor=1.25).capacity(10)
