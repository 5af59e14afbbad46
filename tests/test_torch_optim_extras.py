"""The long-tail optimizers and parameter averages (``optimizer/extras``),
the port against the JAX package on the CPU, step by step on the same
gradients: ``Ftrl``, ``Dpsgd``, ``dgc_compress`` / ``DGCMomentum``,
``ExponentialMovingAverage``, ``ModelAverage`` and ``Lookahead``, and
their state carried across by ``convert.optimizer_state_from_jax``.

Held: parameters and slots at rtol 1e-5 (atol 1e-7) after each step.
``Dpsgd`` at sigma 0 bit for bit where the clip does not bind (its noise
comes from ``jax.random`` there and cannot match a torch draw); with noise
by the draw's moments and by repeating under one seed.  DGC runs on
normal draws (no ties at the top-k threshold).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as JO
import paddle_tpu_torch as P
from paddle_tpu_torch import convert
from paddle_tpu_torch import optimizer as TO

SHAPES = {"a.weight": (5, 4), "b": (7,), "c.bias": (3, 2, 2)}
RTOL, ATOL = 1e-5, 1e-7


@pytest.fixture(autouse=True)
def _cpu():
    with P.device_guard("cpu"):
        yield


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _close(t, j, rtol=RTOL, atol=ATOL):
    for k in SHAPES:
        np.testing.assert_allclose(t[k].detach().numpy(), np.asarray(j[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def _run(make, steps=4, grad_scale=1.0, convert_at=None):
    """``steps`` updates of the JAX and the port optimizer on the same
    gradients; with ``convert_at`` the port's state is rebuilt from the
    JAX state after that step."""
    jopt, topt = make(JO), make(TO)
    p0 = _tree(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(steps):
        g = _tree(100 + i, grad_scale)
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp)
        tp, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
        _close(tp, jp)
        if convert_at == i:
            ts = convert.optimizer_state_from_jax(js, tp)
    return jp, tp, js, ts


@pytest.mark.parametrize("l1,l2,power", [(0.0, 0.0, -0.5), (0.05, 0.1, -0.5),
                                         (0.01, 0.0, -0.3)])
def test_ftrl(l1, l2, power):
    _, _, js, ts = _run(lambda O: O.Ftrl(0.1, l1, l2, power), convert_at=1)
    np.testing.assert_allclose(ts["per_param"]["b"]["squared"].numpy(),
                               np.asarray(js["per_param"][1]["squared"]),
                               rtol=RTOL)


def test_dpsgd_at_sigma_zero_bit_for_bit():
    jp, tp, _, _ = _run(lambda O: O.Dpsgd(0.05, 1e6, 16, 0.0))
    for k in SHAPES:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    _run(lambda O: O.Dpsgd(0.05, 0.5, 16, 0.0))      # the clip binds


def test_dpsgd_noise_moments_and_repetition():
    def one(seed):
        opt = TO.Dpsgd(1.0, 1e6, 4, 2.0, seed=seed)
        p = {"w": torch.zeros(200, 200)}
        g = {"w": torch.zeros(200, 200)}
        opt.update(g, opt.init(p), p)
        return p["w"].clone()

    a, b, c = one(3), one(3), one(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # two parameters of one size draw different noise
    opt = TO.Dpsgd(1.0, 1e6, 4, 2.0)
    p = {"u": torch.zeros(50), "v": torch.zeros(50)}
    opt.update({k: torch.zeros(50) for k in p}, opt.init(p), p)
    assert not torch.equal(p["u"], p["v"])
    std = 2.0 * 1e6 / 4                      # sigma clip / batch_size
    assert abs(float(a.mean())) < 0.02 * std
    assert abs(float(a.std()) / std - 1.0) < 0.02


def test_dgc_compress():
    rng = np.random.default_rng(5)
    g, v, e = (rng.normal(size=(6, 5)).astype(np.float32) for _ in range(3))
    ref = JO.dgc_compress(g, v, e, 0.8, 0.9)
    got = TO.dgc_compress(*(torch.from_numpy(a) for a in (g, v, e)), 0.8,
                          0.9)
    for r, t in zip(ref, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)
    assert int((got[0] != 0).sum()) == int(30 * (1 - 0.8))   # k, 5


@pytest.mark.parametrize("rampup,nesterov", [(0, False), (3, False),
                                             (3, True)])
def test_dgc_momentum(rampup, nesterov):
    _, _, js, ts = _run(lambda O: O.DGCMomentum(0.1, 0.9, None, 0.7, rampup,
                                                nesterov), steps=5,
                        convert_at=2)
    np.testing.assert_allclose(ts["per_param"]["a.weight"]["error"].numpy(),
                               np.asarray(js["per_param"][0]["error"]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cls,args", [("ExponentialMovingAverage", (0.9,)),
                                      ("ExponentialMovingAverage",
                                       (0.5, False)),
                                      ("ModelAverage", (0.15, 2, 3))])
def test_parameter_averages(cls, args):
    j, t = getattr(JO, cls)(*args), getattr(TO, cls)(*args)
    with pytest.raises(RuntimeError):
        t.apply()
    for i in range(5):
        p = _tree(i)
        js = j.update({k: jnp.asarray(v) for k, v in p.items()})
        ts = t.update({k: torch.from_numpy(v) for k, v in p.items()})
        _close(ts, js)
        if i == 2:
            st = convert.optimizer_state_from_jax(j.state_dict(),
                                                  t.apply())
            t.set_state_dict(st)
    assert t.state_dict()["step"] == 5
    _close(t.apply(), j.apply())


def test_lookahead_functional_and_eager():
    _run(lambda O: O.Lookahead(O.Adam(0.01), 0.5, 3), steps=7, convert_at=3)
    # the eager facade over the inner optimizer's parameters takes the
    # functional path's steps
    p0 = _tree(0)
    params = [torch.from_numpy(v.copy()).requires_grad_()
              for v in p0.values()]
    eager = TO.Lookahead(TO.Adam(0.01, parameters=params), 0.5, 3)
    func = TO.Lookahead(TO.Adam(0.01), 0.5, 3)
    fp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    fs = func.init(fp)
    for i in range(7):
        g = _tree(100 + i)
        for p, v in zip(params, g.values()):
            p.grad = torch.from_numpy(v)
        eager.minimize(None)
        eager.clear_grad()
        fp, fs = func.update({k: torch.from_numpy(v) for k, v in g.items()},
                             fs, fp)
        for p, k in zip(params, SHAPES):
            assert torch.equal(p.detach(), fp[k]), (i, k)
    assert eager.get_lr() == 0.01 and fs["step"] == 7


def test_lookahead_eager_takes_the_jax_state():
    """The eager facade loads ``optimizer_state_from_jax``'s Lookahead
    state (slow weights and Adam slots matched to the bound parameters by
    position) and goes on as the JAX optimizer does, across a merge; its
    own ``state_dict()`` loads back into a fresh facade."""
    jopt = JO.Lookahead(JO.Adam(0.01), 0.5, 3)
    p0 = _tree(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jopt.init(jp)

    def jax_step(i):
        nonlocal jp, js
        g = _tree(100 + i)
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp)
        return g

    for i in range(4):
        jax_step(i)
    params = [torch.from_numpy(np.asarray(jp[k]).copy()).requires_grad_()
              for k in SHAPES]
    eager = TO.Lookahead(TO.Adam(0.01, parameters=params), 0.5, 3)
    eager.set_state_dict(convert.optimizer_state_from_jax(
        js, dict(zip(SHAPES, params))))
    for i in range(4, 7):
        g = jax_step(i)
        for p, k in zip(params, SHAPES):
            p.grad = torch.from_numpy(g[k])
        eager.minimize(None)
        eager.clear_grad()
        _close(dict(zip(SHAPES, params)), jp)
    sd = eager.state_dict()
    assert sd["step"] == 7 and sd["inner"]["step"] == 7
    assert set(sd["slow"]) == {"0", "1", "2"}
    for name, k in zip(sd["slow"], SHAPES):
        np.testing.assert_allclose(sd["slow"][name].numpy(),
                                   np.asarray(js["slow"][k]), rtol=RTOL,
                                   atol=ATOL)
    again = TO.Lookahead(TO.Adam(0.01, parameters=params), 0.5, 3)
    again.set_state_dict(sd)
    assert again.state_dict()["step"] == 7
    with pytest.raises(ValueError):
        again.set_state_dict(dict(sd, slow={"0": sd["slow"]["0"]}))
