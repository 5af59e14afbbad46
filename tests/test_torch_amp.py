"""The port's AMP (paddle_tpu_torch.amp) against the JAX package's, on the
CPU: the ``GradScaler`` dynamic loss-scale state machine over one sequence
of finite and non-finite gradients (the scale, both counters and which
updates were skipped, step by step, and the parameters the optimizer
reached), the ``.grad`` route, ``state_dict`` carried across, and the
value casts ``auto_cast`` / ``amp_cast`` / ``decorate``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import convert
from paddle_tpu_torch import optimizer as topt

# per step: None = finite gradients, else the element made non-finite
PATTERN = [None, None, np.inf, None, np.nan, -np.inf, None, None, None,
           np.inf, np.inf, np.inf, None, None, None, None, None]


def _grads(step, bad):
    rng = np.random.default_rng(step)
    g = [rng.normal(0, 1000.0, (3, 4)).astype(np.float32),
         rng.normal(0, 1000.0, (4,)).astype(np.float32)]
    if bad is not None:
        g[step % 2].flat[step % 4] = bad
    return g


def _scalers(mod):
    return mod.GradScaler(init_loss_scaling=1024.0, incr_ratio=2.0,
                          decr_ratio=0.5, incr_every_n_steps=3,
                          decr_every_n_nan_or_inf=2)


def test_grad_scaler_state_machine_matches_jax():
    rng = np.random.default_rng(0)
    p0 = [rng.normal(0, 1, (3, 4)).astype(np.float32),
          rng.normal(0, 1, (4,)).astype(np.float32)]
    js, ts = _scalers(jamp), _scalers(tamp)
    jo = jopt.SGD(0.001, parameters=None)
    jparams = [jnp.asarray(p) for p in p0]
    jstate = jo.init(jparams)
    tparams = [torch.from_numpy(p.copy()) for p in p0]
    to = topt.SGD(0.001, parameters=tparams)
    scales = set()
    for step, bad in enumerate(PATTERN):
        g = _grads(step, bad)
        ju = js.unscale_([jnp.asarray(x) for x in g])
        if not js._found_inf:
            jparams, jstate = jo.update(ju, jstate, jparams)
        ran = ts.step(to, [torch.from_numpy(x) for x in g])
        js.update()
        ts.update()
        assert ran == (bad is None) == (not js._found_inf), step
        assert ts.state_dict() == js.state_dict(), step
        assert ts.get_scale() == js.get_scale()
        scales.add(ts.get_scale())
    assert len(scales) >= 2
    for t, j in zip(tparams, jparams):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-6)


def test_grad_route_unscales_in_place_and_skips_non_finite():
    w = torch.nn.Parameter(torch.ones(4))
    opt = topt.SGD(0.5, parameters=[w])
    scaler = tamp.GradScaler(init_loss_scaling=64.0)
    loss = (w * torch.tensor([1.0, 2.0, 3.0, 4.0])).sum()
    scaler.scale(loss).backward()
    assert torch.equal(w.grad, torch.tensor([64.0, 128.0, 192.0, 256.0]))
    assert scaler.minimize(opt, loss) is True
    np.testing.assert_allclose(w.detach().numpy(), [0.5, 0.0, -0.5, -1.0])
    opt.clear_grad()
    loss = (w * torch.tensor([1.0, float("inf"), 3.0, 4.0])).sum()
    scaler.scale(loss).backward()
    before = w.detach().clone()
    assert scaler.step(opt) is False
    assert torch.equal(w.detach(), before)


def test_scaler_state_dict_carried_across():
    js = _scalers(jamp)
    for step, bad in enumerate(PATTERN[:6]):
        js.unscale_([jnp.asarray(x) for x in _grads(step, bad)])
        js.update()
    ts = _scalers(tamp)
    ts.load_state_dict(convert.grad_scaler_state_from_jax(js.state_dict()))
    assert ts.state_dict() == js.state_dict()
    for step, bad in enumerate(PATTERN[6:], 6):
        js.unscale_([jnp.asarray(x) for x in _grads(step, bad)])
        ts.unscale_([torch.from_numpy(x) for x in _grads(step, bad)])
        js.update()
        ts.update()
        assert ts.state_dict() == js.state_dict()


def test_disabled_scaler_is_the_identity():
    s = tamp.GradScaler(enable=False)
    loss = torch.tensor(3.0)
    assert s.scale(loss) is loss
    g = [torch.ones(2)]
    assert s.unscale_(g) is g
    assert not s.is_enable()


def test_auto_cast_is_a_value_cast():
    tree = {"w": torch.ones(2, 2), "ids": torch.ones(3, dtype=torch.int64),
            "pair": (torch.zeros(1, dtype=torch.float64), 1.5)}
    assert tamp.amp_cast(tree) is tree                 # autocast off
    with tamp.auto_cast(dtype="bfloat16"):
        assert tamp.amp_state().enabled
        out = tamp.amp_cast(tree)
        with tamp.amp_guard(enable=False):
            assert tamp.amp_cast(tree) is tree
    assert not tamp.amp_state().enabled
    assert out["w"].dtype == torch.bfloat16
    assert out["ids"].dtype == torch.int64
    assert out["pair"][0].dtype == torch.bfloat16 and out["pair"][1] == 1.5
    jout = jamp.amp_cast({"w": jnp.ones((2, 2))}, "bfloat16")
    assert str(jout["w"].dtype) == "bfloat16"
    assert tamp.amp_cast({"w": torch.ones(2)}, "float16")["w"].dtype \
        == torch.float16
    assert "matmul" in tamp.WHITE_LIST and "softmax" in tamp.BLACK_LIST
    assert tamp.WHITE_LIST == jamp.WHITE_LIST
    assert tamp.BLACK_LIST == jamp.BLACK_LIST


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_decorate(level):
    m = torch.nn.Linear(2, 2)
    opt = topt.Adam(parameters=m.parameters())
    out = tamp.decorate(m, opt, level=level)
    assert out == (m, opt)
    want = torch.bfloat16 if level == "O2" else torch.float32
    assert m.weight.dtype == want
    assert tamp.decorate([m], level="O1") == [m]
    with pytest.raises(ValueError):
        tamp.decorate(m, level="O3")
