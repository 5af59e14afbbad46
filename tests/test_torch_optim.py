"""The port's optimizers (paddle_tpu_torch.optimizer) against the JAX
package's, on the CPU.

Each of the ten optimizers takes three steps from the same parameters and
gradients (numpy, from a seed) in both packages: plain, with weight decay
(the base's L2 decay; AdamW's, Lamb's and LARS's own), and under each of
the three clips.  Tolerances: fp32 parameters atol 1e-6 after the three
steps (as PR 2's Adam test); bf16 parameters within one bf16 ulp of the
JAX value, each step taken from the JAX package's state (the JAX update
promotes a bf16 parameter to fp32 wherever an fp32 operand meets it, so
its carried state leaves bf16; each step starts again from that state
rounded back, and the port's slots come from it through
``convert.optimizer_state_from_jax``).  Then the stateful facade:
``step(None)`` from ``.grad``, ``minimize``, ``clear_grad``,
``state_dict`` round trips, and a JAX state carried into the port
mid-run.  The parameter names are not in sorted order, so a conversion
by position would pair the wrong slots.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as J
import paddle_tpu_torch.optimizer as T
from paddle_tpu_torch import convert

SHAPES = {"w_out": (4, 5), "b_in": (5,), "k_mid": (3, 2, 2)}
ATOL = 1e-6

OPTIMIZERS = {
    "SGD": (dict(learning_rate=0.1), None),
    "Momentum": (dict(learning_rate=0.1, momentum=0.9), None),
    "Nesterov": (dict(learning_rate=0.1, momentum=0.9, use_nesterov=True),
                 None),
    "Adam": (dict(learning_rate=0.01), None),
    "AdamW": (dict(learning_rate=0.01), ("weight_decay", 0.05)),
    "Adamax": (dict(learning_rate=0.01), None),
    "Adagrad": (dict(learning_rate=0.1), None),
    "Adadelta": (dict(learning_rate=1.0), None),
    "RMSProp": (dict(learning_rate=0.01), None),
    "RMSPropCentered": (dict(learning_rate=0.01, momentum=0.5,
                             centered=True), None),
    "Lamb": (dict(learning_rate=0.01), ("lamb_weight_decay", 0.05)),
    "LarsMomentum": (dict(learning_rate=0.1), ("lars_weight_decay", 0.01)),
}
CLASS = {"Nesterov": "Momentum", "RMSPropCentered": "RMSProp"}
VARIANTS = ("plain", "decay", "clip_value", "clip_norm", "clip_global")


def _make(mod, name, variant):
    kw, own_decay = OPTIMIZERS[name]
    kw = dict(kw)
    if variant == "decay":
        if own_decay is None:
            kw["weight_decay"] = 0.01
        else:
            kw[own_decay[0]] = own_decay[1]
    clip = {"clip_value": lambda: mod.ClipGradByValue(0.5),
            "clip_norm": lambda: mod.ClipGradByNorm(1.0),
            "clip_global": lambda: mod.ClipGradByGlobalNorm(1.0)}.get(variant)
    if clip is not None:
        kw["grad_clip"] = clip()
    return getattr(mod, CLASS.get(name, name))(**kw)


def _data(seed=0, steps=3):
    rng = np.random.default_rng(seed)
    p0 = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(0, 1.5, s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    return p0, grads


def _bf16_ulp(a):
    e = np.floor(np.log2(np.maximum(np.abs(a), 1e-30)))
    return 2.0 ** (e - 7)


def _to_bf16(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_bf16(t) for t in tree)
    return tree.astype(jnp.bfloat16) if tree.dtype == jnp.float32 else tree


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_three_steps_fp32(name, variant):
    p0, grads = _data()
    jo, to = _make(J, name, variant), _make(T, name, variant)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        out, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ts, tp)
        assert out is tp
    assert ts["step"] == int(js["step"]) == 3
    for k in SHAPES:
        assert tp[k].dtype == torch.float32
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_each_step_bf16_within_one_ulp(name, variant):
    p0, grads = _data(1)
    jo, to = _make(J, name, variant), _make(T, name, variant)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p0.items()}
    js = jo.init(jp)
    for g in grads:
        tp = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
            torch.bfloat16) for k, v in jp.items()}
        ts = convert.optimizer_state_from_jax(js, tp)
        jg = {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in g.items()}
        jp, js = jo.update(jg, js, jp)
        to.update(tg, ts, tp)
        for k in SHAPES:
            assert tp[k].dtype == torch.bfloat16
            ref = np.asarray(jp[k], np.float32)
            got = tp[k].float().numpy()
            assert (np.abs(got - ref) <= _bf16_ulp(ref)).all(), (
                k, np.abs(got - ref).max())
        jp = {k: v.astype(jnp.bfloat16) for k, v in jp.items()}
        js = {"per_param": [_to_bf16(s) if isinstance(s, jnp.ndarray)
                            and s.dtype == jnp.float32
                            and CLASS.get(name, name) == "Momentum" else s
                            for s in js["per_param"]],
              "step": js["step"]}


@pytest.mark.parametrize("name", ["SGD", "Adam", "AdamW", "Lamb"])
def test_state_from_jax_mid_run(name):
    """Two JAX steps, the state carried into the port by name, the third
    step in the port: equal to JAX's third step."""
    p0, grads = _data(2)
    jo, to = _make(J, name, "clip_global"), _make(T, name, "clip_global")
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jo.init(jp)
    for g in grads[:2]:
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    ts = convert.optimizer_state_from_jax(js, tp)
    assert list(ts["per_param"]) == list(tp) and ts["step"] == 2
    jp, js = jo.update({k: jnp.asarray(v) for k, v in grads[2].items()},
                       js, jp)
    to.update({k: torch.from_numpy(v) for k, v in grads[2].items()}, ts, tp)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=ATOL, err_msg=k)


def test_state_from_jax_checks_counts_and_shapes():
    p0, _ = _data()
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    js = J.Adam().init({k: jnp.asarray(v) for k, v in p0.items()})
    with pytest.raises(ValueError):
        convert.optimizer_state_from_jax(
            {"per_param": js["per_param"][:2], "step": js["step"]}, tp)
    bad = dict(tp, b_in=torch.zeros(7))
    with pytest.raises(ValueError):
        convert.optimizer_state_from_jax(js, bad)


class _Model(torch.nn.Module):
    def __init__(self, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.a = torch.nn.Parameter(torch.randn(4, 3, generator=g))
        self.b = torch.nn.Parameter(torch.randn(3, generator=g))
        self.unused = torch.nn.Parameter(torch.randn(2, generator=g))

    def forward(self, x):
        return torch.tanh(x @ self.a + self.b).square().sum()


@pytest.mark.parametrize("name", ["Momentum", "AdamW", "Lamb"])
def test_step_from_grad_skips_gradless_and_equals_explicit(name):
    x = torch.randn(5, 4, generator=torch.Generator().manual_seed(3))
    m1, m2 = _Model(), _Model()
    o1 = _make(T, name, "clip_global")
    o1._parameters = list(m1.parameters())
    o2 = _make(T, name, "clip_global")
    for _ in range(2):
        m1(x).backward()
        o1.step()
        o1.clear_grad()
        assert all(p.grad is None for p in m1.parameters())
        loss = m2(x)
        ga, gb = torch.autograd.grad(loss, [m2.a, m2.b])
        params = {"a": m2.a.data, "b": m2.b.data}
        if o2._state is None:
            o2._state = o2.init(params)
        o2.update({"a": ga, "b": gb}, o2._state, params)
    assert o1._step_count == 2 and o1._state["step"] == 2
    assert torch.equal(m1.a, m2.a) and torch.equal(m1.b, m2.b)
    assert torch.equal(m1.unused, _Model().unused)        # no gradient
    with pytest.raises(ValueError):
        o1.step()                                          # none left


def test_minimize_applies_backward_gradients_and_returns_empty_lists():
    x = torch.randn(5, 4, generator=torch.Generator().manual_seed(4))
    m1, m2 = _Model(), _Model()
    o1 = T.SGD(0.1, parameters=m1.parameters())
    o2 = T.SGD(0.1, parameters=m2.parameters())
    loss = m1(x)
    loss.backward()
    assert o1.minimize(loss) == ([], [])
    m2(x).backward()
    o2.step([m2.a.grad, m2.b.grad, torch.zeros(2)])
    assert torch.equal(m1.a, m2.a) and torch.equal(m1.b, m2.b)


def test_state_dict_round_trip_and_lr_access():
    sched = T.lr.LinearWarmup(T.lr.PolynomialDecay(0.1, 20, end_lr=0.0),
                              5, 0.0, 0.1)
    m = _Model()
    opt = T.Adam(sched, parameters=m.parameters(), weight_decay=0.01)
    x = torch.randn(5, 4, generator=torch.Generator().manual_seed(5))
    m(x).backward()
    opt.step()
    sd = opt.state_dict()
    assert sd["step"] == 1 and sd["state"]["step"] == 1
    assert opt.get_lr() == sched.get_lr_at(1)
    assert opt.get_lr(7) == sched.get_lr_at(7)
    other = T.Adam(sched, parameters=m.parameters())
    other.set_state_dict(sd)
    assert other.state_dict()["step"] == 1
    assert other.state_dict()["state"] is sd["state"]
    opt.set_lr(0.5)
    assert opt.get_lr() == 0.5
    jopt = J.Adam(J.lr.LinearWarmup(J.lr.PolynomialDecay(0.1, 20,
                                                         end_lr=0.0),
                                    5, 0.0, 0.1))
    jopt._step_count = 1
    assert float(jopt.get_lr()) == float(other.get_lr())


def test_scheduler_lr_is_taken_at_step_plus_one():
    """Inside ``update`` the LR is the scheduler's at state["step"] + 1, as
    in the JAX package; with a scheduler, SGD's first step uses lr(1)."""
    sched = T.lr.LinearWarmup(0.5, 4, 0.0, 0.5)
    p = {"w": torch.ones(3)}
    opt = T.SGD(sched)
    st = opt.init(p)
    opt.update({"w": torch.ones(3)}, st, p)
    lr1 = float(sched.get_lr_at(1))
    np.testing.assert_allclose(p["w"].numpy(), 1 - lr1, rtol=1e-7)
    jp = {"w": jnp.ones(3)}
    jo = J.SGD(J.lr.LinearWarmup(0.5, 4, 0.0, 0.5))
    jp, _ = jo.update({"w": jnp.ones(3)}, jo.init(jp), jp)
    np.testing.assert_allclose(p["w"].numpy(), np.asarray(jp["w"]),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("clip", ["value", "norm", "global"])
def test_clips_keep_structure_and_dtype(clip):
    p0, grads = _data(6)
    mk = {"value": lambda m: m.ClipGradByValue(0.3, -0.2),
          "norm": lambda m: m.ClipGradByNorm(0.7),
          "global": lambda m: m.GradientClipByGlobalNorm(0.7)}[clip]
    got = mk(T)({k: torch.from_numpy(v).to(torch.bfloat16)
                 for k, v in grads[0].items()})
    ref = mk(J)({k: jnp.asarray(v, jnp.bfloat16) for k, v in grads[0].items()})
    assert list(got) == list(grads[0])
    for k in SHAPES:
        assert got[k].dtype == torch.bfloat16
        r = np.asarray(ref[k], np.float32)
        assert (np.abs(got[k].float().numpy() - r) <= _bf16_ulp(r)).all(), k
    lst = mk(T)([torch.from_numpy(v) for v in grads[0].values()])
    assert isinstance(lst, list) and len(lst) == len(SHAPES)
