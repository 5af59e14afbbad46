"""fleet's DistributedOptimizer in one process against the JAX package's on
the same gradients and state (the scenarios of tests/test_parallel_core.py
:191-304 and tests/test_fleet_dgc.py), and the strategy surface.

Parameters after every update are held at rtol 1e-6 / atol 1e-7 (fp32 updates
in another order: 0 difference in most cases), the loss scale, the good
step count and the merge counter exactly.  One process has no dp group,
so in both packages the owned sync, DGC's average and LocalSGD's average
are not issued (the multi-rank routes are in test_torch_fleet_dp.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as JO
from paddle_tpu.parallel import fleet as JF
import paddle_tpu_torch.optimizer as TO
from paddle_tpu_torch.parallel import fleet as TF

RTOL, ATOL = 1e-6, 1e-7
SHAPES = {"w": (8, 4), "b": (4,)}


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0, 1, s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(step, bad=False):
    rng = np.random.default_rng(100 + step)
    g = {k: rng.normal(0, 0.5, s).astype(np.float32)
         for k, s in SHAPES.items()}
    if bad:
        g["w"][1, 2] = np.inf
    return g


def _strategy(mod, **kw):
    s = mod.DistributedStrategy()
    for k, v in kw.items():
        obj, _, attr = k.rpartition("__")
        setattr(getattr(s, obj) if obj else s, attr, v)
    return s


def _run(jopt, topt, steps, bad=()):
    """Both optimizers over the same gradients; yields after each step."""
    jp = {k: jnp.asarray(v) for k, v in _params().items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in _params().items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(steps):
        g = _grads(i, bad=i in bad)
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp)
        tp, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=f"{i} {k}")
        yield i, js, ts


def _pair(inner, strategy_kw, **inner_kw):
    j = JF.DistributedOptimizer(getattr(JO, inner)(**inner_kw),
                                _strategy(JF, **strategy_kw))
    t = TF.DistributedOptimizer(getattr(TO, inner)(**inner_kw),
                                _strategy(TF, **strategy_kw))
    return j, t


@pytest.mark.parametrize("inner", ["SGD", "Adam"])
@pytest.mark.parametrize("avg", [True, False])
def test_gradient_merge(inner, avg):
    j, t = _pair(inner, {"gradient_merge": True,
                         "gradient_merge_configs__k_steps": 2,
                         "gradient_merge_configs__avg": avg},
                 learning_rate=0.1)
    for i, js, ts in _run(j, t, 5):
        assert ts["acc_count"] == int(js["acc_count"])


@pytest.mark.parametrize("inner", ["SGD", "Adam", "Momentum"])
def test_dynamic_loss_scale_skips_non_finite_steps(inner):
    """Steps 1 and 2 carry an inf: skipped (parameters and slots kept), the
    scale halved each time; two good steps in a row double it."""
    j, t = _pair(inner, {"amp": True,
                         "amp_configs__use_dynamic_loss_scaling": True,
                         "amp_configs__init_loss_scaling": 8.0,
                         "amp_configs__incr_every_n_steps": 2},
                 learning_rate=0.05)
    for i, js, ts in _run(j, t, 7, bad=(1, 2)):
        assert float(ts["loss_scale"]) == float(js["loss_scale"]), i
        assert ts["good_steps"] == int(js["good_steps"]), i
        assert ts["inner"]["step"] == int(js["inner"]["step"]), i


def test_loss_scale_with_gradient_merge():
    j, t = _pair("Adam", {"amp": True,
                          "amp_configs__use_dynamic_loss_scaling": True,
                          "amp_configs__init_loss_scaling": 4.0,
                          "gradient_merge": True,
                          "gradient_merge_configs__k_steps": 2},
                 learning_rate=0.05)
    for i, js, ts in _run(j, t, 6, bad=(2,)):
        assert ts["acc_count"] == int(js["acc_count"])
        assert float(ts["loss_scale"]) == float(js["loss_scale"])


@pytest.mark.parametrize("swap,cls", [("lamb", "Lamb"),
                                      ("lars", "LarsMomentum")])
def test_lamb_and_lars_swap_keep_the_scheduler(swap, cls):
    def sched(mod):
        return mod.lr.StepDecay(learning_rate=0.1, step_size=2, gamma=0.5)

    j = JF.DistributedOptimizer(JO.Adam(learning_rate=sched(JO)),
                                _strategy(JF, **{swap: True}))
    t = TF.DistributedOptimizer(TO.Adam(learning_rate=sched(TO)),
                                _strategy(TF, **{swap: True}))
    assert type(t.inner).__name__ == cls == type(j.inner).__name__
    assert isinstance(t.inner._lr, TO.lr.LRScheduler)
    for _ in _run(j, t, 5):
        pass


@pytest.mark.parametrize("rampup", [0, 2])
@pytest.mark.parametrize("inner", ["Momentum", "SGD"])
def test_dgc(rampup, inner):
    """Momentum is swapped for SGD with its momentum folded into the
    compression; before ``rampup_begin_step`` plain momentum SGD, then
    top-k with error feedback: velocity and error against the JAX state."""
    kw = dict(learning_rate=0.05)
    if inner == "Momentum":
        kw["momentum"] = 0.8
    j, t = _pair(inner, {"dgc": True, "dgc_configs__sparsity": 0.75,
                         "dgc_configs__rampup_begin_step": rampup}, **kw)
    assert type(t.inner).__name__ == "SGD"
    assert t._dgc_momentum == j._dgc_momentum
    moved = []
    for i, js, ts in _run(j, t, 5):
        for slot in ("velocity", "error"):
            for k in SHAPES:
                np.testing.assert_allclose(
                    ts["dgc"][slot][k].numpy(),
                    np.asarray(js["dgc"][slot][k]), rtol=RTOL, atol=ATOL)
    if rampup == 0:
        p0 = {k: torch.from_numpy(v.copy()) for k, v in _params().items()}
        s0 = t.init(p0)
        before = {k: v.clone() for k, v in p0.items()}
        t.update({k: torch.from_numpy(v) for k, v in _grads(0).items()},
                 s0, p0)
        moved = int((p0["w"] != before["w"]).sum())
        assert moved == 8      # the top quarter of 32


def test_localsgd_in_one_process_is_the_inner_optimizer():
    j, t = _pair("Momentum", {"localsgd": True,
                              "localsgd_configs__k_steps": 2},
                 learning_rate=0.1)
    bare = JO.Momentum(learning_rate=0.1)
    jp = {k: jnp.asarray(v) for k, v in _params().items()}
    bs = bare.init(jp)
    for i, js, ts in _run(j, t, 4):
        jp, bs = bare.update({k: jnp.asarray(v) for k, v in
                              _grads(i).items()}, bs, jp)


@pytest.mark.parametrize("flag,item", [("sharding", "8b"), ("pipeline", "8b"),
                                       ("sequence_parallel", "8b"),
                                       ("elastic", "8c")])
def test_later_strategies_raise(flag, item):
    """Item 8b's switches are taken (text.pretrainer reads them); the
    elastic configuration still raises, naming item 8c."""
    s = _strategy(TF, **{flag: True})
    if item == "8b":
        TF.DistributedOptimizer(TO.SGD(0.1), s)
        TF._not_in_this_slice(s)
        return
    with pytest.raises(NotImplementedError, match=item):
        TF.DistributedOptimizer(TO.SGD(0.1), s)
    with pytest.raises(NotImplementedError, match=item):
        TF.Fleet().init(strategy=s)


def test_plan_helpers_and_bad_quantize():
    s = TF.DistributedStrategy()
    assert TF.embedding_plan_kwargs(s) == JF.embedding_plan_kwargs(
        JF.DistributedStrategy()) == {}
    assert TF.auto_shard_plan(None, s) is None
    s.sharded_embedding = s.auto_shard = True
    with pytest.raises(NotImplementedError, match="9b"):
        TF.embedding_plan_kwargs(s)
    with pytest.raises(NotImplementedError, match="9b"):
        TF.auto_shard_plan(None, s)
    s = TF.DistributedStrategy()
    s.comm_quantize = "int4"
    with pytest.raises(ValueError, match="comm_quantize"):
        TF.DistributedOptimizer(TO.SGD(0.1), s)
    assert repr(TF.DistributedStrategy()) == repr(JF.DistributedStrategy())


def test_step_facade_uses_the_parameters_gradients():
    lin = torch.nn.Linear(4, 2)
    opt = TF.DistributedOptimizer(TO.SGD(0.5, parameters=lin.parameters()),
                                  TF.DistributedStrategy())
    with pytest.raises(ValueError, match="backward"):
        opt.step()
    w0 = lin.weight.detach().clone()
    lin(torch.ones(3, 4)).sum().backward()
    opt.step()
    torch.testing.assert_close(lin.weight.detach(),
                               w0 - 0.5 * torch.full((2, 4), 3.0))
    assert opt.state_dict()["state"]["inner"]["step"] == 1
