"""The port's Executor with the static checkers wired in, against the JAX
package's: a program the JAX Executor refuses (``check_program``) raises
``ProgramVerificationError`` from the port's with the same diagnostics,
and runs on to the raw failure with the flag off; a predicted OOM
(``check_memory``) raises before the run; the verified pass pipeline rolls
back the rewrites the JAX package's rolls back (a fetch whose inferred
dtype or shape changed, a rewritten program the walker refuses); and the
walk releases each intermediate after its last reader, with fetches bit for
bit what they are when nothing is released."""
import weakref

import numpy as np
import pytest

import paddle_tpu.static as jstatic
import paddle_tpu_torch.static as tstatic
from paddle_tpu.core import errors as jerrors
from paddle_tpu.core import flags as jflags
from paddle_tpu_torch.core import errors as terrors
from paddle_tpu_torch.core import flags as tflags
from tests import torch_static_checks as K

ERRORS = {jstatic: jerrors, tstatic: terrors}
FLAGS = {jstatic: jflags, tstatic: tflags}


def _exe(S):
    return S.Executor() if S is jstatic else S.Executor("cpu")


def _broken(S, kind):
    p = S.Program()
    b = p.global_block()
    b.create_var(name="x", shape=(2,), is_data=True)
    b.create_var(name="out", shape=(2,))
    if kind == "unknown_op":
        b.append_op("not_a_real_op", {"X": ["x"]}, {"Out": ["out"]})
    elif kind == "ghost_read":
        b.create_var(name="mid", shape=(2,))
        b.append_op("relu", {"X": ["ghost"]}, {"Out": ["mid"]})
        b.append_op("elementwise_add", {"X": ["mid"], "Y": ["x"]},
                    {"Out": ["out"]})
    elif kind == "shape_clash":
        b.create_var(name="y", shape=(3,), is_data=True)
        b.append_op("elementwise_add", {"X": ["x"], "Y": ["y"]},
                    {"Out": ["out"]})
    return p


@pytest.mark.parametrize("kind,code", [("unknown_op", "PV003"),
                                       ("ghost_read", "PV001"),
                                       ("shape_clash", "PV009")])
def test_executor_verifies_by_default(kind, code):
    feed = {"x": np.zeros(2, np.float32), "y": np.zeros(3, np.float32)}
    got = []
    for S in K.PKGS:
        p = _broken(S, kind)
        with pytest.raises(ERRORS[S].ProgramVerificationError) as ei:
            _exe(S).run(p, feed={k: v for k, v in feed.items()
                                 if p.global_block().has_var(k)},
                        fetch_list=["out"])
        assert code in str(ei.value)
        assert isinstance(ei.value, ValueError)
        got.append(K.diag_keys(ei.value.diagnostics))
    assert got[1] == got[0]
    assert got[1][0][0] == code


def test_executor_check_program_flag_disables():
    p = _broken(tstatic, "unknown_op")
    tflags.set_flags({"check_program": False})
    try:
        with pytest.raises(NotImplementedError, match="no lowering"):
            _exe(tstatic).run(p, feed={"x": np.zeros(2, np.float32)},
                              fetch_list=["out"])
    finally:
        tflags.set_flags({"check_program": True})


def test_a_steady_state_step_does_not_walk_the_program(monkeypatch):
    from paddle_tpu_torch.static import analysis

    main, startup, loss = K.build(tstatic, K.fc_tower, "adam")
    exe, scope = _exe(tstatic), tstatic.Scope()
    exe.run(startup, scope=scope)
    walks = []
    real = analysis.verify_program
    monkeypatch.setattr(analysis, "verify_program",
                        lambda *a, **k: walks.append(1) or real(*a, **k))
    feed = {"x": np.ones((4, 32), np.float32),
            "y": np.ones((4, 1), np.float32)}
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert len(walks) == 1
    # a second Executor's cold entry finds the memo on the program
    _exe(tstatic).run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert len(walks) == 1


def test_executor_front_runs_mc001():
    """A capacity the program's estimate exceeds raises MC001 before the
    first op; with check_memory off the same call runs."""
    for S in K.PKGS:
        main, startup, loss = K.build(S, K.fc_tower, "sgd")
        exe, scope = _exe(S), S.Scope()
        exe.run(startup, scope=scope)
        feed = {"x": np.zeros((16, 32), np.float32),
                "y": np.zeros((16, 1), np.float32)}
        saved = FLAGS[S].get_flags(["memcheck_capacity_gb", "check_memory"])
        FLAGS[S].set_flags({"memcheck_capacity_gb": 1e-6})
        try:
            with pytest.raises(ERRORS[S].ProgramVerificationError) as ei:
                exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            assert [d.code for d in ei.value.diagnostics] == ["MC001"]
            FLAGS[S].set_flags({"check_memory": False})
            (out,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            assert np.isfinite(out).all()
        finally:
            FLAGS[S].set_flags(saved)


def test_predicted_peak_gauge_set_before_the_run():
    from paddle_tpu_torch.static import memcheck
    from paddle_tpu_torch.utils import monitor

    main, startup, loss = K.build(tstatic, K.fc_tower, "sgd")
    exe, scope = _exe(tstatic), tstatic.Scope()
    exe.run(startup, scope=scope)
    saved = tflags.get_flag("metrics")
    tflags.set_flags({"metrics": True})
    try:
        exe.run(main, feed={"x": np.zeros((16, 32), np.float32),
                            "y": np.zeros((16, 1), np.float32)},
                fetch_list=[loss], scope=scope)
    finally:
        tflags.set_flags({"metrics": saved})
    est = memcheck.estimate_peak(main, feeds={"x": (16, 32), "y": (16, 1)},
                                 fetch_list=[loss.name])
    gauge = monitor.default_registry().get("executor.predicted_peak_bytes")
    assert est.peak_bytes in [v for _l, v in gauge.samples()]


# -- the verified pass pipeline ------------------------------------------------

def _scale_chain(S, L):
    x = L.data("x", [4])
    return L.scale(L.scale(x, 2.0), -1.0)


def _cast_fetch(program, ctx):
    """Rewrite the fetch producer into a cast to int32: still produced, but
    the fetch's inferred dtype changes."""
    blk = program.global_block()
    last = blk.ops[-1]
    blk.replace_op(len(blk.ops) - 1, "cast", {"X": last.inputs["X"]},
                   {"Out": last.outputs["Out"]}, {"out_dtype": "int32"})
    return {"changed": True}


def _ghost_read(program, ctx):
    """Point the first op at a name nothing writes: the fetch is still
    produced, but the walker refuses the program (PV001)."""
    blk = program.global_block()
    blk.ops[0].inputs["X"] = ["ghost"]
    return {"changed": True}


@pytest.mark.parametrize("rewrite,code", [(_cast_fetch, "PV011"),
                                          (_ghost_read, "PV001")])
def test_a_rewrite_the_jax_package_rolls_back_is_rolled_back(rewrite,
                                                             code):
    import importlib

    for S in K.PKGS:
        P = importlib.import_module(S.__name__ + ".passes")

        class _Bad(P.Pass):
            name = "bad_rewrite"

            def run(self, program, ctx):
                return rewrite(program, ctx)

        main, _, out = K.build(S, _scale_chain)
        P._REGISTRY["bad_rewrite"] = _Bad()
        try:
            with pytest.raises(ERRORS[S].ProgramVerificationError) as ei:
                P.PassManager(("bad_rewrite",)).apply(
                    main, feed_names={"x"}, fetch_names=[out.name])
            assert code in [d.code for d in ei.value.diagnostics]
            prog, fp = P.optimize_for_executor(main, "bad_rewrite", {"x"},
                                               [out.name])
            assert prog is main and fp == ""
        finally:
            del P._REGISTRY["bad_rewrite"]


def test_verify_rewrite_checks_shapes_and_dtypes():
    from paddle_tpu_torch.static import passes as P

    main, _, out = K.build(tstatic, _scale_chain)
    P.verify_rewrite(main, main.clone(), feed_names={"x"},
                     fetch_names=[out.name])
    broken = main.clone()
    _cast_fetch(broken, None)
    with pytest.raises(terrors.ProgramVerificationError,
                       match="inferred dtype") as ei:
        P.verify_rewrite(main, broken, feed_names={"x"},
                         fetch_names=[out.name])
    assert [d.code for d in ei.value.diagnostics] == ["PV011"]


# -- dead intermediates --------------------------------------------------------

def test_an_intermediate_is_freed_after_its_last_reader(monkeypatch):
    from paddle_tpu_torch.static import registry

    main, _ = tstatic.Program(), tstatic.Program()
    with tstatic.program_guard(main):
        L = tstatic.layers
        x = L.data("x", [64])
        a = L.scale(x, 2.0)            # read by relu only
        b = L.relu(a)
        c = L.sigmoid(b)
        out = L.scale(c, 3.0)
    refs, seen = {}, []
    real_relu = registry._REGISTRY["relu"]
    real_sigmoid = registry._REGISTRY["sigmoid"]

    def relu(ins, attrs, op):
        refs["a"] = weakref.ref(ins["X"][0])
        return real_relu(ins, attrs, op)

    def sigmoid(ins, attrs, op):
        seen.append(refs["a"]() is None)
        return real_sigmoid(ins, attrs, op)

    monkeypatch.setitem(registry._REGISTRY, "relu", relu)
    monkeypatch.setitem(registry._REGISTRY, "sigmoid", sigmoid)
    feed = {"x": np.ones((2, 64), np.float32)}
    (got,) = _exe(tstatic).run(main, feed=feed, fetch_list=[out])
    assert seen == [True]
    np.testing.assert_allclose(got, 3 / (1 + np.exp(-2.0)), rtol=1e-6)
    # what liveness keeps: the feed, the fetch, and nothing else lingers
    exe = _exe(tstatic)
    entry = exe._entry(main, feed, [out.name])
    released = {n for names in entry.release for n in names}
    assert {a.name, b.name, c.name} <= released
    assert not {"x", out.name} & released


@pytest.mark.parametrize("which", ["fit_a_line", "resnet", "mt_decode"])
def test_release_leaves_fetches_bit_for_bit(which, monkeypatch):
    """The same steps with release and with an empty release plan give
    identical fetches and state (training, a sub-block-heavy decode)."""
    from paddle_tpu_torch.static import executor as texec
    from tests import test_torch_static_book as book

    builder = {"fit_a_line": book._fit_a_line, "resnet": book._resnet,
               "mt_decode": book._mt_decode}[which]
    feeds = {"fit_a_line": lambda: {"x": np.ones((8, 13), np.float32),
                                    "y": np.ones((8, 1), np.float32)},
             "resnet": lambda: {
                 "pixel": np.random.default_rng(0).normal(
                     0, 1, (4, 3, 16, 16)).astype(np.float32),
                 "label": np.arange(4, dtype=np.int64).reshape(4, 1) % 10},
             "mt_decode": book._mt_batch}
    runs = []
    for release in (True, False):
        if not release:
            monkeypatch.setattr(texec, "release_plan",
                                lambda block, keep: [()] * len(block.ops))
        main, startup, fetches = K.build(tstatic, builder)
        main.random_seed = startup.random_seed = 5
        exe, scope = _exe(tstatic), tstatic.Scope()
        exe.run(startup, scope=scope)
        feed = feeds[which]()
        feed = {k: v for k, v in feed.items()
                if main.global_block().has_var(k)}
        outs = [exe.run(main, feed=feed, fetch_list=list(fetches),
                        scope=scope) for _ in range(2)]
        state = {k: texec.to_numpy(scope.find_var(k)) for k in scope.keys()}
        runs.append((outs, state))
    (o1, s1), (o2, s2) = runs
    for a, b in zip(o1, o2):
        for x, y in zip(a, b):
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
    assert s1.keys() == s2.keys()
    for k in s1:
        assert s1[k].tobytes() == s2[k].tobytes(), k
