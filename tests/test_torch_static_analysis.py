"""The port's program verifier (paddle_tpu_torch/static/analysis.py)
against the JAX package's: the same programs, built with each package's
IR and DSL (the minimal bad program of each PV code from
tests/test_analysis.py, its well-formed and symbolic-engine programs, and
the book programs of tests/test_torch_static_book.py), give the same
diagnostics — code, severity, block, op index, op type, variable, message
and hint, exactly — and ``infer_program`` the same shape and dtype for
every variable (symbols compared by their order of first appearance)."""
import numpy as np
import pytest

import paddle_tpu.static as jstatic
import paddle_tpu_torch.static as tstatic
from paddle_tpu.static import control_flow as jcf
from paddle_tpu_torch.static import control_flow as tcf
from tests import test_torch_static_book as book

PKGS = ((jstatic, jcf), (tstatic, tcf))


def _diag_key(d):
    return (d.code, d.severity, d.block, d.op_index, d.op_type, d.var,
            d.message, d.hint)


def _canon_shapes(engine):
    """{name: (shape with symbols renumbered, dtype name)} in a stable
    order, so two engines' symbols compare by structure."""
    from paddle_tpu.static.analysis import _known as jknown

    ids, out = {}, {}
    for name in sorted(engine.shapes):
        shape = engine.shapes[name]
        if shape is not None:
            shape = tuple(int(d) if jknown(d)
                          else "s%d" % ids.setdefault(id(d), len(ids))
                          for d in shape)
        dt = engine.dtypes.get(name)
        out[name] = (shape, None if dt is None else str(dt))
    return out


def _same_analysis(build, **kw):
    """Build with each package (``build(S, cf)`` returns (main, startup or
    None, verify kwargs)); both verifiers must agree."""
    res = []
    for S, cf in PKGS:
        # fresh name counters: both packages name the temporaries alike
        S.framework._unique.counters = {}
        main, startup, extra = build(S, cf)
        diags, engine = S.infer_program(main, startup, **{**kw, **extra})
        res.append(([_diag_key(d) for d in diags], _canon_shapes(engine)))
    (jd, js), (td, ts) = res
    assert td == jd
    assert ts == js
    return jd


def _prog(S, *vars_, ops=()):
    p = S.Program()
    b = p.global_block()
    for name, shape, kw in vars_:
        b.create_var(name=name, shape=shape, **kw)
    for op in ops:
        b.append_op(*op)
    return p


D = {"is_data": True}


def _pv001(S, cf):
    return _prog(S, ("out", (2,), {}),
                 ops=[("relu", {"X": ["ghost"]}, {"Out": ["out"]})]), None, {}


def _pv001_order(S, cf):
    return _prog(S, ("x", (2,), D), ("a", (2,), {}), ("out", (2,), {}),
                 ops=[("relu", {"X": ["a"]}, {"Out": ["out"]}),
                      ("sigmoid", {"X": ["x"]}, {"Out": ["a"]})]), None, {}


def _pv001_unfed(S, cf):
    p = _prog(S, ("x", (2,), D), ("out", (2,), {}),
              ops=[("relu", {"X": ["x"]}, {"Out": ["out"]})])
    return p, None, {"feed_names": set(), "fetch_names": ["out"]}


def _pv002(S, cf):
    p = _prog(S, ("x", (2,), D), ("dead", (2,), {}), ("out", (2,), {}),
              ops=[("relu", {"X": ["x"]}, {"Out": ["dead"]}),
                   ("sigmoid", {"X": ["x"]}, {"Out": ["out"]})])
    return p, None, {"fetch_names": ["out"]}


def _one_op(op_type, attrs=None):
    def build(S, cf):
        return _prog(S, ("x", (2,), D), ("out", (2,), {}),
                     ops=[(op_type, {"X": ["x"]}, {"Out": ["out"]},
                           attrs or {})]), None, {}
    return build


def _pv005(S, cf):
    return _prog(S, ("c", (1,), D), ("out", (1,), {}),
                 ops=[("conditional_block", {"Cond": ["c"]},
                       {"Out": ["out"]}, {"true_block": 99})]), None, {}


def _pv006(S, cf):
    p = S.Program()
    p._create_block()
    p._rollback()
    b = p.global_block()
    b.create_var(name="x", shape=(2,), is_data=True)
    b.create_var(name="out", shape=(2,))
    b.append_op("relu", {"X": ["x"]}, {"Out": ["out"]}, {"my_body_block": 1})
    return p, None, {}


def _pv007(S, cf):
    return _prog(S, ("w@GRAD", (2,), {})), None, {}


def _pv008(S, cf):
    main, startup = S.Program(), S.Program()
    with S.program_guard(main, startup):
        S.layers.data("x", [4])
        main.global_block().create_parameter("w", (4, 2))
        main.global_block().create_var(name="out", shape=(-1, 2))
        main.global_block().append_op("mul", {"X": ["x"], "Y": ["w"]},
                                      {"Out": ["out"]})
        S.layers.create_parameter((4, 2), name="w2")
    return main, startup, {}


def _pv009_mul(S, cf):
    return _prog(S, ("x", (4, 3), D), ("y", (5, 2), D), ("out", (4, 2), {}),
                 ops=[("mul", {"X": ["x"], "Y": ["y"]}, {"Out": ["out"]},
                       {"x_num_col_dims": 1, "y_num_col_dims": 1})]), None, {}


def _pv009_bcast(shape_y):
    def build(S, cf):
        return _prog(S, ("x", (-1, 3) if shape_y == (3,) else (2, 3), D),
                     ("y", shape_y, D), ("out", (2, 3), {}),
                     ops=[("elementwise_add", {"X": ["x"], "Y": ["y"]},
                           {"Out": ["out"]})]), None, {}
    return build


def _pv009_labels(S, cf):
    return _prog(S, ("logits", (8, 10), D),
                 ("label", (8, 1), {"dtype": "float32", "is_data": True}),
                 ("out", (8, 1), {}),
                 ops=[("softmax_with_cross_entropy",
                       {"Logits": ["logits"], "Label": ["label"]},
                       {"Loss": ["out"]})]), None, {}


def _with_guard(fn):
    def build(S, cf):
        main, startup = S.Program(), S.Program()
        with S.program_guard(main, startup):
            extra = fn(S, S.layers, cf, main) or {}
        return main, startup, extra
    return build


def _training(S, L, cf, main):
    img = L.data("img", [784])
    label = L.data("label", [1], dtype="int64")
    h = L.fc(img, 64, act="relu")
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, 10), label))
    S.optimizer.Adam(learning_rate=1e-3).minimize(loss)


def _control_flow(S, L, cf, main):
    x = L.data("x", [2])
    pred = cf.less_than(L.reduce_sum(x), L.fill_constant([1], "float32", 0.0))
    out = cf.cond(pred, lambda: L.scale(x, scale=2.0),
                  lambda: L.scale(x, scale=-1.0))
    i = L.fill_constant([1], "int64", 0)
    limit = L.fill_constant([1], "int64", 4)
    s = L.fill_constant([1], "float32", 0.0)
    i2, s2 = cf.while_loop(lambda i, s: cf.less_than(i, limit),
                           lambda i, s: [cf.increment(i),
                                         s + L.reduce_sum(x)], [i, s])
    return {"feed_names": {"x"}, "fetch_names": [out.name, i2.name, s2.name]}


def _conv_chain(S, L, cf, main):
    img = L.data("img", [1, 28, 28])
    c = L.conv2d(img, num_filters=4, filter_size=3, padding=1, act="relu")
    p = L.pool2d(c, pool_size=2, pool_stride=2, pool_type="max")
    L.fc(L.reshape(p, [-1, 4 * 14 * 14]), 10)


def _wildcard_mismatch(S, L, cf, main):
    img = L.data("img", [2, 1, 28, 28], append_batch_size=False)
    p = L.pool2d(L.conv2d(img, num_filters=4, filter_size=3, padding=1),
                 pool_size=2, pool_stride=2)
    f = L.reshape(p, [2, -1])
    b = main.current_block()
    b.create_parameter("w_bad", (700, 10))
    b.create_var(name="mm", shape=(-1, 10))
    b.append_op("mul", {"X": [f.name], "Y": ["w_bad"]}, {"Out": ["mm"]},
                {"x_num_col_dims": 1, "y_num_col_dims": 1})


def _tail_families(S, L, cf, main):
    x = L.data("x", [16])
    L.tile(L.slice(x, axes=[1], starts=[0], ends=[8]), [1, 3])


CASES = {
    "pv001": (_pv001, ["PV001"]),
    "pv001_order": (_pv001_order, ["PV001"]),
    "pv001_unfed": (_pv001_unfed, ["PV001"]),
    "pv002": (_pv002, []),
    "pv003": (_one_op("sofmax"), ["PV003"]),
    "pv004": (_one_op("tensorrt_engine"), ["PV004"]),
    "pv005": (_pv005, ["PV005", "PV005"]),
    "pv006": (_pv006, ["PV006"]),
    "pv007": (_pv007, ["PV007"]),
    "pv008": (_pv008, ["PV008"]),
    "pv009_mul": (_pv009_mul, ["PV009"]),
    "pv009_bcast": (_pv009_bcast((2, 4)), ["PV009"]),
    "pv009_bcast_wildcard": (_pv009_bcast((3,)), []),
    "pv009_cast": (_one_op("cast"), ["PV009"]),
    "pv009_labels": (_pv009_labels, ["PV009"]),
    "training": (_with_guard(_training), []),
    "control_flow": (_with_guard(_control_flow), []),
    "conv_chain": (_with_guard(_conv_chain), []),
    "wildcard_mismatch": (_with_guard(_wildcard_mismatch),
                          ["PV008", "PV009"]),
    "tail_families": (_with_guard(_tail_families), []),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_diagnostics_and_shapes(name):
    build, errors = CASES[name]
    diags = _same_analysis(build)
    assert [d[0] for d in diags if d[1] == "error"] == errors
    if name == "pv002":
        assert [(d[0], d[5]) for d in diags] == [("PV002", "dead")]


def _book(builder):
    def build(S, cf):
        main, startup = S.Program(), S.Program()
        with S.program_guard(main, startup):
            builder(S, S.layers)
        return main, startup, {}
    return build


@pytest.mark.parametrize("name", ["fit_a_line", "word2vec", "resnet",
                                  "sentiment_conv", "sentiment_lstm", "srl",
                                  "mt_train", "mt_decode"])
def test_book_programs_verify_alike(name):
    builder = {"fit_a_line": book._fit_a_line, "word2vec": book._word2vec,
               "resnet": book._resnet,
               "sentiment_conv": lambda S, L: book._sentiment(S, L, False),
               "sentiment_lstm": lambda S, L: book._sentiment(S, L, True),
               "srl": book._srl, "mt_train": book._mt_train,
               "mt_decode": book._mt_decode}[name]
    diags = _same_analysis(_book(builder))
    assert not [d for d in diags if d[1] == "error"]


def test_shape_rule_coverage_matches():
    """Both registries are the same, so the engine covers the same ops."""
    assert tstatic.shape_rule_coverage() == jstatic.shape_rule_coverage()


def test_check_program_cached_memoizes_per_version():
    from paddle_tpu_torch.static import analysis
    from paddle_tpu_torch.utils import monitor

    p = _prog(tstatic, ("x", (2,), D), ("out", (2,), {}),
              ops=[("relu", {"X": ["x"]}, {"Out": ["out"]})])
    walks = monitor.counter("analysis.programs_checked")
    before = walks.value() if hasattr(walks, "value") else None
    first = analysis.check_program_cached(p, {"x"}, ["out"])
    assert analysis.check_program_cached(p, {"x"}, ["out"]) is first
    p.global_block().create_var(name="extra", shape=(1,))
    assert analysis.check_program_cached(p, {"x"}, ["out"]) is not first
    if before is not None:
        assert walks.value() == before + 2
    assert any(ref() is p for ref, *_ in analysis._PASSED_PROGRAMS)


def test_bf16_variables_name_and_size_like_the_jax_package():
    """numpy has no bfloat16: the port's stand-in names, compares and
    sizes as ml_dtypes' does in the JAX package."""
    from paddle_tpu_torch.core.dtype import BFLOAT16_NP, numpy_dtype
    import jax.numpy as jnp
    import torch

    ref = np.dtype(jnp.bfloat16)
    d = numpy_dtype(torch.bfloat16)
    assert d is BFLOAT16_NP and numpy_dtype("bfloat16") is d
    assert (str(d), d.kind, d.itemsize, repr(d)) == \
        (str(ref), ref.kind, ref.itemsize, repr(ref))
    _same_analysis(lambda S, cf: (_prog(
        S, ("x", (2, 3), {"dtype": "bfloat16", "is_data": True}),
        ("out", (2, 3), {}),
        ops=[("cast", {"X": ["x"]}, {"Out": ["out"]},
              {"out_dtype": "float32"})]), None, {}))
