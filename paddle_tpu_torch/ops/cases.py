"""Inputs for every exported op of the library at a small size, as numpy
data, so that one table drives both checks of the op library: the CPU
parity test against the JAX package (``tests/test_torch_ops.py``) and the
card-against-CPU phase of ``chip_smoke.py``.

``FUNCTIONAL_CASES`` is the same for the ``nn.functional`` functions that
take plain arrays (the recurrent runners, which take cells, are held by
their own tests).

Each ``Case`` is ``(name, family, make, check)``: ``make(rng)`` returns
``(args, kwargs)`` of numpy arrays, Python scalars, lists and tuples
(``to_framework`` turns the arrays into one framework's tensors);
``family`` says how two runs are compared:

* ``exact``: data movement, integers, booleans and creation: equal values;
* ``float``: floating results within ``TOLERANCE["float"]``;
* ``linalg``: solves and inverses within ``TOLERANCE["linalg"]``;
* ``attention``: the flash-attention op, whose kernel on the card sums in
  another order, within ``TOLERANCE["attention"]``;
* ``cubic``: bicubic interpolation, whose Keys weights are sums of terms
  near 6 that cancel to below 1, within ``TOLERANCE["cubic"]`` (1e-5 of
  the unit-scale inputs);
* ``decomp``: decompositions whose signs and order are free, held by
  ``check(args, outputs) -> error`` (a reconstruction or an invariant,
  relative) and the part their definition fixes;
* ``random``: draws, held by ``check(args, output) -> bool`` (shape and
  range) and by repeating under one seed.
"""
from __future__ import annotations

import collections
import math

import numpy as np

Case = collections.namedtuple("Case", "name family make check")

# (rtol, atol) of each compared family
TOLERANCE = {"float": (1e-5, 1e-6), "linalg": (1e-4, 1e-5),
             "attention": (1e-4, 1e-5), "cubic": (1e-5, 1e-5)}


def _f(rng, *shape, lo=-2.0, hi=2.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _i(rng, *shape, lo=0, hi=10):
    return rng.integers(lo, hi, shape).astype(np.int32)


def _b(rng, *shape):
    return rng.random(shape) < 0.5


def _spd(rng, n):
    a = _f(rng, n, n)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def _nan(rng, *shape):
    x = _f(rng, *shape)
    x.flat[::3] = np.nan
    return x


def to_framework(obj, convert):
    """``obj`` with every numpy array passed through ``convert`` (lists
    and tuples kept)."""
    if isinstance(obj, np.ndarray):
        return convert(np.array(obj))
    if isinstance(obj, list):
        return [to_framework(o, convert) for o in obj]
    if isinstance(obj, tuple):
        return tuple(to_framework(o, convert) for o in obj)
    if isinstance(obj, dict):
        return {k: to_framework(v, convert) for k, v in obj.items()}
    return obj


def leaves(out):
    """An op's output as a flat list (tuples and lists flattened)."""
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in leaves(o)]
    return [out]


# -- decomposition checks: numpy outputs, a relative error -------------------

def _rel(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _check_svd(args, out):
    a = args[0]
    u, s, vh = out
    return max(_rel(u @ np.diag(s) @ vh, a),
               float(np.any(np.diff(s) > 0)))


def _check_qr(args, out):
    a = args[0]
    q, r = out
    return max(_rel(q @ r, a), _rel(q.T @ q, np.eye(q.shape[1])),
               float(np.abs(np.tril(r, -1)).max()))


def _check_eig(args, out):
    a = args[0]
    w, v = out
    return _rel(a @ v, v * w[None, :])


def _check_eigvals(args, out):
    ref = np.linalg.eigvals(args[0].astype(np.float64))
    key = lambda z: np.lexsort((np.round(z.imag, 4), np.round(z.real, 4)))
    return _rel(out[key(out)], ref[key(ref)])


def _check_eigh(args, out):
    a = args[0]
    w, v = out
    return max(_rel(a @ v, v * w[None, :]), float(np.any(np.diff(w) < 0)))


CASES = []


def _add(name, family, make, check=None):
    CASES.append(Case(name, family, make, check))


# -- creation ----------------------------------------------------------------
_add("to_tensor", "exact", lambda r: (([[1.5, 2.0], [3.0, 4.0]],), {}))
_add("to_tensor", "exact", lambda r: ((_i(r, 2, 3),), {"dtype": "float32"}))
_add("full", "exact", lambda r: (((2, 3), 1.5), {}))
_add("zeros", "exact", lambda r: (((2, 3),), {}))
_add("ones", "exact", lambda r: (((2, 3),), {"dtype": "int32"}))
_add("zeros_like", "exact", lambda r: ((_f(r, 2, 3),), {}))
_add("ones_like", "exact", lambda r: ((_i(r, 2, 3),), {}))
_add("full_like", "exact", lambda r: ((_f(r, 2, 3), 7.0), {}))
_add("empty", "exact", lambda r: (((3, 2),), {}))
_add("empty_like", "exact", lambda r: ((_f(r, 2, 2),), {}))
_add("arange", "exact", lambda r: ((0, 10, 2), {}))
_add("arange", "float", lambda r: ((0.0, 1.0, 0.25), {}))
_add("linspace", "float", lambda r: ((0.0, 1.0, 5), {}))
_add("eye", "exact", lambda r: ((3, 4), {}))
_add("meshgrid", "exact", lambda r: ((_f(r, 3), _f(r, 2)), {}))
_add("diag", "exact", lambda r: ((_f(r, 3), 1, 5.0), {}))
_add("diag", "exact", lambda r: ((_f(r, 3, 3), -1), {}))
_add("tril", "exact", lambda r: ((_f(r, 3, 4), -1), {}))
_add("triu", "exact", lambda r: ((_f(r, 3, 4), 1), {}))
_add("assign", "exact", lambda r: ((_f(r, 2, 3),), {}))

# -- manipulation ------------------------------------------------------------
_add("reshape", "exact", lambda r: ((_f(r, 2, 3, 4), [4, -1]), {}))
_add("transpose", "exact", lambda r: ((_f(r, 2, 3, 4), [2, 0, 1]), {}))
_add("cast", "exact", lambda r: ((_f(r, 2, 3, lo=-9, hi=9), "int32"), {}))
_add("cast", "exact", lambda r: ((_i(r, 2, 3), "bool"), {}))
_add("concat", "exact", lambda r: (([_f(r, 2, 3), _f(r, 2, 2)], 1), {}))
_add("stack", "exact", lambda r: (([_f(r, 2, 3), _f(r, 2, 3)], 1), {}))
_add("unstack", "exact", lambda r: ((_f(r, 2, 3), 1), {}))
_add("unbind", "exact", lambda r: ((_f(r, 3, 2),), {}))
_add("split", "exact", lambda r: ((_f(r, 6, 4), [2, -1, 1]), {}))
_add("split", "exact", lambda r: ((_f(r, 4, 6), 3, 1), {}))
_add("chunk", "exact", lambda r: ((_f(r, 7, 3), 3), {}))
_add("squeeze", "exact", lambda r: ((_f(r, 2, 1, 3, 1), [1, 3]), {}))
_add("squeeze", "exact", lambda r: ((_f(r, 1, 3, 1),), {}))
_add("unsqueeze", "exact", lambda r: ((_f(r, 2, 3), [0, 2]), {}))
_add("flatten", "exact", lambda r: ((_f(r, 2, 3, 4), 1, 2), {}))
_add("flip", "exact", lambda r: ((_f(r, 3, 4), [0, 1]), {}))
_add("roll", "exact", lambda r: ((_f(r, 3, 4), 2, 1), {}))
_add("roll", "exact", lambda r: ((_f(r, 3, 4), 5), {}))
_add("tile", "exact", lambda r: ((_f(r, 2, 3), [2, 1]), {}))
_add("expand", "exact", lambda r: ((_f(r, 1, 3), [4, -1]), {}))
_add("expand_as", "exact", lambda r: ((_f(r, 1, 3), _f(r, 4, 3)), {}))
_add("broadcast_to", "exact", lambda r: ((_f(r, 3), [2, 3]), {}))
_add("slice", "exact", lambda r: ((_f(r, 4, 5), [0, 1], [1, 0], [3, 4]), {}))
_add("gather", "exact", lambda r: ((_f(r, 5, 3), _i(r, 2, 2, hi=5)), {}))
_add("gather", "exact", lambda r: ((_f(r, 3, 6), _i(r, 4, hi=6), 1), {}))
_add("gather_nd", "exact", lambda r: ((_f(r, 4, 5), np.array(
    [[0, 1], [3, 4], [2, 2]], np.int32)), {}))
_add("index_select", "exact", lambda r: ((_f(r, 5, 3), _i(r, 4, hi=3), 1),
                                         {}))
_add("masked_select", "exact", lambda r: ((_f(r, 3, 4), _b(r, 3, 4)), {}))
_add("put_along_axis", "exact", lambda r: ((_f(r, 3, 4), np.array(
    [[0, 2], [1, 3], [3, 0]], np.int32), 9.0, 1), {}))
_add("put_along_axis", "float", lambda r: ((_f(r, 3, 4), np.array(
    [[0, 2], [1, 3], [3, 0]], np.int32), _f(r, 3, 2), 1, "add"), {}))
_add("put_along_axis", "float", lambda r: ((_f(r, 3, 4), np.array(
    [[0, 2], [1, 3], [3, 0]], np.int32), _f(r, 3, 2), 1, "multiply"), {}))
_add("repeat_interleave", "exact", lambda r: ((_f(r, 2, 3), 2, 1), {}))
_add("repeat_interleave", "exact", lambda r: ((_f(r, 2, 2), 2), {}))
_add("scatter", "exact", lambda r: ((_f(r, 5, 3), np.array([1, 3], np.int32),
                                     _f(r, 2, 3)), {}))
_add("scatter", "float", lambda r: ((_f(r, 5, 3), np.array(
    [1, 3, 1], np.int32), _f(r, 3, 3), False), {}))
_add("scatter_nd_add", "float", lambda r: ((_f(r, 4, 5), np.array(
    [[0, 1], [3, 4], [0, 1]], np.int32), _f(r, 3)), {}))
_add("take_along_axis", "exact", lambda r: ((_f(r, 3, 4), _i(r, 3, 2, hi=4),
                                             1), {}))
_add("unique", "exact", lambda r: ((np.array([[3, 1, 3], [2, 2, 5]],
                                              np.int32), True, True, True),
                                   {}))
_add("unique", "exact", lambda r: ((_i(r, 8, hi=4),), {}))

# -- math ----------------------------------------------------------------------
for _n in ("add", "subtract", "multiply", "maximum", "minimum"):
    _add(_n, "float", lambda r: ((_f(r, 3, 4), _f(r, 4)), {}))
    _add(_n, "exact", lambda r: ((_i(r, 3, 4), _i(r, 3, 4)), {}))
_add("add", "float", lambda r: ((_f(r, 3), 2.5), {}))
_add("multiply", "exact", lambda r: ((_i(r, 3), 3), {}))
_add("divide", "float", lambda r: ((_f(r, 3, 4), _f(r, 3, 4, lo=0.5)), {}))
_add("divide", "float", lambda r: ((_i(r, 3, 4), _i(r, 3, 4, lo=1)), {}))
for _n in ("floor_divide", "mod", "remainder"):
    _add(_n, "float", lambda r: ((_f(r, 3, 4, lo=-5, hi=5),
                                  _f(r, 3, 4, lo=0.5, hi=2)), {}))
    _add(_n, "exact", lambda r: ((_i(r, 3, 4, lo=-9), _i(r, 3, 4, lo=1)),
                                 {}))
_add("pow", "float", lambda r: ((_f(r, 3, 4, lo=0.5), _f(r, 3, 4)), {}))
_add("pow", "float", lambda r: ((_f(r, 3, 4), 2.0), {}))
_add("pow", "exact", lambda r: ((_i(r, 3, 4), 2), {}))
_add("fmax", "float", lambda r: ((_nan(r, 3, 4), _f(r, 3, 4)), {}))
_add("fmin", "float", lambda r: ((_nan(r, 3, 4), _f(r, 3, 4)), {}))
_add("lerp", "float", lambda r: ((_f(r, 3, 4), _f(r, 3, 4), 0.3), {}))
for _n in ("abs", "ceil", "floor", "trunc", "sign", "square"):
    _add(_n, "exact", lambda r: ((_f(r, 3, 4, lo=-5, hi=5),), {}))
_add("round", "exact", lambda r: ((np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.4,
                                             3.6], np.float32),), {}))
_add("abs", "exact", lambda r: ((_i(r, 3, lo=-5),), {}))
for _n in ("exp", "expm1", "sin", "cos", "tan", "sinh", "cosh", "tanh",
           "erf", "stanh"):
    _add(_n, "float", lambda r: ((_f(r, 3, 4),), {}))
for _n in ("log", "log1p", "log2", "log10", "sqrt", "rsqrt", "reciprocal"):
    _add(_n, "float", lambda r: ((_f(r, 3, 4, lo=0.1, hi=4),), {}))
_add("sqrt", "float", lambda r: ((_i(r, 5, lo=1),), {}))
_add("stanh", "float", lambda r: ((_f(r, 4), 0.5, 2.0), {}))
_add("logit", "float", lambda r: ((_f(r, 3, 4, lo=0.01, hi=0.99),), {}))
_add("logit", "float", lambda r: ((_f(r, 4, lo=0.0, hi=1.0), 1e-3), {}))
_add("clip", "exact", lambda r: ((_f(r, 3, 4), -0.5, 0.5), {}))
_add("clip", "exact", lambda r: ((_f(r, 3, 4), None, 0.5), {}))
_add("scale", "float", lambda r: ((_f(r, 3, 4), 2.0, 1.0), {}))
_add("scale", "float", lambda r: ((_f(r, 3, 4), 2.0, 1.0, False), {}))
for _n in ("isnan", "isinf", "isfinite"):
    _add(_n, "exact", lambda r: ((np.array([1.0, np.nan, np.inf, -np.inf, 0.0],
                                           np.float32),), {}))
_add("sum", "float", lambda r: ((_f(r, 3, 4, 5), 1, None, True), {}))
_add("sum", "float", lambda r: ((_f(r, 3, 4),), {}))
_add("sum", "exact", lambda r: ((_i(r, 3, 4), [0, 1]), {}))
_add("nansum", "float", lambda r: ((_nan(r, 3, 4), 1), {}))
_add("mean", "float", lambda r: ((_f(r, 3, 4, 5), [0, 2]), {}))
_add("mean", "float", lambda r: ((_f(r, 3, 4), None, True), {}))
_add("nanmean", "float", lambda r: ((_nan(r, 3, 4), 0), {}))
_add("prod", "float", lambda r: ((_f(r, 3, 4), 1), {}))
_add("prod", "float", lambda r: ((_f(r, 2, 3),), {}))
for _n in ("max", "min", "amax", "amin"):
    _add(_n, "exact", lambda r: ((_f(r, 3, 4, 2), 1), {}))
    _add(_n, "exact", lambda r: ((_f(r, 3, 4), None, True), {}))
_add("std", "float", lambda r: ((_f(r, 3, 5), 1), {}))
_add("var", "float", lambda r: ((_f(r, 3, 5), None, False), {}))
_add("std", "float", lambda r: ((_f(r, 3, 5), 0, True, True), {}))
_add("all", "exact", lambda r: ((_b(r, 3, 4), 1), {}))
_add("all", "exact", lambda r: ((_b(r, 3, 4),), {}))
_add("any", "exact", lambda r: ((_b(r, 3, 4), 0, True), {}))
_add("any", "exact", lambda r: ((_b(r, 3, 4),), {}))
_add("logsumexp", "float", lambda r: ((_f(r, 3, 4), 1), {}))
_add("logsumexp", "float", lambda r: ((_f(r, 3, 4),), {}))
_add("logcumsumexp", "float", lambda r: ((_f(r, 3, 4), 1), {}))
_add("logcumsumexp", "float", lambda r: ((_f(r, 3, 4),), {}))
_add("cumsum", "float", lambda r: ((_f(r, 3, 4), 0), {}))
_add("cumsum", "exact", lambda r: ((_i(r, 3, 4),), {}))
_add("cumprod", "float", lambda r: ((_f(r, 3, 4), 1), {}))
_add("add_n", "float", lambda r: (([_f(r, 2, 3), _f(r, 2, 3), _f(r, 2, 3)],),
                                  {}))
_add("matmul", "linalg", lambda r: ((_f(r, 2, 3, 4), _f(r, 2, 5, 4), False,
                                     True), {}))
_add("matmul", "linalg", lambda r: ((_f(r, 4, 3), _f(r, 4, 5), True), {}))
_add("matmul", "linalg", lambda r: ((_f(r, 3, 4), _f(r, 4)), {}))
_add("mm", "linalg", lambda r: ((_f(r, 3, 4), _f(r, 4, 5)), {}))
_add("bmm", "linalg", lambda r: ((_f(r, 2, 3, 4), _f(r, 2, 4, 5)), {}))
_add("dot", "float", lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {}))
_add("outer", "float", lambda r: ((_f(r, 3), _f(r, 4)), {}))
_add("kron", "float", lambda r: ((_f(r, 2, 2), _f(r, 2, 3)), {}))
_add("addmm", "linalg", lambda r: ((_f(r, 3, 5), _f(r, 3, 4), _f(r, 4, 5),
                                    0.5, 2.0), {}))
_add("einsum", "linalg", lambda r: (("ij,jk->ik", _f(r, 3, 4), _f(r, 4, 2)),
                                    {}))
_add("einsum", "linalg", lambda r: (("bij,bkj->bik", _f(r, 2, 3, 4),
                                     _f(r, 2, 5, 4)), {}))
_add("trace", "float", lambda r: ((_f(r, 4, 5), 1), {}))
_add("allclose", "exact", lambda r: ((np.ones(3, np.float32),
                                      np.ones(3, np.float32) + 1e-7), {}))
_add("allclose", "exact", lambda r: ((_f(r, 3), _f(r, 3)), {}))

# -- logic -------------------------------------------------------------------
for _n in ("equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal"):
    _add(_n, "exact", lambda r: ((_i(r, 3, 4, hi=3), _i(r, 3, 4, hi=3)), {}))
    _add(_n, "exact", lambda r: ((_f(r, 3, 4), 0.0), {}))
_add("equal_all", "exact", lambda r: ((np.arange(4), np.arange(4)), {}))
_add("equal_all", "exact", lambda r: ((np.arange(4), np.arange(4)[::-1]),
                                      {}))
for _n in ("logical_and", "logical_or", "logical_xor"):
    _add(_n, "exact", lambda r: ((_b(r, 3, 4), _b(r, 3, 4)), {}))
_add("logical_not", "exact", lambda r: ((_b(r, 3, 4),), {}))
for _n in ("bitwise_and", "bitwise_or", "bitwise_xor"):
    _add(_n, "exact", lambda r: ((_i(r, 3, 4, hi=64), _i(r, 3, 4, hi=64)), {}))
_add("bitwise_not", "exact", lambda r: ((_i(r, 3, 4, hi=64),), {}))
_add("bitwise_and", "exact", lambda r: ((_b(r, 4), _b(r, 4)), {}))
_add("where", "exact", lambda r: ((_b(r, 3, 4), _f(r, 3, 4), _f(r, 3, 4)),
                                  {}))
_add("where", "exact", lambda r: ((_b(r, 3, 4),), {}))
_add("where", "exact", lambda r: ((_b(r, 3), _f(r, 3), 0.0), {}))
_add("is_empty", "exact", lambda r: ((np.zeros((0, 3), np.float32),), {}))
_add("is_empty", "exact", lambda r: ((_f(r, 2),), {}))

# -- search ------------------------------------------------------------------
_add("argmax", "exact", lambda r: ((_f(r, 3, 5), 1), {}))
_add("argmax", "exact", lambda r: ((_f(r, 3, 5), None, True), {}))
_add("argmax", "exact", lambda r: ((_f(r, 3, 5),), {"dtype": "int32"}))
_add("argmin", "exact", lambda r: ((_f(r, 3, 5), 0, True), {}))
_add("argmin", "exact", lambda r: ((_f(r, 3, 5),), {}))
_add("argsort", "exact", lambda r: ((_f(r, 3, 5), 1, True), {}))
_add("argsort", "exact", lambda r: ((_f(r, 4, 3), 0), {}))
_add("sort", "exact", lambda r: ((_f(r, 3, 5),), {}))
_add("sort", "exact", lambda r: ((_f(r, 3, 5), 0, True), {}))
_add("topk", "exact", lambda r: ((_f(r, 3, 6), 2), {}))
_add("topk", "exact", lambda r: ((_f(r, 5, 3), 2, 0, False), {}))
_add("kthvalue", "exact", lambda r: ((_f(r, 3, 6), 2), {}))
_add("kthvalue", "exact", lambda r: ((_f(r, 5, 3), 3, 0, True), {}))
_add("mode", "exact", lambda r: ((np.array([[1, 2, 2, 3, 3], [4, 4, 1, 1, 0]],
                                           np.int32),), {}))
_add("mode", "exact", lambda r: ((np.array([[1.0, 5.0], [2.0, 5.0],
                                            [2.0, 1.0]], np.float32), 0, True),
                                 {}))
_add("nonzero", "exact", lambda r: ((_i(r, 3, 4, hi=3),), {}))
_add("nonzero", "exact", lambda r: ((_i(r, 3, 4, hi=3), True), {}))
_add("searchsorted", "exact", lambda r: ((np.array([1.0, 2.0, 2.0, 5.0],
                                                   np.float32),
                                          np.array([0.5, 2.0, 6.0],
                                                   np.float32)), {}))
_add("searchsorted", "exact", lambda r: ((np.array([1, 3, 5], np.int32),
                                          np.array([3, 4], np.int32), True,
                                          True), {}))
_add("masked_fill", "exact", lambda r: ((_f(r, 3, 4), _b(r, 3, 4), 0.5), {}))
_add("index_sample", "exact", lambda r: ((_f(r, 3, 5), _i(r, 3, 2, hi=5)),
                                         {}))

# -- random: (args, output) -> whether the draw has the right shape / range --
_add("uniform", "random", lambda r: (((300, 4), "float32", -1.0, 2.0), {}),
     lambda a, o: o.shape == (300, 4) and o.min() >= -1 and o.max() < 2)
_add("uniform", "random", lambda r: (((50,),), {"seed": 7}),
     lambda a, o: o.shape == (50,) and o.min() >= -1 and o.max() < 1)
_add("rand", "random", lambda r: (((300, 4),), {}),
     lambda a, o: o.shape == (300, 4) and o.min() >= 0 and o.max() < 1)
_add("standard_normal", "random", lambda r: (((4000,),), {}),
     lambda a, o: o.shape == (4000,) and abs(o.mean()) < 0.1
     and abs(o.std() - 1) < 0.1)
_add("randn", "random", lambda r: (((2, 3),), {}),
     lambda a, o: o.shape == (2, 3) and o.dtype.kind == "f")
_add("normal", "random", lambda r: ((1.0, 2.0, (4000,)), {}),
     lambda a, o: o.shape == (4000,) and abs(o.mean() - 1) < 0.2
     and abs(o.std() - 2) < 0.2)
_add("randint", "random", lambda r: ((0, 5, (300, 4)), {}),
     lambda a, o: o.shape == (300, 4) and o.dtype.kind == "i"
     and o.min() == 0 and o.max() == 4)
_add("randint", "random", lambda r: ((7,), {}),
     lambda a, o: o.shape == (1,) and 0 <= o.min() and o.max() < 7)
_add("randperm", "random", lambda r: ((10,), {}),
     lambda a, o: sorted(o.tolist()) == list(range(10)))
_add("bernoulli", "random", lambda r: ((np.full((400, 4), 0.3, np.float32),),
                                       {}),
     lambda a, o: o.shape == (400, 4) and set(np.unique(o)) <= {0.0, 1.0}
     and abs(o.mean() - 0.3) < 0.06)
_add("multinomial", "random", lambda r: ((np.array(
    [[0.1, 0.0, 0.9], [0.5, 0.5, 0.0]], np.float32), 2), {}),
     lambda a, o: o.shape == (2, 2) and o[0].tolist().count(1) == 0
     and 2 not in o[1].tolist() and len(set(o[0].tolist())) == 2)
_add("multinomial", "random", lambda r: ((np.array(
    [[0.2, 0.8]], np.float32), 6, True), {}),
     lambda a, o: o.shape == (1, 6) and set(o.ravel().tolist()) <= {0, 1})

# -- linalg --------------------------------------------------------------------
_add("t", "exact", lambda r: ((_f(r, 3, 4),), {}))
_add("t", "exact", lambda r: ((_f(r, 3),), {}))
_add("norm", "float", lambda r: ((_f(r, 3, 4),), {}))
_add("norm", "float", lambda r: ((_f(r, 3, 4), "fro", [0, 1]), {}))
_add("norm", "float", lambda r: ((_f(r, 3, 4), 2, 1, True), {}))
_add("norm", "float", lambda r: ((_f(r, 3, 4), math.inf, 0), {}))
_add("norm", "float", lambda r: ((_f(r, 3, 4), -math.inf), {}))
_add("norm", "float", lambda r: ((_f(r, 3, 4), 3, 1), {}))
_add("norm", "float", lambda r: ((np.array([[0, 1.5], [2, 0]], np.float32),
                                  0, 1), {}))
_add("cholesky", "linalg", lambda r: ((_spd(r, 4),), {}))
_add("cholesky", "linalg", lambda r: ((_spd(r, 3), True), {}))
_add("inverse", "linalg", lambda r: ((_spd(r, 4),), {}))
_add("det", "linalg", lambda r: ((_spd(r, 3) / 3,), {}))
_add("svd", "decomp", lambda r: ((_f(r, 4, 3),), {}), _check_svd)
_add("qr", "decomp", lambda r: ((_f(r, 4, 3),), {}), _check_qr)
_add("pinv", "linalg", lambda r: ((_f(r, 4, 3),), {}))
_add("solve", "linalg", lambda r: ((_spd(r, 4), _f(r, 4, 2)), {}))
_add("triangular_solve", "linalg", lambda r: ((np.triu(_spd(r, 4)),
                                               _f(r, 4, 2)), {}))
_add("triangular_solve", "linalg", lambda r: ((np.tril(_spd(r, 4)),
                                               _f(r, 4, 2), False, True),
                                              {}))
_add("triangular_solve", "linalg", lambda r: ((np.triu(_spd(r, 3)),
                                               _f(r, 3, 1), True, False,
                                               True), {}))
_add("matrix_power", "linalg", lambda r: ((_f(r, 3, 3, lo=-1, hi=1), 3), {}))
_add("cross", "float", lambda r: ((_f(r, 4, 3), _f(r, 4, 3)), {}))
_add("cross", "float", lambda r: ((_f(r, 3, 2), _f(r, 3, 2), 0), {}))
_add("histogram", "exact", lambda r: ((np.array([0.0, 0.1, 0.5, 1.0, 0.3],
                                                np.float32), 4, 0, 1), {}))
_add("histogram", "exact", lambda r: ((np.array([-1.0, 0.2, 0.6, 3.0],
                                                np.float32), 2), {}))

# -- attention ---------------------------------------------------------------
_add("scaled_dot_product_attention", "attention",
     lambda r: ((_f(r, 2, 2, 8, 64, lo=-1, hi=1),
                 _f(r, 2, 2, 8, 64, lo=-1, hi=1),
                 _f(r, 2, 2, 8, 64, lo=-1, hi=1)), {}))
_add("scaled_dot_product_attention", "attention",
     lambda r: ((_f(r, 1, 2, 8, 64, lo=-1, hi=1),
                 _f(r, 1, 2, 8, 64, lo=-1, hi=1),
                 _f(r, 1, 2, 8, 64, lo=-1, hi=1)), {"is_causal": True}))
_add("flash_attention", "attention",
     lambda r: ((_f(r, 2, 2, 128, 64, lo=-1, hi=1),
                 _f(r, 2, 2, 128, 64, lo=-1, hi=1),
                 _f(r, 2, 2, 128, 64, lo=-1, hi=1)), {}))

# -- extra: stats ------------------------------------------------------------
_add("bincount", "exact", lambda r: ((_i(r, 12, hi=6), None, 8), {}))
_add("bincount", "float", lambda r: ((_i(r, 12, hi=6), _f(r, 12)), {}))
_add("median", "float", lambda r: ((_f(r, 3, 6), 1), {}))
_add("median", "float", lambda r: ((_f(r, 3, 5), None, True), {}))
_add("nanmedian", "float", lambda r: ((_nan(r, 3, 6), 1), {}))
_add("quantile", "float", lambda r: ((_f(r, 3, 6), 0.3, 1), {}))
_add("quantile", "float", lambda r: ((_f(r, 3, 6), np.array(
    [0.25, 0.75], np.float32)), {}))
_add("nanquantile", "float", lambda r: ((_nan(r, 3, 6), 0.5, 0, True), {}))
_add("corrcoef", "linalg", lambda r: ((_f(r, 3, 6),), {}))
_add("cov", "linalg", lambda r: ((_f(r, 3, 6),), {}))
_add("cov", "linalg", lambda r: ((_f(r, 6, 3), False, False), {}))
_add("count_nonzero", "exact", lambda r: ((_i(r, 3, 4, hi=3), 1), {}))
_add("count_nonzero", "exact", lambda r: ((_i(r, 3, 4, hi=3),), {}))
_add("diff", "float", lambda r: ((_f(r, 3, 5),), {}))
_add("diff", "float", lambda r: ((_f(r, 3, 5), 2, 0), {}))
_add("diff", "float", lambda r: ((_f(r, 4), 1, -1, 0.0, np.array(
    [1.0], np.float32)), {}))
# -- extra: elementwise ------------------------------------------------------
_add("frac", "float", lambda r: ((_f(r, 3, 4, lo=-5, hi=5),), {}))
_add("rad2deg", "float", lambda r: ((_f(r, 3, 4),), {}))
_add("deg2rad", "float", lambda r: ((_f(r, 3, 4, lo=-180, hi=180),), {}))
_add("gcd", "exact", lambda r: ((_i(r, 3, 4, hi=30), _i(r, 3, 4, hi=30)), {}))
_add("lcm", "exact", lambda r: ((_i(r, 3, 4, hi=30), _i(r, 3, 4, hi=30)), {}))
_add("heaviside", "exact", lambda r: ((np.array([-1.0, 0.0, 2.0], np.float32),
                                       np.array([0.5, 0.5, 0.5],
                                                np.float32)), {}))
_add("nextafter", "exact", lambda r: ((_f(r, 4), _f(r, 4)), {}))
_add("angle", "float", lambda r: ((_f(r, 4),), {}))
_add("conj", "exact", lambda r: ((_f(r, 3),), {}))
_add("conj", "exact", lambda r: ((np.array([1 + 2j, 3 - 1j], np.complex64),),
                                 {}))
_add("real", "exact", lambda r: ((np.array([1 + 2j, 3 - 1j], np.complex64),),
                                 {}))
_add("imag", "exact", lambda r: ((np.array([1 + 2j, 3 - 1j], np.complex64),),
                                 {}))
_add("imag", "exact", lambda r: ((_f(r, 3),), {}))
_add("dist", "float", lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {}))
_add("dist", "float", lambda r: ((_f(r, 3, 4), _f(r, 3, 4), 3.0), {}))
_add("dist", "float", lambda r: ((_f(r, 3, 4), _f(r, 3, 4), math.inf), {}))
_add("isclose", "exact", lambda r: ((np.array([1.0, 2.0, np.nan], np.float32),
                                     np.array([1.0 + 1e-7, 2.1, np.nan],
                                              np.float32)), {}))
_add("isclose", "exact", lambda r: ((np.array([np.nan], np.float32),
                                     np.array([np.nan], np.float32), 1e-5,
                                     1e-8, True), {}))
_add("renorm", "float", lambda r: ((_f(r, 3, 4), 2.0, 0, 1.0), {}))
_add("logaddexp", "float", lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {}))
_add("ldexp", "float", lambda r: ((_f(r, 3, 4), _i(r, 3, 4, lo=-3, hi=4)),
                                  {}))
_add("copysign", "exact", lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {}))
_add("signbit", "exact", lambda r: ((np.array([-1.0, 0.0, -0.0, 2.0],
                                              np.float32),), {}))
_add("sinc", "float", lambda r: ((_f(r, 3, 4),), {}))
for _n in ("i0", "i0e", "i1", "i1e"):
    _add(_n, "float", lambda r: ((_f(r, 3, 4, lo=-3, hi=3),), {}))
_add("polygamma", "float", lambda r: ((_f(r, 3, 4, lo=0.5, hi=4), 1), {}))
_add("digamma", "float", lambda r: ((_f(r, 3, 4, lo=0.5, hi=4),), {}))
_add("lgamma", "float", lambda r: ((_f(r, 3, 4, lo=0.5, hi=4),), {}))
_add("multigammaln", "float", lambda r: ((_f(r, 3, 4, lo=2.0, hi=5.0), 3),
                                         {}))
_add("erfinv", "float", lambda r: ((_f(r, 3, 4, lo=-0.9, hi=0.9),), {}))
_add("hypot", "float", lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {}))
_add("square_", "exact", lambda r: ((_f(r, 3, 4),), {}))
# -- extra: manipulation -----------------------------------------------------
_add("index_add", "float", lambda r: ((_f(r, 5, 3), np.array(
    [0, 2, 2], np.int32), 0, _f(r, 3, 3)), {}))
_add("index_add", "float", lambda r: ((_f(r, 3, 5), np.array(
    [4, 1], np.int32), 1, _f(r, 3, 2)), {}))
_add("index_put", "exact", lambda r: ((_f(r, 4, 5), (np.array(
    [0, 3], np.int32), np.array([1, 4], np.int32)), _f(r, 2)), {}))
_add("index_put", "float", lambda r: ((_f(r, 4, 5), (np.array(
    [0, 0], np.int32), np.array([1, 1], np.int32)), _f(r, 2), True), {}))
_add("take", "exact", lambda r: ((_f(r, 3, 4), _i(r, 2, 3, hi=12)), {}))
_add("take", "exact", lambda r: ((_f(r, 3, 4), _i(r, 5, lo=-20, hi=40),
                                  "wrap"), {}))
_add("take", "exact", lambda r: ((_f(r, 3, 4), _i(r, 5, lo=-20, hi=40),
                                  "clip"), {}))
_add("bucketize", "exact", lambda r: ((np.array([0.5, 2.0, 6.0], np.float32),
                                       np.array([1.0, 2.0, 5.0],
                                                np.float32)), {}))
_add("bucketize", "exact", lambda r: ((np.array([0.5, 2.0, 6.0], np.float32),
                                       np.array([1.0, 2.0, 5.0], np.float32),
                                       True, True), {}))
_add("crop", "exact", lambda r: ((_f(r, 4, 5), [2, 3], [1, 1]), {}))
_add("crop", "exact", lambda r: ((_f(r, 4, 5), [-1, 2]), {}))
_add("unfold", "exact", lambda r: ((_f(r, 1, 2, 5, 5), 3, 1, 1, 1), {}))
_add("unfold", "exact", lambda r: ((_f(r, 2, 1, 6, 7), [2, 3], 2, 0, [1, 2]),
                                   {}))
_add("as_strided", "exact", lambda r: ((_f(r, 12), [3, 3], [3, 1], 1), {}))
_add("view", "exact", lambda r: ((_f(r, 2, 6), [3, 4]), {}))
_add("view", "exact", lambda r: ((_f(r, 2, 3), "int32"), {}))
_add("view_as", "exact", lambda r: ((_f(r, 2, 6), _f(r, 4, 3)), {}))
_add("moveaxis", "exact", lambda r: ((_f(r, 2, 3, 4), 0, 2), {}))
_add("moveaxis", "exact", lambda r: ((_f(r, 2, 3, 4), [0, 1], [2, 0]), {}))
_add("rot90", "exact", lambda r: ((_f(r, 3, 4),), {}))
_add("rot90", "exact", lambda r: ((_f(r, 2, 3, 4), 3, (1, 2)), {}))
_add("atleast_1d", "exact", lambda r: ((np.float32(3.0) * np.ones(
    (), np.float32),), {}))
_add("atleast_2d", "exact", lambda r: ((_f(r, 3), _f(r, 2, 2)), {}))
_add("atleast_3d", "exact", lambda r: ((_f(r, 3),), {}))
_add("atleast_3d", "exact", lambda r: ((_f(r, 2, 3),), {}))
_add("column_stack", "exact", lambda r: (([_f(r, 3), _f(r, 3, 2)],), {}))
_add("row_stack", "exact", lambda r: (([_f(r, 3), _f(r, 2, 3)],), {}))
_add("hstack", "exact", lambda r: (([_f(r, 2, 3), _f(r, 2, 1)],), {}))
_add("vstack", "exact", lambda r: (([_f(r, 2, 3), _f(r, 1, 3)],), {}))
_add("dstack", "exact", lambda r: (([_f(r, 2, 3), _f(r, 2, 3)],), {}))
_add("hsplit", "exact", lambda r: ((_f(r, 2, 6), 3), {}))
_add("hsplit", "exact", lambda r: ((_f(r, 2, 6), [1, 4]), {}))
_add("vsplit", "exact", lambda r: ((_f(r, 4, 2), 2), {}))
_add("dsplit", "exact", lambda r: ((_f(r, 2, 2, 4), 2), {}))
_add("tensor_split", "exact", lambda r: ((_f(r, 7), 3), {}))
_add("tensor_split", "exact", lambda r: ((_f(r, 3, 7), [2, 5], 1), {}))
_add("diagonal_scatter", "exact", lambda r: ((_f(r, 3, 3), _f(r, 3)), {}))
_add("diagonal_scatter", "exact", lambda r: ((_f(r, 3, 4), _f(r, 3), 1), {}))
_add("diagonal_scatter", "exact", lambda r: ((_f(r, 4, 3), _f(r, 3), -1),
                                             {}))
_add("select_scatter", "exact", lambda r: ((_f(r, 3, 4), _f(r, 4), 0, 1), {}))
_add("select_scatter", "exact", lambda r: ((_f(r, 3, 4), _f(r, 3), 1, 2), {}))
_add("slice_scatter", "exact", lambda r: ((_f(r, 6, 3), _f(r, 2, 3), 0, 1, 5,
                                           2), {}))
_add("slice_scatter", "exact", lambda r: ((_f(r, 3, 6), _f(r, 3, 2), 1, 4),
                                          {}))
# -- extra: linalg -----------------------------------------------------------
_add("tensordot", "linalg", lambda r: ((_f(r, 2, 3, 4), _f(r, 3, 4, 5)), {}))
_add("tensordot", "linalg", lambda r: ((_f(r, 2, 3), _f(r, 3, 4), 1), {}))
_add("inner", "linalg", lambda r: ((_f(r, 2, 3), _f(r, 4, 3)), {}))
_add("mv", "linalg", lambda r: ((_f(r, 3, 4), _f(r, 4)), {}))
_add("lstsq", "linalg", lambda r: ((_f(r, 6, 3), _f(r, 6, 2)), {}))
_add("lstsq", "linalg", lambda r: ((_f(r, 5, 3), _f(r, 5)), {}))
_add("eig", "decomp", lambda r: ((_f(r, 4, 4),), {}), _check_eig)
_add("eigvals", "decomp", lambda r: ((_f(r, 4, 4),), {}), _check_eigvals)
_add("eigh", "decomp", lambda r: ((_spd(r, 4),), {}), _check_eigh)
_add("eigh", "decomp", lambda r: ((_spd(r, 3), "U"), {}), _check_eigh)
_add("eigvalsh", "linalg", lambda r: ((_spd(r, 4),), {}))
_add("lu", "linalg", lambda r: ((_f(r, 4, 4),), {}))
_add("slogdet", "linalg", lambda r: ((_f(r, 4, 4),), {}))
_add("matrix_rank", "exact", lambda r: ((np.ones((4, 4), np.float32),), {}))
_add("matrix_rank", "exact", lambda r: ((_spd(r, 4),), {}))
_add("vander", "float", lambda r: ((_f(r, 4), 3), {}))
_add("vander", "float", lambda r: ((_f(r, 3), None, True), {}))
_add("householder_product", "linalg", lambda r: ((_f(r, 4, 3),
                                                  _f(r, 3, lo=0.5, hi=1.5)),
                                                 {}))
_add("matrix_transpose", "exact", lambda r: ((_f(r, 2, 3, 4),), {}))
_add("diag_embed", "exact", lambda r: ((_f(r, 2, 3),), {}))
_add("diag_embed", "exact", lambda r: ((_f(r, 2, 3), 1), {}))
_add("diagflat", "exact", lambda r: ((_f(r, 2, 2),), {}))
_add("diagflat", "exact", lambda r: ((_f(r, 3), -1), {}))

# -- sequence (padded + lengths, segment ids) --------------------------------
_LENS = lambda r: np.array([5, 0, 3, 1], np.int32)          # noqa: E731
_add("sequence_mask", "exact", lambda r: ((_LENS(r), 6), {}))
_add("sequence_mask", "exact", lambda r: ((_LENS(r), 6, "float32"), {}))
for _p in ("sum", "mean", "sqrt", "max", "first", "last"):
    _add("sequence_pool", "float", lambda r, p=_p: ((_f(r, 4, 6, 3), _LENS(r),
                                                    p, -1.0), {}))
_add("sequence_first_step", "exact", lambda r: ((_f(r, 4, 6, 2), _LENS(r)),
                                                {}))
_add("sequence_last_step", "exact", lambda r: ((_f(r, 4, 6, 2), _LENS(r)),
                                               {}))
_add("sequence_softmax", "float", lambda r: ((_f(r, 4, 6), _LENS(r)), {}))
_add("sequence_softmax", "float", lambda r: ((_f(r, 4, 6, 2), _LENS(r)), {}))
_add("sequence_reverse", "exact", lambda r: ((_f(r, 4, 6, 3), _LENS(r)), {}))
_add("sequence_pad", "exact", lambda r: ((_f(r, 9, 2), np.array(
    [0, 0, 0, 1, 3, 3, 3, 3, 3], np.int32), 4, 4, -1.0), {}))
_add("sequence_unpad", "exact", lambda r: ((_f(r, 4, 6, 2), _LENS(r)), {}))
_add("sequence_expand", "exact", lambda r: ((_f(r, 4, 6, 2), _LENS(r),
                                             np.array([2, 3, 1, 4], np.int32),
                                             8), {}))
_add("sequence_slice", "exact", lambda r: ((_f(r, 4, 6, 2), _LENS(r),
                                            np.array([1, 0, 2, 0], np.int32),
                                            np.array([3, 2, 2, 1], np.int32)),
                                           {}))
for _n in ("segment_sum", "segment_mean", "segment_max", "segment_min"):
    _add(_n, "float", lambda r: ((_f(r, 7, 3), np.array(
        [0, 0, 1, 1, 1, 3, 3], np.int32), 5), {}))
_add("segment_max", "exact", lambda r: ((_i(r, 6, lo=-9), np.array(
    [0, 2, 2, 2, 3, 3], np.int32), 4), {}))
# -- ctc and chunk_eval --------------------------------------------------------
_add("edit_distance", "float", lambda r: ((_i(r, 4, 6, hi=5), _i(r, 4, 5, hi=5),
                                           np.array([6, 3, 0, 4], np.int32),
                                           np.array([5, 0, 2, 4], np.int32)),
                                          {}))
_add("edit_distance", "float", lambda r: ((_i(r, 3, 4, hi=4), _i(r, 3, 6, hi=4),
                                           None, None, False), {}))
_add("ctc_greedy_decoder", "exact", lambda r: ((_f(r, 3, 8, 5), 0, np.array(
    [8, 5, 0], np.int32)), {}))
_add("ctc_greedy_decoder", "exact", lambda r: ((_f(r, 2, 6, 4), 3, None, -1),
                                               {}))
_TAGS = lambda r: _i(r, 4, 10, hi=7)                         # noqa: E731
_add("chunk_eval", "float", lambda r: ((_TAGS(r), _TAGS(r), np.array(
    [10, 7, 3, 0], np.int32), "IOB", 3), {}))
_add("chunk_eval", "float", lambda r: ((_i(r, 3, 12, hi=9), _i(r, 3, 12, hi=9),
                                        None, "IOBES", 2), {}))
_add("chunk_eval", "float", lambda r: ((_i(r, 3, 12, hi=7), _i(r, 3, 12, hi=7),
                                        None, "IOE", 3, [1]), {}))
_add("chunk_eval", "float", lambda r: ((_i(r, 3, 12, hi=4), _i(r, 3, 12, hi=4),
                                        np.array([12, 5, 9], np.int32),
                                        "plain", 3), {}))
# -- misc ----------------------------------------------------------------------
_add("pixel_shuffle", "exact", lambda r: ((_f(r, 2, 8, 3, 3), 2), {}))
_add("pixel_shuffle", "exact", lambda r: ((_f(r, 2, 3, 3, 8), 2, "NHWC"), {}))
_add("pixel_unshuffle", "exact", lambda r: ((_f(r, 2, 2, 6, 4), 2), {}))
_add("space_to_depth", "exact", lambda r: ((_f(r, 2, 3, 4, 6), 2), {}))
_add("shuffle_channel", "exact", lambda r: ((_f(r, 2, 6, 2, 2), 3), {}))
_add("temporal_shift", "exact", lambda r: ((_f(r, 6, 8, 2, 2), 3), {}))
_add("cos_sim", "float", lambda r: ((_f(r, 4, 5), _f(r, 4, 5)), {}))
_add("cos_sim", "float", lambda r: ((_f(r, 4, 2, 3), _f(r, 1, 2, 3)), {}))
_add("p_norm", "float", lambda r: ((_f(r, 3, 4), 3.0, 1), {}))
_add("p_norm", "float", lambda r: ((_f(r, 3, 4), math.inf, 0, 1e-12, True),
                                   {}))
_add("p_norm", "float", lambda r: ((_f(r, 3, 4),), {}))
_add("frobenius_norm", "float", lambda r: ((_f(r, 3, 4, 2), [0, 1]), {}))
_add("frobenius_norm", "float", lambda r: ((_f(r, 3, 4),), {}))
_add("l1_norm", "float", lambda r: ((_f(r, 3, 4),), {}))
_add("minus", "float", lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {}))
_add("reverse", "exact", lambda r: ((_f(r, 3, 4), [0, 1]), {}))
_add("multiplex", "exact", lambda r: (([_f(r, 4, 3), _f(r, 4, 3),
                                        _f(r, 4, 3)], np.array(
                                            [[2], [0], [1], [2]], np.int32)),
                                      {}))
_add("strided_slice", "exact", lambda r: ((_f(r, 6, 7), [0, 1], [1, 6],
                                           [5, 0], [2, -2]), {}))
_add("strided_slice", "exact", lambda r: ((_f(r, 6, 7), [1], [-1], [-8],
                                           [-1]), {}))
_add("rank_loss", "float", lambda r: ((_b(r, 5, 1).astype(np.float32),
                                       _f(r, 5, 1, lo=-50, hi=50),
                                       _f(r, 5, 1)), {}))
_add("sigmoid_focal_loss", "float", lambda r: ((_f(r, 6, 4), _i(r, 6, 1, hi=5),
                                                np.array(3.0, np.float32)),
                                               {}))
_add("lrn", "float", lambda r: ((_f(r, 2, 7, 3, 3), 5, 1.0, 1e-2), {}))
_add("lrn", "float", lambda r: ((_f(r, 2, 6, 2, 2), 4), {}))
_add("pad_constant_like", "exact", lambda r: ((_f(r, 4, 5), _f(r, 2, 3), 9.0),
                                              {}))
_add("crop_tensor", "exact", lambda r: ((_f(r, 4, 5), [2, 3], [1, 2]), {}))
_add("crop_tensor", "exact", lambda r: ((_f(r, 4, 5),), {}))
_add("max_pool2d_with_index", "exact", lambda r: ((_f(r, 2, 3, 6, 7), 2), {}))
_add("max_pool2d_with_index", "exact", lambda r: ((_f(r, 1, 2, 5, 5), 3, 2, 1),
                                                  {}))
_add("affine_grid", "float", lambda r: ((_f(r, 2, 2, 3), (2, 3, 4, 5)), {}))
_add("affine_grid", "float", lambda r: ((_f(r, 2, 2, 3), (2, 3, 4, 5), False),
                                        {}))
_add("grid_sampler", "float", lambda r: ((_f(r, 2, 3, 5, 6),
                                          _f(r, 2, 4, 3, 2, lo=-1.2, hi=1.2)),
                                         {}))
_add("grid_sampler", "float", lambda r: ((_f(r, 2, 3, 5, 6),
                                          _f(r, 2, 4, 3, 2, lo=-1.2, hi=1.2),
                                          "bilinear", "border", False), {}))
_add("grid_sampler", "exact", lambda r: ((_f(r, 1, 2, 5, 6),
                                          _f(r, 1, 4, 3, 2, lo=-1.2, hi=1.2),
                                          "nearest"), {}))
_add("roi_pool", "exact", lambda r: ((_f(r, 3, 12, 10), np.array(
    [[0, 0, 9, 11], [2, 3, 6, 7], [4.4, 1.2, 4.6, 9.7]], np.float32), 2), {}))
_add("roi_pool", "exact", lambda r: ((_f(r, 2, 8, 8), np.array(
    [[1, 1, 14, 10], [0, 0, 3, 3]], np.float32), (3, 2), 0.5), {}))
_add("row_conv", "float", lambda r: ((_f(r, 3, 6, 4), _f(r, 3, 4)), {}))
_add("row_conv", "float", lambda r: ((_f(r, 3, 6, 4), _f(r, 3, 4), np.array(
    [6, 2, 4], np.int32)), {}))
_add("sequence_conv", "linalg", lambda r: ((_f(r, 3, 6, 4), _f(r, 12, 5)), {}))
_add("sequence_conv", "linalg", lambda r: ((_f(r, 3, 6, 4), _f(r, 16, 5),
                                            np.array([6, 2, 4], np.int32), 4,
                                            -3), {}))
_add("nce_loss", "float", lambda r: ((_f(r, 4, 6), _i(r, 4, hi=20),
                                      _f(r, 20, 6), _f(r, 20),
                                      _i(r, 4, 5, hi=20)), {}))
_add("data_norm", "float", lambda r: ((_f(r, 5, 3), np.full(3, 10.0,
                                                            np.float32),
                                       _f(r, 3), _f(r, 3, lo=1, hi=9)), {}))
_add("cvm", "float", lambda r: ((_f(r, 4, 5, lo=0.0, hi=9.0),), {}))
_add("cvm", "exact", lambda r: ((_f(r, 4, 5), False), {}))
_add("spectral_norm", "linalg", lambda r: ((_f(r, 4, 3, 2), _f(r, 3), 1, 2),
                                           {}))


# -- vision / detection ------------------------------------------------------
def _boxes(rng, n, scale=1.0):
    """n xyxy boxes of width and height 0.05-0.4 (times ``scale``)."""
    xy = rng.uniform(0.0, 0.6, (n, 2))
    wh = rng.uniform(0.05, 0.4, (n, 2))
    return (np.concatenate([xy, xy + wh], 1) * scale).astype(np.float32)


def _distinct(rng, *shape):
    """Scores in (0, 1), all distinct and at least 1e-3 apart, so that
    every sort and every NMS decision is one way on any device."""
    n = int(np.prod(shape))
    return ((rng.permutation(n) + 0.5) / n).reshape(shape).astype(np.float32)


def _yolo_gt(rng, n, b):
    """Normalized (cx, cy, w, h) boxes, the last of image 1 padding, and
    labels in [0, 3)."""
    box = np.concatenate([rng.uniform(0.2, 0.8, (n, b, 2)),
                          rng.uniform(0.05, 0.6, (n, b, 2))], -1)
    box[1, -1] = 0.0
    return box.astype(np.float32), _i(rng, n, b, hi=3)


_YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
_add("iou_similarity", "float", lambda r: ((_boxes(r, 5), _boxes(r, 7)), {}))
_add("iou_similarity", "float", lambda r: ((_boxes(r, 5, 30.0),
                                            _boxes(r, 7, 30.0), False), {}))
_add("box_coder", "float", lambda r: ((_boxes(r, 6), [0.1, 0.1, 0.2, 0.2],
                                       _boxes(r, 4)), {}))
_add("box_coder", "float", lambda r: ((_boxes(r, 6), None, _f(r, 3, 6, 4),
                                       "decode_center_size"), {}))
_add("box_coder", "float", lambda r: ((_boxes(r, 3), _f(r, 3, 4, lo=0.1,
                                                        hi=0.3),
                                       _f(r, 3, 6, 4), "decode_center_size",
                                       True, 1), {}))
_add("box_clip", "float", lambda r: ((_boxes(r, 8, 40.0) - 5.0, (30, 25)),
                                     {}))
_add("anchor_generator", "float", lambda r: (((3, 4),), {}))
_add("anchor_generator", "float", lambda r: (((2, 3), (32.0, 64.0), (1.0,),
                                              (8.0, 8.0)), {"offset": 0.0}))
_add("prior_box", "float", lambda r: (((3, 4), (60, 80), [20.0, 40.0],
                                       [30.0, 60.0], [2.0, 3.0], True,
                                       True), {}))
_add("prior_box", "float", lambda r: (((2, 2), (32, 32), [8.0]), {
    "steps": (16.0, 16.0)}))
_add("yolo_box", "float", lambda r: ((_f(r, 2, 2 * 8, 4, 5),
                                      np.array([[64, 80], [50, 60]],
                                               np.int32),
                                      [10, 13, 16, 30], 3, 0.5, 16), {}))
_add("yolo_box", "float", lambda r: ((_f(r, 1, 3 * 7, 3, 3),
                                      np.array([[96, 96]], np.int32),
                                      [10, 13, 16, 30, 33, 23], 2, 0.01, 32,
                                      False, 1.05), {}))
_add("yolo_loss", "float", lambda r: ((_f(r, 2, 2 * 8, 4, 5),
                                       *_yolo_gt(r, 2, 6), _YOLO_ANCHORS,
                                       [2, 3], 3, 0.3, 16), {}))
_add("yolo_loss", "float", lambda r: ((_f(r, 2, 2 * 8, 4, 5),
                                       *_yolo_gt(r, 2, 6), _YOLO_ANCHORS,
                                       [0, 1], 3, 0.7, 16,
                                       _f(r, 2, 6, lo=0.0, hi=1.0), True),
                                      {}))
_add("multiclass_nms", "float", lambda r: ((_boxes(r, 40),
                                            _distinct(r, 3, 40), 0.2, 25, 30,
                                            0.3), {}))
_add("multiclass_nms", "float", lambda r: ((_boxes(r, 40),
                                            _distinct(r, 3, 40), 0.5, 25,
                                            130, 0.3, True, 0), {}))
_add("multiclass_nms", "float", lambda r: ((np.stack(
    [_boxes(r, 30) for _ in range(3)], 1), _distinct(r, 3, 30)),
    {"nms_top_k": 100, "keep_top_k": 20}))
_add("roi_align", "float", lambda r: ((_f(r, 3, 10, 12), _boxes(r, 5, 12.0),
                                       (3, 2), 0.9), {}))
_add("roi_align", "float", lambda r: ((_f(r, 3, 10, 12),
                                       _boxes(r, 5, 12.0) - 2.0, 2, 1.0, 3,
                                       True), {}))



# -- nn.functional -------------------------------------------------------------
FUNCTIONAL_CASES = []


def _fadd(name, family, make, check=None):
    FUNCTIONAL_CASES.append(Case(name, family, make, check))


def _check_dropout2d(args, out):
    """Each (sample, channel) all zero or all x / (1 - p)."""
    x, p = args[0], args[1]
    kept = np.isclose(out, x / (1 - p), rtol=1e-6, atol=0)
    dropped = out == 0
    per = lambda m: m.reshape(m.shape[0], m.shape[1], -1).all(-1)  # noqa
    return bool(np.all(per(kept) | per(dropped))
                and 0 < per(dropped).sum() < per(dropped).size)


_fadd("dropout2d", "random", lambda r: ((_f(r, 4, 16, 3, 3), 0.5), {}),
      _check_dropout2d)
_fadd("pad", "exact", lambda r: ((_f(r, 2, 3, 4, 5), [1, 2, 0, 3]), {}))
_fadd("pad", "exact", lambda r: ((_f(r, 2, 4, 5, 3), [1, 2, 2, 1], "constant",
                                  7.0, "NHWC"), {}))
for _m in ("reflect", "replicate", "circular"):
    _fadd("pad", "exact", lambda r, m=_m: ((_f(r, 2, 3, 4, 5), [2, 1, 3, 2],
                                            m), {}))
_fadd("pad", "exact", lambda r: ((_f(r, 3, 5), [1, 0, 2, 3], "reflect"), {}))
for _m, _ac in (("nearest", False), ("nearest", True), ("bilinear", False),
                ("bilinear", True), ("bicubic", False), ("bicubic", True)):
    _fam = "cubic" if _m == "bicubic" else "float"
    _fadd("interpolate", _fam, lambda r, m=_m, ac=_ac: (
        (_f(r, 2, 3, 5, 6), (7, 9), None, m, ac), {}))
    _fadd("interpolate", _fam, lambda r, m=_m, ac=_ac: (
        (_f(r, 2, 6, 8, 3), None, 0.5, m, ac, "NHWC"), {}))
_fadd("interpolate", "float", lambda r: ((_f(r, 1, 2, 3, 4, 5), (5, 2, 7),
                                          None, "trilinear"), {}))
_fadd("interpolate", "float", lambda r: ((_f(r, 1, 2, 3, 4, 5), None, 2.0,
                                          "trilinear", True), {}))
_fadd("upsample", "float", lambda r: ((_f(r, 2, 3, 4, 4), None, 2,
                                       "bilinear"), {}))
_fadd("cosine_similarity", "float", lambda r: ((_f(r, 4, 6), _f(r, 4, 6)),
                                               {}))
_fadd("cosine_similarity", "float", lambda r: ((_f(r, 3, 4, 5), _f(r, 3, 4, 5),
                                                2), {}))
_fadd("unfold", "exact", lambda r: ((_f(r, 2, 3, 6, 5), [2, 3], [1, 2], 1),
                                    {}))
_fadd("rms_norm", "float", lambda r: ((_f(r, 3, 8), _f(r, 8)), {}))
_fadd("rms_norm", "float", lambda r: ((_f(r, 3, 8),), {}))
_fadd("group_norm", "float", lambda r: ((_f(r, 2, 6, 4, 3), 3, _f(r, 6),
                                         _f(r, 6)), {}))
_fadd("group_norm", "float", lambda r: ((_f(r, 2, 4, 5), 2), {}))
_fadd("instance_norm", "float", lambda r: ((_f(r, 2, 3, 4, 5), _f(r, 3),
                                            _f(r, 3)), {}))
_fadd("instance_norm", "float", lambda r: ((_f(r, 2, 3, 7),), {}))
_fadd("normalize", "float", lambda r: ((_f(r, 3, 5),), {}))
_fadd("normalize", "float", lambda r: ((_f(r, 3, 5, 2), 1, 2), {}))
_fadd("one_hot", "exact", lambda r: ((_i(r, 3, 4, hi=6), 6), {}))
_fadd("ctc_loss", "linalg", lambda r: ((_f(r, 12, 3, 6), _i(r, 3, 4, lo=1,
                                                             hi=6),
                                        np.array([12, 9, 5], np.int32),
                                        np.array([4, 2, 0], np.int32)), {}))
_fadd("ctc_loss", "linalg", lambda r: ((_f(r, 8, 2, 5), _i(r, 2, 3, lo=1,
                                                            hi=5),
                                        None, None, 0, "sum", True), {}))
_fadd("ctc_loss", "linalg", lambda r: ((_f(r, 8, 2, 5), _i(r, 2, 3, lo=0,
                                                            hi=4),
                                        None, np.array([3, 1], np.int32), 4,
                                        "none"), {}))
# convolutions: products, held as "linalg" (cuDNN sums in its own order)
_fadd("conv1d", "linalg", lambda r: ((_f(r, 2, 4, 9), _f(r, 6, 2, 3),
                                      _f(r, 6), 2, 2, 2, 2), {}))
_fadd("conv1d", "linalg", lambda r: ((_f(r, 2, 4, 9), _f(r, 6, 4, 3)),
                                     {"padding": "SAME", "stride": 2}))
_fadd("conv3d", "linalg", lambda r: ((_f(r, 2, 4, 5, 6, 7),
                                      _f(r, 6, 2, 3, 2, 3), _f(r, 6),
                                      (1, 2, 1), (1, 0, 2), (1, 1, 2), 2),
                                     {}))
_fadd("conv3d", "linalg", lambda r: ((_f(r, 1, 2, 5, 6, 7),
                                      _f(r, 3, 2, 3, 3, 3)),
                                     {"padding": "SAME", "stride": 2}))
for _s, _p, _op, _d in ((2, 1, 1, 1), (1, 3, 0, 1), (2, 1, 3, 1),
                        (3, 0, 2, 2)):
    _fadd("conv2d_transpose", "linalg", lambda r, s=_s, p=_p, op=_op, d=_d: (
        (_f(r, 2, 4, 5, 6), _f(r, 4, 3, 3, 3), _f(r, 6), s, p, op, d, 2),
        {}))
_fadd("conv3d_transpose", "linalg", lambda r: ((_f(r, 2, 4, 3, 4, 5),
                                                _f(r, 4, 3, 3, 2, 3),
                                                _f(r, 6), (2, 1, 2),
                                                (1, 0, 3), (1, 0, 2), 1, 2),
                                               {}))
_fadd("max_pool3d", "exact", lambda r: ((_f(r, 2, 3, 5, 6, 7), 3, 2, 1), {}))
_fadd("max_pool3d", "exact", lambda r: ((_f(r, 2, 3, 5, 6, 7), (2, 3, 3),
                                         None, (1, 2, 2)), {}))
for _p, _ex in ((0, True), (1, True), (1, False), ((0, 1, 2), True)):
    _fadd("avg_pool3d", "float", lambda r, p=_p, ex=_ex: (
        (_f(r, 2, 3, 5, 6, 7), 3, 2, p, ex), {}))
_fadd("adaptive_avg_pool3d", "float", lambda r: ((_f(r, 2, 3, 4, 6, 8),
                                                  (2, 3, 4)), {}))


def case_ids(cases=None):
    """A test id for each case of ``cases`` (default ``CASES``): the name,
    numbered after the first."""
    seen = collections.Counter()
    ids = []
    for c in CASES if cases is None else cases:
        ids.append(c.name if not seen[c.name] else f"{c.name}-{seen[c.name]}")
        seen[c.name] += 1
    return ids
