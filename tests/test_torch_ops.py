"""The port's tensor op library against the JAX package's, op by op, on the
CPU: the same numpy inputs (``paddle_tpu_torch.ops.cases``, the table
``chip_smoke.py`` also runs on the card) through ``paddle_tpu.ops.<name>``
and ``paddle_tpu_torch.<name>``.

Tolerances by family (``cases.TOLERANCE``): data movement, integers,
booleans and creation equal; elementwise and reductions rtol 1e-5 / atol
1e-6; matrix products, solves and statistics of products rtol 1e-4 / atol
1e-5; decompositions (signs and order free) by their reconstructions and
invariants within 1e-4 of the input; random ops by shape, dtype kind,
range or moments, and repeating under one seed (they cannot match
``jax.random``).  Values and the kind of dtype are compared: the JAX
package returns 32-bit integers (x64 off) where the port returns the
int64 Paddle declares.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.ops as J
import paddle_tpu_torch as P
from paddle_tpu_torch.ops import cases as C


@pytest.fixture(autouse=True)
def _cpu():
    with P.device_guard("cpu"):
        yield


def _ref(name):
    # the JAX package's ``ops.chunk`` is the chunk_eval submodule, which
    # shadows manipulation's op there
    return J.manipulation.chunk if name == "chunk" else getattr(J, name)


def _np(x):
    if isinstance(x, torch.Tensor):
        assert x.device.type == "cpu"
        return x.detach().numpy()
    return np.asarray(x)


def _run(case, index):
    args, kwargs = case.make(np.random.default_rng(index))
    ref = _ref(case.name)(*C.to_framework(args, jnp.asarray),
                          **C.to_framework(kwargs, jnp.asarray))
    got = getattr(P, case.name)(*C.to_framework(args, torch.from_numpy),
                                **C.to_framework(kwargs, torch.from_numpy))
    return args, ref, got


def _indices(random):
    return [i for i, c in enumerate(C.CASES)
            if (c.family == "random") == random]


def _ids(random):
    ids = C.case_ids()
    return [ids[i] for i in _indices(random)]


@pytest.mark.parametrize("index", _indices(False), ids=_ids(False))
def test_op_matches_the_reference(index):
    case = C.CASES[index]
    args, ref, got = _run(case, index)
    rl, gl = C.leaves(ref), C.leaves(got)
    assert len(rl) == len(gl), case.name
    rl, gl = [_np(r) for r in rl], [_np(g) for g in gl]
    for r, g in zip(rl, gl):
        assert r.shape == g.shape, (case.name, r.shape, g.shape)
        assert r.dtype.kind == g.dtype.kind, (case.name, r.dtype, g.dtype)
    if case.family == "decomp":
        for out in (rl, gl):
            assert case.check(args, out if len(out) > 1 else out[0]) < 1e-4
        return
    for r, g in zip(rl, gl):
        if case.family == "exact" or r.dtype.kind in "biu":
            np.testing.assert_array_equal(g, r, err_msg=case.name)
        else:
            rtol, atol = C.TOLERANCE[case.family]
            np.testing.assert_allclose(g, r, rtol=rtol, atol=atol,
                                       err_msg=case.name)


@pytest.mark.parametrize("index", _indices(True), ids=_ids(True))
def test_random_op_draws_and_repeats(index):
    """Shape, dtype kind and range or moments, held for both packages'
    draws; one seed gives one draw in the port."""
    case = C.CASES[index]
    args, ref, got = _run(case, index)
    ref, g = np.asarray(ref), _np(got)
    assert case.check(args, ref) and case.check(args, g), case.name
    assert ref.shape == g.shape and ref.dtype.kind == g.dtype.kind
    args_t, kwargs = case.make(np.random.default_rng(index))
    fn = getattr(P, case.name)
    draws = []
    for _ in range(2):
        P.seed(11)
        draws.append(_np(fn(*C.to_framework(args_t, torch.from_numpy),
                            **kwargs)))
    np.testing.assert_array_equal(draws[0], draws[1])


def test_export_set_is_the_reference_less_the_deferral_set():
    assert P.ops._DEFERRED == {} and not P.ops._DEFERRED_NAMES
    vision = {n for n in J.__all__ if getattr(getattr(J, n), "__module__", "")
              == "paddle_tpu.ops.vision"}
    assert len(vision) == 9 and vision <= set(P.ops.__all__)
    from paddle_tpu.ops import chunk, ctc, misc
    for names in (misc.__all__, ctc.__all__, chunk.__all__):
        assert set(names) <= set(P.ops.__all__), names
    assert {n for n in J.__all__ if getattr(getattr(J, n), "__module__", "")
            == "paddle_tpu.ops.sequence"} <= set(P.ops.__all__)
    assert len(J.__all__) == 318
    assert set(J.__all__) - P.ops._DEFERRED_NAMES == set(P.ops.__all__)
    assert len(P.ops.__all__) == 318
    for n in P.ops.__all__:
        if n != "vision":       # the top-level name is the vision package
            assert getattr(P, n) is getattr(P.ops, n) is getattr(P.tensor,
                                                                n), n
    assert P.vision.__name__ == "paddle_tpu_torch.vision"
    ops = {n for n in P.ops.__all__ if callable(getattr(P.ops, n))}
    assert ops == {c.name for c in C.CASES}, ops ^ {c.name for c in C.CASES}


def test_creation_ops_place_tensors_on_the_current_device(monkeypatch):
    assert P.get_device() == P.CPUPlace()
    for t in (P.to_tensor([1.0]), P.zeros([2]), P.arange(3), P.rand([2]),
              P.full([2], 1)):
        assert t.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with P.device_guard("gpu"):
        assert P.get_device() == P.CUDAPlace(0) == P.TPUPlace(0)
        with pytest.raises(RuntimeError, match="CUDA"):
            P.zeros([2])
        with pytest.raises(RuntimeError, match="CUDA"):
            P.to_tensor([1.0])
    assert P.to_tensor([1.0], place=P.CPUPlace()).device.type == "cpu"
    assert P.get_device() == P.CPUPlace()


def test_declared_dtypes_and_scalar_promotion():
    x = P.to_tensor(np.random.default_rng(0).normal(size=(3, 4)))
    assert x.dtype == torch.float32          # float64 data -> default float
    assert P.argmax(x, 1).dtype == torch.int64
    assert P.argmax(x, 1, dtype="int32").dtype == torch.int32
    assert P.cast(x, "int64").dtype == P.int64 == torch.int64
    assert P.topk(x, 2)[1].dtype == torch.int64
    # a Python scalar meets a bf16 tensor as bf16, as in JAX
    xb = x.to(torch.bfloat16)
    jb = jnp.asarray(np.asarray(x), jnp.bfloat16)
    assert P.multiply(xb, 2.0).dtype == torch.bfloat16
    assert J.multiply(jb, 2.0).dtype == jnp.bfloat16
    assert P.add(P.to_tensor([1, 2]), 0.5).dtype == torch.float32


def test_to_tensor_leaf_and_stop_gradient():
    w = P.to_tensor([1.0, 2.0], stop_gradient=False)
    assert w.is_leaf and w.requires_grad and not w.stop_gradient
    c = P.to_tensor([1.0, 2.0])
    assert c.stop_gradient
    P.sum(w * c).backward()
    np.testing.assert_array_equal(w.grad.numpy(), [1.0, 2.0])
    w.stop_gradient = True
    assert not w.requires_grad
    y = w * 2.0
    y.stop_gradient = False
    assert y.requires_grad
