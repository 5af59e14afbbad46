"""The rest of ``nn``: the functional tail and the norm, pooling, padding,
dropout and extra layers, the port against the JAX package on the CPU.

* ``paddle_tpu_torch.ops.cases.FUNCTIONAL_CASES`` (the table
  ``chip_smoke.py`` also runs on the card) through
  ``paddle_tpu.nn.functional.<name>`` and the port's: exact families
  equal, float ones at rtol 1e-5 / atol 1e-6, ``ctc_loss`` (a 12-step
  log-semiring recursion) at rtol 1e-4 / atol 1e-5; ``dropout2d`` by its
  channel structure and by repeating under one seed.
* Layers built in both packages, the JAX weights put into the port's with
  ``convert.from_jax_params`` (shapes checked), outputs at rtol 1e-5 and
  gradients of the weights at rtol 1e-4; BatchNorm's running statistics
  after a training forward at rtol 1e-5.
* The dispatch rows 11-13 keep: the BatchNorm layers reach
  ``F.batch_norm`` (no kernel), the 2-D pool layers the functional pools.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpd
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.autograd import functional_call, parameters_dict
import paddle_tpu_torch as P
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import convert
from paddle_tpu_torch.ops import cases as C

RTOL, GRAD_RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    with P.device_guard("cpu"):
        yield


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _indices(random):
    return [i for i, c in enumerate(C.FUNCTIONAL_CASES)
            if (c.family == "random") == random]


def _ids(random):
    ids = C.case_ids(C.FUNCTIONAL_CASES)
    return [ids[i] for i in _indices(random)]


@pytest.mark.parametrize("index", _indices(False), ids=_ids(False))
def test_functional_matches_the_reference(index):
    case = C.FUNCTIONAL_CASES[index]
    args, kwargs = case.make(np.random.default_rng(index))
    ref = getattr(JF, case.name)(*C.to_framework(args, jnp.asarray),
                                 **C.to_framework(kwargs, jnp.asarray))
    got = getattr(TF, case.name)(*C.to_framework(args, torch.from_numpy),
                                 **C.to_framework(kwargs, torch.from_numpy))
    rl, gl = [_np(r) for r in C.leaves(ref)], [_np(g) for g in C.leaves(got)]
    assert len(rl) == len(gl)
    for r, g in zip(rl, gl):
        assert r.shape == g.shape and r.dtype.kind == g.dtype.kind, \
            (case.name, r.shape, g.shape, r.dtype, g.dtype)
        if case.family == "exact" or r.dtype.kind in "biu":
            np.testing.assert_array_equal(g, r, err_msg=case.name)
        else:
            rtol, atol = C.TOLERANCE[case.family]
            np.testing.assert_allclose(g, r, rtol=rtol, atol=atol,
                                       err_msg=case.name)


@pytest.mark.parametrize("index", _indices(True), ids=_ids(True))
def test_random_functional_draws_and_repeats(index):
    case = C.FUNCTIONAL_CASES[index]
    args, kwargs = case.make(np.random.default_rng(index))
    jpd.seed(3)
    ref = getattr(JF, case.name)(*C.to_framework(args, jnp.asarray), **kwargs)
    assert case.check(args, np.asarray(ref))
    draws = []
    for _ in range(2):
        P.seed(11)
        draws.append(_np(getattr(TF, case.name)(
            *C.to_framework(args, torch.from_numpy), **kwargs)))
    assert case.check(args, draws[0])
    np.testing.assert_array_equal(draws[0], draws[1])


def test_functional_table_and_nn_cover_the_slice():
    names = {c.name for c in C.FUNCTIONAL_CASES}
    assert names == {"dropout2d", "pad", "interpolate", "upsample",
                     "cosine_similarity", "unfold", "rms_norm", "group_norm",
                     "instance_norm", "normalize", "one_hot", "ctc_loss",
                     "conv1d", "conv3d", "conv2d_transpose",
                     "conv3d_transpose", "max_pool3d", "avg_pool3d",
                     "adaptive_avg_pool3d"}
    ported = set(TF.__all__)
    assert TF._DEFERRED == () and tnn._DEFERRED == ()
    assert set(JF.__all__) - ported == set(TF._DEFERRED) | {
        "activation", "common", "conv", "input", "loss", "norm", "pooling"}
    # every name of the JAX package's nn but those queued for later slices
    assert {n for n in dir(jnn) if not n.startswith("_")} - set(
        tnn.__all__) == set(tnn._DEFERRED)


# -- layers: the JAX weights in, outputs and weight gradients ----------------

def _pair(jlayer, tlayer):
    jp = {k: np.asarray(v) for k, v in parameters_dict(jlayer).items()}
    convert.from_jax_params(jp, tlayer)
    return jp


def _layer_parity(jlayer, tlayer, *inputs, grads=True):
    """Forward, and the gradient of sum(out * c) with respect to every
    weight, in both packages."""
    jp = _pair(jlayer, tlayer)
    jx = [jnp.asarray(x) for x in inputs]
    tx = [torch.from_numpy(x) for x in inputs]
    out_t = tlayer(*tx)
    out_j = jlayer(*jx)
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), rtol=RTOL,
                               atol=1e-6)
    if not grads or not jp:
        return
    c = np.random.default_rng(0).normal(size=out_t.shape).astype(np.float32)

    def loss(p):
        return jnp.sum(functional_call(jlayer, p, tuple(jx)) * c)

    jg = jax.grad(loss)({k: jnp.asarray(v) for k, v in jp.items()})
    tlayer.clear_gradients()
    (out_t * torch.from_numpy(c)).sum().backward()
    for k, p in tlayer.named_parameters():
        np.testing.assert_allclose(_np(p.grad), np.asarray(jg[k]),
                                   rtol=GRAD_RTOL, atol=1e-5, err_msg=k)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("name,args,shape", [
    ("GroupNorm", (3, 6), (2, 6, 4, 3)),
    ("InstanceNorm2D", (3,), (2, 3, 4, 5)),
    ("InstanceNorm1D", (3,), (2, 3, 7)),
    ("InstanceNorm3D", (2,), (2, 2, 3, 2, 4)),
    ("RMSNorm", (8,), (3, 5, 8)),
    ("LayerNorm", (8,), (3, 5, 8)),
])
def test_norm_layers(name, args, shape):
    _layer_parity(getattr(jnn, name)(*args), getattr(tnn, name)(*args),
                  _x(*shape))


@pytest.mark.parametrize("name,fmt,shape", [
    ("BatchNorm", "NCHW", (4, 3, 5, 5)),
    ("BatchNorm1D", "NCL", (4, 3, 6)),
    ("BatchNorm2D", "NHWC", (4, 5, 5, 3)),
    ("BatchNorm3D", "NCHW", (2, 3, 2, 3, 4)),
    ("SyncBatchNorm", "NCHW", (4, 3, 5, 5)),
])
def test_batch_norm_layers_train_and_eval(name, fmt, shape):
    jl = getattr(jnn, name)(3, momentum=0.8, data_format=fmt)
    tl = getattr(tnn, name)(3, momentum=0.8, data_format=fmt)
    _pair(jl, tl)
    x = _x(*shape, seed=1) * 3 + 1
    np.testing.assert_allclose(_np(tl(torch.from_numpy(x))),
                               np.asarray(jl(jnp.asarray(x))), rtol=RTOL,
                               atol=1e-5)
    # one training forward each: the running statistics
    np.testing.assert_allclose(tl._mean.numpy(),
                               np.asarray(jl._buffers["_mean"].value),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tl._variance.numpy(),
                               np.asarray(jl._buffers["_variance"].value),
                               rtol=RTOL, atol=1e-6)
    # the weights' gradients in training (the JAX trace updates its
    # buffers once more, from the batch alone)
    _layer_parity(jl, tl, x)
    # inference on the JAX layer's statistics
    with torch.no_grad():
        tl._mean.copy_(torch.from_numpy(np.array(
            jl._buffers["_mean"].value)))
        tl._variance.copy_(torch.from_numpy(np.array(
            jl._buffers["_variance"].value)))
    jl.eval()
    tl.eval()
    _layer_parity(jl, tl, _x(*shape, seed=2))


def test_batch_norm_layer_reaches_plain_batch_norm(monkeypatch):
    calls = []
    real = TF.norm.batch_norm
    monkeypatch.setattr(TF.norm, "batch_norm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(tnn.layer.norm.F, "batch_norm", TF.norm.batch_norm)
    tnn.BatchNorm2D(3)(torch.from_numpy(_x(2, 3, 4, 4)))
    assert calls == [1]


def test_sync_batch_norm_converts_a_tree():
    net = tnn.Sequential(tnn.Conv2D(3, 4, 3), tnn.BatchNorm2D(4))
    with torch.no_grad():
        net[1].weight.fill_(2.0)
        net[1]._mean.fill_(0.5)
    out = tnn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(out[1], tnn.SyncBatchNorm)
    assert float(out[1].weight.detach()[0]) == 2.0
    assert float(out[1]._mean[0]) == 0.5


@pytest.mark.parametrize("name,args,shape", [
    ("MaxPool2D", (2,), (2, 3, 6, 7)),
    ("MaxPool2D", (3, 2, 1), (2, 3, 6, 7)),
    ("AvgPool2D", (3, 2, 1), (2, 3, 6, 7)),
    ("AvgPool2D", (2,), (2, 3, 6, 6)),
    ("MaxPool1D", (2,), (2, 3, 9)),
    ("AvgPool1D", (3, 1, 1), (2, 3, 9)),
    ("AdaptiveAvgPool2D", (3,), (2, 3, 7, 8)),
    ("AdaptiveMaxPool2D", ((2, 3),), (2, 3, 7, 8)),
])
def test_pool_layers(name, args, shape):
    _layer_parity(getattr(jnn, name)(*args), getattr(tnn, name)(*args),
                  _x(*shape))


@pytest.mark.parametrize("name,args,shape", [
    ("Pad2D", ([1, 2, 0, 1], "reflect"), (2, 3, 4, 5)),
    ("Pad1D", (2, "replicate"), (2, 3, 5)),
    ("Pad3D", ([1, 0, 0, 1, 1, 1], "constant", 2.0), (1, 2, 3, 3, 3)),
    ("ZeroPad2D", ([1, 1, 2, 0],), (2, 3, 4, 5)),
    ("Upsample", (None, 2, "bilinear", True), (2, 3, 4, 5)),
    ("Upsample", ((5, 7),), (2, 3, 4, 5)),
    ("Flatten", (1, 2), (2, 3, 4, 5)),
    ("Identity", (), (2, 3)),
    ("PixelShuffle", (2,), (2, 8, 3, 3)),
    ("LocalResponseNorm", (3, 1e-2), (2, 6, 3, 3)),
    ("Unfold", ([2, 2], 1, 1), (2, 3, 4, 5)),
    ("CosineSimilarity", (), None),
    ("PairwiseDistance", (), None),
    ("PairwiseDistance", (1.0, 1e-6, True), None),
])
def test_shape_and_distance_layers(name, args, shape):
    jl, tl = getattr(jnn, name)(*args), getattr(tnn, name)(*args)
    inputs = (_x(4, 6), _x(4, 6, seed=1)) if shape is None else (_x(*shape),)
    _layer_parity(jl, tl, *inputs)


def test_bilinear_layers():
    for name in ("Bilinear", "BilinearTensorProduct"):
        _layer_parity(getattr(jnn, name)(4, 5, 3),
                      getattr(tnn, name)(4, 5, 3), _x(6, 4), _x(6, 5, seed=1))
    tl = tnn.Bilinear(4, 5, 3, None, False)
    assert tl.bias is None and tuple(tl.weight.shape) == (3, 4, 5)


def test_row_conv_layer_with_lengths():
    jl, tl = jnn.RowConv(4, 2), tnn.RowConv(4, 2)
    _pair(jl, tl)
    x, lens = _x(3, 6, 4), np.array([6, 2, 4], np.int32)
    np.testing.assert_allclose(
        _np(tl(torch.from_numpy(x), torch.from_numpy(lens))),
        np.asarray(jl(jnp.asarray(x), jnp.asarray(lens))), rtol=RTOL,
        atol=1e-6)


def test_spectral_norm_layer_updates_u():
    jl, tl = jnn.SpectralNorm((4, 6), 0, 2), tnn.SpectralNorm((4, 6), 0, 2)
    for seed in range(2):
        w = _x(4, 6, seed=seed)
        np.testing.assert_allclose(_np(tl(torch.from_numpy(w))),
                                   np.asarray(jl(jnp.asarray(w))), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(tl._u.numpy(),
                                   np.asarray(jl._buffers["_u"].value),
                                   rtol=1e-4, atol=1e-6)


def test_ctc_loss_layer():
    rng = np.random.default_rng(5)
    lp, lab = _x(10, 3, 6), rng.integers(1, 6, (3, 4)).astype(np.int32)
    il, ll = np.array([10, 8, 6], np.int32), np.array([4, 3, 1], np.int32)
    for red in ("mean", "sum", "none"):
        ref = jnn.CTCLoss(0, red)(jnp.asarray(lp), jnp.asarray(lab),
                                  jnp.asarray(il), jnp.asarray(ll))
        got = tnn.CTCLoss(0, red)(*(torch.from_numpy(a)
                                    for a in (lp, lab, il, ll)))
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("name,shape,p", [
    ("Dropout2D", (8, 32, 3, 3), 0.3),
    ("Dropout3D", (4, 32, 2, 2, 2), 0.5),
    ("AlphaDropout", (64, 64), 0.2),
])
def test_dropout_layers_statistics_and_eval(name, shape, p):
    tl = getattr(tnn, name)(p)
    x = torch.from_numpy(_x(*shape))
    P.seed(4)
    y = tl(x)
    if name == "AlphaDropout":
        # the affine correction keeps N(0, 1) inputs at mean 0, variance 1
        big = tl(torch.randn(400, 400, generator=torch.Generator()
                             .manual_seed(0)))
        assert abs(float(big.mean())) < 0.02
        assert abs(float(big.var()) - 1.0) < 0.03
    else:
        per = y.reshape(shape[0], shape[1], -1)
        dropped = (per == 0).all(-1)
        kept = torch.isclose(per, x.reshape(per.shape) / (1 - p)).all(-1)
        assert bool((dropped | kept).all())
        assert abs(float(dropped.float().mean()) - p) < 0.12
    P.seed(4)
    assert torch.equal(tl(x), y)
    tl.eval()
    assert torch.equal(tl(x), x)


def test_embedding_sparse_gradient_is_the_dense_one():
    """``sparse=True`` gives the dense lookup's gradient bit for bit, and
    the JAX package's (its deduplicated-rows ``sparse_lookup``) within
    rtol 1e-6; the padding row's gradient is zero."""
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 9, (5, 7)).astype(np.int64)
    ids[0, :4] = 3
    w = _x(12, 4)
    c = torch.from_numpy(_x(5, 7, 4, seed=3))
    grads = []
    for sparse in (False, True):
        wt = torch.from_numpy(w).requires_grad_()
        (TF.embedding(torch.from_numpy(ids), wt, 3, sparse) * c).sum(
            ).backward()
        grads.append(wt.grad)
    assert torch.equal(grads[0], grads[1])
    assert float(grads[1][3].abs().max()) == 0.0
    jg = jax.grad(lambda w_: jnp.sum(JF.embedding(
        jnp.asarray(ids), w_, 3, True) * jnp.asarray(c.numpy())))(
            jnp.asarray(w))
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    layer = tnn.Embedding(12, 4, None, True)
    assert layer.sparse
    layer(torch.from_numpy(ids)).sum().backward()
    assert layer.weight.grad.shape == (12, 4) and layer.weight.grad.layout \
        == torch.strided
