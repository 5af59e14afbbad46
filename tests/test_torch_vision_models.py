"""The port's vision models, datasets and transforms against the JAX
package's, on the CPU.

Each model is built in both packages, the JAX weights and BatchNorm
statistics carried into the port's by ``convert.from_jax_params(params,
model, buffers=...)``, and held on the same numpy inputs from a seed:

* eval-mode outputs (logits; YOLOv3's three heads) within 1e-4 of the
  largest reference value;
* an eval-mode step (BatchNorm on its running statistics): the loss
  within 1e-4 relative, every gradient within 1e-4 of its own largest
  reference value, floored at 1e-2 of the largest gradient of all (a
  gradient that is zero in exact arithmetic, such as a bias ahead of a
  BatchNorm, is rounding noise in both packages);
* a train-mode step (BatchNorm on batch statistics): the loss, all
  gradients as one vector and all running statistics after the step as
  one vector, each within 1e-4 relative (L2) -- or within ``CHAOS``
  times the relative distance the port's own step moves when its input
  is scaled by 1 + 1e-6, where the function is less well conditioned
  than that.  Train-mode BatchNorm at random initialization makes a
  deep network's step chaotic: that perturbation moves ResNet-50's
  gradients (64 px, b2) by 1.2% (L2) and 30% of some tensors' own size,
  and the packages lie 5% apart, so no fixed tolerance separates a fault
  from fp32 rounding there.  The eval-mode step runs the same layers'
  backward in a well-conditioned regime and holds it tensor by tensor.
  Sizes keep every train-mode BatchNorm over at least 8 values: at 32 px
  and b2 the last stage of ResNet-50 and MobileNet V2 is 1 x 1, where a
  BatchNorm normalizes two values and the step is degenerate;
* YOLOv3's ``predict`` (``yolo_box`` + ``multiclass_nms``): the number of
  detections each image, their labels, and scores and boxes within 1e-4
  of the largest value, on heads whose scores are all distinct.

Datasets and transforms are numpy in both packages and compared bit for
bit, ``random_split`` by its indices for one integer seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
import paddle_tpu.nn.functional as JF
import paddle_tpu.vision as JV
from paddle_tpu.autograd import buffers_dict, functional_call, parameters_dict
import paddle_tpu_torch as P
import paddle_tpu_torch.nn.functional as TF
import paddle_tpu_torch.vision as TV
from paddle_tpu_torch import convert

TOL_MODEL = 1e-4      # outputs, losses, gradients, BN statistics
PERTURB = 1e-6        # relative input change that measures conditioning
CHAOS = 10.0          # allowed multiple of the distance it moves a value


@pytest.fixture(autouse=True)
def _cpu():
    with P.device_guard("cpu"):
        yield


def _carry(jmodel, tmodel):
    convert.from_jax_params(
        {k: np.asarray(v) for k, v in parameters_dict(jmodel).items()},
        tmodel, buffers={k: np.asarray(v)
                         for k, v in buffers_dict(jmodel).items()})


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, tol=TOL_MODEL, what="", floor=0.0):
    """max |got - ref| within ``tol`` of max(|ref|, floor)."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if not ref.size:
        return
    err = float(np.abs(got - ref).max())
    assert err <= tol * max(float(np.abs(ref).max()), floor), (what, err)


def _l2(a, b):
    """|a - b| / |b| over the values of two dicts, as one vector each."""
    d = sum(float(((_np(a[k]) - _np(b[k])) ** 2).sum()) for k in b)
    n = sum(float((_np(b[k]) ** 2).sum()) for k in b)
    return (d / max(n, 1e-300)) ** 0.5


def _port_step(tmodel, loss_fn, x):
    """The port's loss, gradients and buffers after one step at x."""
    loss = loss_fn(tmodel(x))
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in tmodel.named_parameters()}
    tmodel.clear_gradients()
    bufs = {k: b.detach().clone() for k, b in tmodel.named_buffers()}
    return {"loss": loss.detach()}, grads, bufs


def _step_check(jmodel, tmodel, x, jloss_fn, tloss_fn, train):
    """One step in eval or train mode in both packages: the loss, the
    gradients and the BatchNorm statistics after it (module docstring)."""
    for m in (jmodel, tmodel):
        m.train() if train else m.eval()
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if train:
        start = {k: b.clone() for k, b in tmodel.named_buffers()}
        moved_to = _port_step(tmodel, tloss_fn, tx * (1 + PERTURB))
        for k, b in tmodel.named_buffers():
            b.copy_(start[k])
    got = _port_step(tmodel, tloss_fn, tx)
    # an eager jax.grad updates the JAX model's statistics once (its
    # stop_gradient of the batch statistics is concrete there), as the
    # port's forward did
    jv, jg = jax.value_and_grad(
        lambda p: jloss_fn(functional_call(jmodel, p, (jx,))))(
            parameters_dict(jmodel))
    ref = ({"loss": jv}, jg, buffers_dict(jmodel))
    for i, what in enumerate(("loss", "gradients", "statistics")):
        g, r = got[i], ref[i]
        assert set(g) == set(r), what
        if not r:
            continue
        if train:
            allowed = max(TOL_MODEL, CHAOS * _l2(moved_to[i], g))
            err = _l2(g, r)
            assert err <= allowed, (what, err, allowed)
        elif what == "gradients":
            top = max(float(np.abs(_np(v)).max()) for v in r.values())
            for k in r:
                _close(g[k], r[k], what=k, floor=1e-2 * top)
        else:
            for k in r:
                _close(g[k], r[k], what=k)


def _classifier_check(jmodel, tmodel, x, classes, seed):
    """Eval logits, then an eval-mode and a train-mode step of the mean
    cross entropy."""
    labels = np.random.default_rng(seed).integers(0, classes, (x.shape[0], 1))
    jl, tl = jnp.asarray(labels, jnp.int32), torch.from_numpy(labels)
    jmodel.eval()
    tmodel.eval()
    with torch.no_grad():
        _close(tmodel(torch.from_numpy(x)), jmodel(jnp.asarray(x)),
               what="eval logits")
    for train in (False, True):
        _step_check(jmodel, tmodel, x,
                    lambda out: jnp.mean(JF.cross_entropy(out, jl)),
                    lambda out: P.mean(TF.cross_entropy(out, tl)), train)


def _img(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ResNet-50 at 64 px: at 32 px its last stage is 1 x 1, where each of its
# nine train-mode BatchNorms normalizes two values (b2), a degenerate case
@pytest.mark.parametrize("depth,size,fmt", [
    (18, 32, "NCHW"), (18, 32, "NHWC"), (50, 64, "NCHW"), (50, 64, "NHWC")])
def test_resnet_matches_the_reference(depth, size, fmt):
    kw = dict(num_classes=10, data_format=fmt)
    jm = getattr(JV.models, f"resnet{depth}")(**kw)
    tm = getattr(TV.models, f"resnet{depth}")(
        **kw, generator=torch.Generator().manual_seed(0))
    _carry(jm, tm)
    shape = (2, 3, size, size) if fmt == "NCHW" else (2, size, size, 3)
    _classifier_check(jm, tm, _img(depth + size, *shape), 10, depth)


def test_resnet_layouts_agree_on_one_set_of_weights():
    """The NCHW model on the NHWC model's weights gives its logits."""
    g = torch.Generator().manual_seed(1)
    nhwc = TV.models.resnet18(num_classes=10, data_format="NHWC",
                              generator=g)
    nchw = TV.models.resnet18(num_classes=10)
    nchw.set_state_dict(nhwc.state_dict())
    x = torch.from_numpy(_img(2, 2, 3, 32, 32))
    nhwc.eval()
    nchw.eval()
    with torch.no_grad():
        _close(nhwc(x.permute(0, 2, 3, 1).contiguous()),
               nchw(x).numpy(), tol=1e-5)


@pytest.mark.parametrize("name,size", [
    ("lenet", 28), ("vgg11_bn", 32), ("mobilenet_v1", 64),
    ("mobilenet_v2", 64)])
def test_classifier_matches_the_reference(name, size):
    g = torch.Generator().manual_seed(0)
    if name == "lenet":
        jm, tm, ch = JV.models.LeNet(), TV.models.LeNet(generator=g), 1
    elif name == "vgg11_bn":
        # no dropout in the compared step: the two packages' masks differ
        jm = JV.models.vgg11(batch_norm=True, num_classes=10, dropout=0.0)
        tm = TV.models.vgg11(batch_norm=True, num_classes=10, dropout=0.0,
                             generator=g)
        ch = 3
    else:
        jm = getattr(JV.models, name)(num_classes=10)
        tm = getattr(TV.models, name)(num_classes=10, generator=g)
        ch = 3
    _carry(jm, tm)
    if name == "mobilenet_v2":      # its classifier's dropout 0.2
        jm.classifier[0].p = tm.classifier[0].p = 0.0
    _classifier_check(jm, tm, _img(size, 2, ch, size, size), 10, 3)


def test_mobilenet_depthwise_groups():
    m = TV.models.mobilenet_v1(num_classes=10)
    dw = m.blocks[0].dw.conv
    assert dw.groups == dw.weight.shape[0] == 32
    assert tuple(dw.weight.shape[1:]) == (1, 3, 3)


# -- YOLOv3 -------------------------------------------------------------------

YOLO_CLASSES = 4
YOLO_SIZE = 64
KEEP = 1100           # past the 4 x 252 candidates: both kinds of padding


def _yolo_pair():
    jm = JV.models.yolov3_darknet53(num_classes=YOLO_CLASSES)
    tm = TV.models.yolov3_darknet53(
        num_classes=YOLO_CLASSES, generator=torch.Generator().manual_seed(0))
    _carry(jm, tm)
    return jm, tm


def _gt(rng, n, n_gt=6):
    wh = rng.uniform(0.05, 0.4, (n, n_gt, 2))
    cxy = rng.uniform(0.2, 0.8, (n, n_gt, 2))
    box = np.concatenate([cxy, wh], -1).astype(np.float32)
    box[1, -2:] = 0.0                           # padding rows
    return box, rng.integers(0, YOLO_CLASSES, (n, n_gt)).astype(np.int32)


def test_yolov3_train_step_matches_the_reference():
    jm, tm = _yolo_pair()
    x = _img(6, 2, 3, YOLO_SIZE, YOLO_SIZE)
    box, label = _gt(np.random.default_rng(5), 2)
    jm.eval()
    tm.eval()
    with torch.no_grad():
        for t, j in zip(tm(torch.from_numpy(x)), jm(jnp.asarray(x))):
            _close(t, j, what="eval head")
    for train in (False, True):
        _step_check(jm, tm, x,
                    lambda heads: jm.loss(heads, jnp.asarray(box),
                                          jnp.asarray(label)),
                    lambda heads: tm.loss(heads, torch.from_numpy(box),
                                          torch.from_numpy(label)), train)


def test_yolov3_predict_matches_the_reference():
    jm, tm = _yolo_pair()
    jm.eval()
    tm.eval()
    x = _img(7, 2, 3, YOLO_SIZE, YOLO_SIZE)
    heads = [np.asarray(h) for h in jm(jnp.asarray(x))]
    # distinct scores, so both packages sort the candidates one way
    flat = np.concatenate([h.ravel() for h in heads])
    assert len(np.unique(flat)) == flat.size
    img_size = np.array([[YOLO_SIZE, YOLO_SIZE], [YOLO_SIZE, 48]], np.int32)
    jd, jn = jm.predict([jnp.asarray(h) for h in heads],
                        jnp.asarray(img_size), keep_top_k=KEEP)
    td, tn = tm.predict([torch.from_numpy(h) for h in heads],
                        torch.from_numpy(img_size), keep_top_k=KEEP)
    assert tn.dtype == torch.int32
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    jd, td = np.asarray(jd), td.numpy()
    assert td.shape == jd.shape == (2, KEEP, 6)
    np.testing.assert_array_equal(td[..., 0], jd[..., 0])   # labels, -1 pads
    _close(td[..., 1:], jd[..., 1:], what="scores and boxes")
    assert (jd[..., 0] == -1).any()              # padding rows exercised
    assert (jd[..., 0] >= 0).sum() > 20


# -- datasets, transforms, random_split ---------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("MNIST", dict(mode="train", synthetic_size=64)),
    ("FashionMNIST", dict(mode="test", synthetic_size=64)),
    ("Cifar10", dict(mode="train", synthetic_size=32)),
    ("Cifar100", dict(mode="test", synthetic_size=32)),
    ("Flowers", dict(mode="train", size=16, synthetic_size=8)),
    ("VOC2012", dict(mode="test", size=16, synthetic_size=8))])
def test_synthetic_dataset_is_the_reference_bit_for_bit(name, kw):
    jd, td = getattr(JV.datasets, name)(**kw), getattr(TV.datasets, name)(**kw)
    assert len(jd) == len(td) > 0
    for i in (0, 1, len(jd) - 1):
        for a, b in zip(jd[i], td[i]):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_mnist_reads_local_idx_files(tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, 5).astype(np.uint8)
    ip, lp = tmp_path / "img.idx", tmp_path / "lbl.idx"
    ip.write_bytes(np.array([2051, 5, 28, 28], ">u4").tobytes()
                   + imgs.tobytes())
    lp.write_bytes(np.array([2049, 5], ">u4").tobytes() + labels.tobytes())
    jd = JV.datasets.MNIST(str(ip), str(lp))
    td = TV.datasets.MNIST(str(ip), str(lp))
    for i in range(5):
        np.testing.assert_array_equal(td[i][0], jd[i][0])
        assert td[i][1] == jd[i][1] == labels[i]


def test_transforms_are_the_reference_bit_for_bit():
    x = np.random.default_rng(0).uniform(0, 255, (3, 20, 24)).astype(
        np.float32)
    hwc = np.random.default_rng(1).integers(0, 256, (8, 6, 3)).astype(
        np.uint8)

    def pipeline(T):
        return T.Compose([T.RandomCrop(16, padding=2),
                          T.RandomHorizontalFlip(0.5), T.Resize((12, 10)),
                          T.CenterCrop(8),
                          T.Normalize([0.5, 0.4, 0.3], [0.2, 0.3, 0.4])])

    for seed in range(4):
        np.random.seed(seed)
        ref = pipeline(JV.transforms)(x)
        np.random.seed(seed)
        got = pipeline(TV.transforms)(x)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(TV.transforms.ToTensor()(hwc),
                                  JV.transforms.ToTensor()(hwc))


def test_io_datasets_and_random_split_match_the_reference():
    a = np.arange(20).reshape(10, 2)
    b = np.arange(10) * 3
    jt, tt = jio.TensorDataset([a, b]), P.io.TensorDataset([a, b])
    js = jio.random_split(jt, [3, 7], generator=5)
    ts = P.io.random_split(tt, [3, 7], generator=5)
    for j, t in zip(js, ts):
        assert t.indices == j.indices
        for i in range(len(j)):
            for u, v in zip(t[i], j[i]):
                np.testing.assert_array_equal(u, v)
    chain = P.io.ChainDataset([tt, P.io.Subset(tt, [4, 2])])
    assert len(chain) == 12
    np.testing.assert_array_equal(chain[11][1], b[2])
    comp = P.io.ComposeDataset([tt, P.io.TensorDataset([b[:6]])])
    assert len(comp) == 6 and len(comp[1]) == 3
    with pytest.raises(TypeError):
        len(P.io.IterableDataset())


# -- names: the packages this slice completes or repairs ----------------------

def _names(mod):
    """A package's public names but its submodules (which other tests may
    have imported into this process; the tests name the ones they
    need)."""
    import types

    return {n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)}


def test_vision_package_has_every_reference_name():
    assert _names(JV.models) <= _names(TV.models)
    for sub in ("datasets", "models", "transforms"):
        assert getattr(TV, sub).__name__ == f"paddle_tpu_torch.vision.{sub}"
    assert _names(JV.datasets) - {"Optional"} <= _names(TV.datasets)
    assert _names(JV.transforms) <= _names(TV.transforms)
    assert P.vision is TV


def test_text_and_core_export_the_reference_names():
    import paddle_tpu.core as jcore
    import paddle_tpu.text as jtext
    import paddle_tpu_torch.core as tcore
    import paddle_tpu_torch.text as ttext
    from paddle_tpu.text import datasets as jdatasets

    datasets = {n for n in _names(jtext)
                if getattr(getattr(jtext, n), "__module__", "")
                == jdatasets.__name__}
    assert _names(jtext) - datasets <= _names(ttext)
    assert _names(jcore) <= _names(tcore)
    for sub in ("dtype", "errors", "flags", "lod", "random"):
        assert getattr(tcore, sub).__name__ == f"paddle_tpu_torch.core.{sub}"
    assert set(jcore.errors.__all__) <= set(tcore.errors.__all__)
    for name in jcore.errors.__all__:
        jc, tc = getattr(jcore.errors, name), getattr(tcore.errors, name)
        if isinstance(jc, type):
            assert [b.__name__ for b in jc.__mro__] == \
                [b.__name__ for b in tc.__mro__], name
    from paddle_tpu_torch.core import errors, set_device  # noqa: F401
    from paddle_tpu_torch.text import ErnieModel  # noqa: F401
    with pytest.raises(errors.NotFoundError):
        errors.enforce(False, errors.NotFoundError, "missing")
    with pytest.raises(KeyError):
        errors.enforce(False, errors.NotFoundError, "missing")


def test_lazy_submodules_include_io_and_vision():
    assert {"io", "vision"} <= set(P._LAZY_SUBMODULES)
    assert P.io.Dataset is P.io.dataset.Dataset
