"""The port's detection ops (``paddle_tpu_torch.ops.vision``) against the
JAX package's, on the CPU, beyond the op table's cases
(``tests/test_torch_ops.py`` runs ``ops.cases`` for the nine exported
ops).

Tolerance: fp32 results within 1e-5 of the largest reference value;
``yolo_loss``'s gradient with respect to x (against ``jax.grad``) within
1e-4 of the largest.  Integer outputs equal, compared by value and dtype
kind (the JAX package returns int32 with x64 off).  NMS inputs have
distinct scores, so both packages' sorts (``jnp.argsort`` /
``lax.top_k``, ``torch.sort``) order the candidates one way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.vision as J
import paddle_tpu_torch as P
import paddle_tpu_torch.ops.vision as T

TOL = 1e-5            # fp32 functions, of the largest reference value
TOL_GRAD = 1e-4       # yolo_loss's gradient
ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]


@pytest.fixture(autouse=True)
def _cpu():
    with P.device_guard("cpu"):
        yield


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype.kind == ref.dtype.kind, (
        got.shape, ref.shape, got.dtype, ref.dtype)
    if ref.dtype.kind in "biu":
        np.testing.assert_array_equal(got, ref)
    elif ref.size:
        err = float(np.abs(got - ref).max())
        assert err <= tol * max(float(np.abs(ref).max()), 1e-30), err


def _both(name, *args, **kw):
    """The JAX and the port results of ``name`` on numpy ``args``."""
    def conv(fw):
        return [fw(a) if isinstance(a, np.ndarray) else a for a in args]

    ref = getattr(J, name)(*conv(jnp.asarray), **kw)
    got = getattr(T, name)(*conv(torch.from_numpy), **kw)
    if not isinstance(ref, tuple):
        ref, got = (ref,), (got,)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        _close(g, r)
    return ref, got


def _boxes(rng, n, scale=1.0):
    xy = rng.uniform(0.0, 0.6, (n, 2))
    wh = rng.uniform(0.05, 0.4, (n, 2))
    return (np.concatenate([xy, xy + wh], 1) * scale).astype(np.float32)


def _f(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def test_expand_aspect_ratios_is_the_reference():
    for ratios, flip in (((1.0, 2.0, 3.0), True), ((0.5, 1.0, 2.0), False),
                         ((2.0, 0.5), True), ((1.0 + 1e-7,), True)):
        assert T.expand_aspect_ratios(ratios, flip) == \
            J.expand_aspect_ratios(ratios, flip)


@pytest.mark.parametrize("clip,flatten", [(False, False), (True, True)])
def test_density_prior_box_matches(clip, flatten):
    _both("density_prior_box", (3, 4), (60, 80), [2, 1], [20.0, 40.0],
          [1.0, 2.0], clip=clip, steps=(0.0, 24.0), flatten_to_2d=flatten)


def test_density_prior_box_rejects_unpaired_sizes():
    with pytest.raises(ValueError):
        T.density_prior_box((2, 2), (8, 8), [1, 2], [4.0])


@pytest.mark.parametrize("masked,groups", [(True, 1), (False, 2)])
def test_deformable_conv_matches(masked, groups):
    rng = np.random.default_rng(3)
    dg, k = 2, 3
    x = _f(rng, 2, 4, 6, 7)
    offset = _f(rng, 2, 2 * dg * k * k, 6, 7, lo=-2.0, hi=2.0)
    mask = _f(rng, 2, dg * k * k, 6, 7, lo=0.0, hi=1.0) if masked else None
    weight = _f(rng, 6, 4 // groups, k, k)
    _both("deformable_conv", x, offset, weight, mask, 1, 1, 1, groups, dg,
          _f(rng, 6))


def test_deformable_conv_strided_dilated_matches():
    rng = np.random.default_rng(4)
    x = _f(rng, 1, 2, 9, 8)
    # k_eff = 3 (2 - 1) + 1 = 4: (9 + 2 - 4) // 2 + 1 = 4 rows and
    # (8 + 2 - 4) // 2 + 1 = 4 cols
    offset = _f(rng, 1, 2 * 4, 4, 4, lo=-3.0, hi=3.0)
    _both("deformable_conv", x, offset, _f(rng, 3, 2, 2, 2), None, 2, 1, 3)


def test_psroi_pool_matches_and_checks_channels():
    rng = np.random.default_rng(5)
    x = _f(rng, 2, 2 * 3 * 2, 9, 10)
    rois = _boxes(rng, 4, 9.0)
    rois[0] = [-3.0, -2.0, 20.0, 30.0]          # beyond the map
    _both("psroi_pool", x, rois, np.array([0, 1, 1, 0], np.int32), 2, 3, 2,
          spatial_scale=0.8)
    with pytest.raises(ValueError):
        T.psroi_pool(torch.zeros(1, 5, 4, 4), torch.zeros(1, 4),
                     torch.zeros(1, dtype=torch.int32), 2, 1, 2)


def test_roi_align_fixed_ratio_and_outside_samples():
    """sampling_ratio -1 samples 2 x 2 a bin (the JAX package's fixed
    ratio); samples beyond [-1, H] count zero."""
    rng = np.random.default_rng(6)
    x = _f(rng, 2, 8, 9)
    rois = np.array([[0.0, 0.0, 30.0, 25.0], [-6.0, -6.0, 3.0, 2.0],
                     [2.0, 3.0, 2.5, 3.2]], np.float32)
    (r,), (g,) = _both("roi_align", x, rois, (4, 3))
    assert g.shape == (3, 2, 4, 3)
    two = T.roi_align(torch.from_numpy(x), torch.from_numpy(rois), (4, 3),
                      sampling_ratio=2)
    np.testing.assert_array_equal(two.numpy(), g.numpy())


def test_box_coder_rejects_mismatched_priors():
    with pytest.raises(ValueError):
        T.box_coder(torch.zeros(3, 4), None, torch.zeros(2, 5, 4),
                    "decode_center_size")
    with pytest.raises(ValueError):
        T.box_coder(torch.zeros(3, 4), None, torch.zeros(2, 4), "unknown")


def test_yolo_head_channel_check():
    with pytest.raises(ValueError):
        T.yolo_box(torch.zeros(1, 10, 2, 2), torch.ones(1, 2), [1, 2], 3)


def _gt(rng, n=2, b=6):
    box = np.concatenate([rng.uniform(0.2, 0.8, (n, b, 2)),
                          rng.uniform(0.05, 0.6, (n, b, 2))], -1)
    box[1, -2:] = 0.0                           # padding rows
    return box.astype(np.float32), rng.integers(0, 3, (n, b)).astype(
        np.int32)


@pytest.mark.parametrize("mask,smooth,score", [
    ([2, 3], False, False), ([0, 1, 2, 3, 4, 5], True, True)])
def test_yolo_loss_and_its_gradient_match(mask, smooth, score):
    rng = np.random.default_rng(len(mask))
    x = _f(rng, 2, len(mask) * 8, 4, 5, lo=-2.0, hi=2.0)
    box, label = _gt(rng)
    kw = dict(anchors=ANCHORS, anchor_mask=mask, class_num=3,
              ignore_thresh=0.3, downsample_ratio=16,
              use_label_smooth=smooth)
    gs = _f(rng, 2, 6, lo=0.0, hi=1.0) if score else None
    jgs = None if gs is None else jnp.asarray(gs)
    tgs = None if gs is None else torch.from_numpy(gs)

    def jsum(xx):
        return jnp.sum(J.yolo_loss(xx, jnp.asarray(box), jnp.asarray(label),
                                   gt_score=jgs, **kw) * jnp.array([1.0, 0.5]))

    ref = J.yolo_loss(jnp.asarray(x), jnp.asarray(box), jnp.asarray(label),
                      gt_score=jgs, **kw)
    jgrad = jax.grad(jsum)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = T.yolo_loss(tx, torch.from_numpy(box), torch.from_numpy(label),
                      gt_score=tgs, **kw)
    _close(got, ref)
    (got * torch.tensor([1.0, 0.5])).sum().backward()
    _close(tx.grad, jgrad, TOL_GRAD)


def test_yolo_loss_two_gts_on_one_cell_match():
    """Two gts of an image on one anchor and cell: the later one's box
    targets are written (the JAX package's scatter), both classes set."""
    rng = np.random.default_rng(9)
    box, label = _gt(rng)
    box[0, 1] = box[0, 0] + np.array([0.01, 0.01, 0.005, 0.0], np.float32)
    label[0, :2] = [0, 2]
    x = _f(rng, 2, 6 * 8, 4, 5)
    kw = dict(anchors=ANCHORS, anchor_mask=[0, 1, 2, 3, 4, 5], class_num=3,
              downsample_ratio=16)
    # the two gts share an anchor and a cell
    gw = box[0, :2, 2] * 16 * 5
    gh = box[0, :2, 3] * 16 * 4
    anc = np.array(ANCHORS, np.float32).reshape(-1, 2)
    inter = np.minimum(gw[:, None], anc[:, 0]) * np.minimum(gh[:, None],
                                                            anc[:, 1])
    best = np.argmax(inter / (gw[:, None] * gh[:, None]
                              + anc[:, 0] * anc[:, 1] - inter), 1)
    assert best[0] == best[1]
    W, H = 5, 4
    assert (box[0, 0, :2] * [W, H]).astype(int).tolist() == \
        (box[0, 1, :2] * [W, H]).astype(int).tolist()
    _both("yolo_loss", x, box, label, **kw)


def _distinct(rng, *shape):
    n = int(np.prod(shape))
    return ((rng.permutation(n) + 0.5) / n).reshape(shape).astype(np.float32)


@pytest.mark.parametrize("keep_top_k,background", [(100, -1), (200, 1)])
def test_multiclass_nms_matches_with_padding(keep_top_k, background):
    rng = np.random.default_rng(keep_top_k)
    boxes, scores = _boxes(rng, 50), _distinct(rng, 4, 50)
    (rd, rn), (gd, gn) = _both("multiclass_nms", boxes, scores,
                               score_threshold=0.3, nms_top_k=40,
                               keep_top_k=keep_top_k, nms_threshold=0.4,
                               background_label=background)
    assert gn.dtype == torch.int32 and gd.shape == (keep_top_k, 6)
    n = int(gn)
    assert 0 < n < keep_top_k
    assert (gd[n:, 0] == -1).all() and (gd[n:, 1:] == 0).all()
    assert (gd[:n, 1][:-1] > gd[:n, 1][1:]).all()        # by score
    if background >= 0:
        assert (gd[:n, 0] != background).all()


def test_nms_batched_is_each_image_alone():
    """The batched NMS the detector runs gives each image's own result."""
    rng = np.random.default_rng(11)
    boxes = torch.from_numpy(np.stack([_boxes(rng, 40) for _ in range(3)]))
    scores = torch.from_numpy(_distinct(rng, 3, 5, 40))
    dets, num = T._multiclass_nms(boxes, scores, 0.2, 30, 60, 0.45, True,
                                  -1)
    for i in range(3):
        d, n = T.multiclass_nms(boxes[i], scores[i], 0.2, 30, 60, 0.45)
        assert torch.equal(dets[i], d) and int(num[i]) == int(n)


def test_nms_greedy_suppression_by_hand():
    """Three boxes of one class: 0 and 1 overlap (IoU 0.6), 2 apart; the
    second highest score is suppressed, the third kept."""
    boxes = torch.tensor([[0.0, 0.0, 1.0, 1.0], [0.0, 0.0, 1.0, 0.6],
                          [2.0, 2.0, 3.0, 3.0]])
    scores = torch.tensor([[0.9, 0.8, 0.7]])
    dets, n = T.multiclass_nms(boxes, scores, 0.1, 10, 4, 0.5)
    assert int(n) == 2
    np.testing.assert_allclose(dets[:2, 1].numpy(), [0.9, 0.7])
    assert dets[2:, 0].tolist() == [-1.0, -1.0]
    dets, n = T.multiclass_nms(boxes, scores, 0.1, 10, 4, 0.65)
    assert int(n) == 3


def test_creation_ops_follow_the_current_device():
    with P.device_guard("cpu"):
        a, v = T.anchor_generator((2, 2))
        b, _ = T.prior_box((2, 2), (8, 8), [4.0])
    assert a.device.type == v.device.type == b.device.type == "cpu"
