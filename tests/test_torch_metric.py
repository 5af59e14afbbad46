"""The port's metrics (``paddle_tpu_torch.metric``) against the JAX
package's, on the CPU, on the same numpy inputs from a seed, within 1e-6:

* ``Accuracy`` top-1 and top-(1, 5): ``compute`` in torch against
  ``compute`` in ``jnp`` (the hits, ties included: of equal scores the
  later class ranks first in both), then ``update`` / ``accumulate`` over
  several batches;
* ``Precision``, ``Recall``, ``Auc`` (probabilities and two-column
  scores), ``ChunkEvaluator``, ``DetectionMAP`` (both AP versions,
  difficult boxes evaluated or not) over several updates;
* updates take tensors as well as arrays.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.metric as jmetric
import paddle_tpu_torch.metric as tmetric

TOL = 1e-6


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=TOL,
                               atol=TOL)


def _scores(rng, n, c, ties=True):
    s = rng.integers(0, 6, (n, c)).astype(np.float32) if ties else \
        rng.normal(size=(n, c)).astype(np.float32)
    return s


@pytest.mark.parametrize("topk", [1, (1, 5), (2, 3)])
def test_accuracy_compute_and_accumulate(topk):
    rng = np.random.default_rng(7)
    jm, tm = jmetric.Accuracy(topk=topk), tmetric.Accuracy(topk=topk)
    for step in range(4):
        pred = _scores(rng, 12, 8, ties=step % 2 == 0)
        label = rng.integers(0, 8, (12, 1)).astype(np.int32)
        jc = jm.compute(jnp.asarray(pred), jnp.asarray(label))
        tc = tm.compute(torch.from_numpy(pred), torch.from_numpy(label))
        assert tc.dtype == torch.float32
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        _close(tm.update(tc), jm.update(jc))
    _close(tm.accumulate(), jm.accumulate())
    assert type(tm.accumulate()) is type(jm.accumulate())


def test_accuracy_tie_ranks_the_later_class_first():
    pred = np.array([[0.5, 0.9, 0.9, 0.1]], np.float32)
    for label, hit in ((2, 1.0), (1, 0.0)):
        y = np.array([[label]], np.int32)
        tc = tmetric.Accuracy().compute(torch.from_numpy(pred),
                                        torch.from_numpy(y))
        jc = jmetric.Accuracy().compute(jnp.asarray(pred), jnp.asarray(y))
        assert float(tc[0, 0]) == float(np.asarray(jc)[0, 0]) == hit


@pytest.mark.parametrize("name", ["Precision", "Recall"])
def test_precision_recall(name):
    rng = np.random.default_rng(11)
    jm, tm = getattr(jmetric, name)(), getattr(tmetric, name)()
    for _ in range(3):
        preds = rng.uniform(size=(20, 1)).astype(np.float32)
        labels = rng.integers(0, 2, (20, 1)).astype(np.int64)
        jm.update(preds, labels)
        tm.update(torch.from_numpy(preds), torch.from_numpy(labels))
    _close(tm.accumulate(), jm.accumulate())
    assert tm.name() == jm.name()


@pytest.mark.parametrize("two_columns", [False, True])
def test_auc(two_columns):
    rng = np.random.default_rng(13)
    jm, tm = jmetric.Auc(num_thresholds=255), tmetric.Auc(num_thresholds=255)
    for _ in range(3):
        p = rng.uniform(size=(32,)).astype(np.float32)
        labels = (rng.uniform(size=32) < p).astype(np.int64)
        preds = np.stack([1 - p, p], 1) if two_columns else p[:, None]
        jm.update(preds, labels)
        tm.update(torch.from_numpy(preds), labels)
    _close(tm.accumulate(), jm.accumulate())
    tm.reset()
    assert tm.accumulate() == 0.0


def test_chunk_evaluator():
    jm, tm = jmetric.ChunkEvaluator(), tmetric.ChunkEvaluator()
    for counts in ((5, 6, 4), (3, 2, 2), (0, 1, 0)):
        _close(tm.update(*counts), jm.update(*counts))
    _close(tm.accumulate(), jm.accumulate())
    _close(tm.compute(1, 2), jm.compute(1, 2))


def _image(rng, n_det, n_gt, classes):
    gt = np.sort(rng.uniform(0, 1, (n_gt, 2, 2)), axis=1).reshape(n_gt, 4)
    gt = gt[:, [0, 2, 1, 3]].astype(np.float32)
    gt_labels = rng.integers(0, classes, n_gt)
    det = gt[rng.integers(0, n_gt, n_det)] + rng.normal(
        0, 0.05, (n_det, 4)).astype(np.float32)
    det_labels = np.where(rng.uniform(size=n_det) < 0.8,
                          gt_labels[rng.integers(0, n_gt, n_det)],
                          rng.integers(0, classes, n_det))
    scores = rng.uniform(size=n_det).astype(np.float32)
    difficult = rng.uniform(size=n_gt) < 0.2
    return det, det_labels, scores, gt, gt_labels, difficult


@pytest.mark.parametrize("ap_version", ["integral", "11point"])
@pytest.mark.parametrize("evaluate_difficult", [False, True])
def test_detection_map(ap_version, evaluate_difficult):
    rng = np.random.default_rng(17)
    kw = dict(overlap_threshold=0.5, evaluate_difficult=evaluate_difficult,
              ap_version=ap_version)
    jm, tm = jmetric.DetectionMAP(**kw), tmetric.DetectionMAP(**kw)
    for _ in range(4):
        det, dl, sc, gt, gl, diff = _image(rng, 12, 6, 4)
        jm.update(det, dl, sc, gt, gl, diff)
        tm.update(torch.from_numpy(det), torch.from_numpy(dl),
                  torch.from_numpy(sc), gt, gl, diff)
    _close(tm.accumulate(), jm.accumulate())
    assert tm.accumulate() > 0.0


def test_metric_exports_the_reference_names():
    assert tmetric.__all__ == jmetric.__all__
    for n in jmetric.__all__:
        assert getattr(tmetric, n).__module__ == "paddle_tpu_torch.metric." \
            "metrics"
