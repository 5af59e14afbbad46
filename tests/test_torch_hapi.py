"""The port's high-level API (``paddle_tpu_torch.hapi``) and checkpoints
against the JAX package's, on the CPU.

The JAX ``Model`` runs its jitted functional step (the tape is off
outside ``dygraph.guard()``), the port's its one eager step (ROADMAP.md
Queue 3); both train from the same weights, carried by
``convert.from_jax_params``, on the same batches:

* ``Model.fit`` of LeNet on synthetic MNIST (Adam 1e-3, batch 16) and of a
  2-layer, 64-wide ERNIE sentence classifier on synthetic IMDB (dropout 0;
  a wrapper that builds the token types and the padding mask from the
  ids; AdamW under a warm-up schedule with a global-norm clip): the loss
  of each of 3 steps within 1e-4 relative, every parameter after them
  within 1e-4 of its largest value (floored at 1e-2 of the largest of
  all; ERNIE's key-projection biases, whose gradient is 0 in exact
  arithmetic, within Adam's 3 steps of 0 in both);
  then ``evaluate`` (loss, accuracy) and ``predict`` within 1e-5;
* ``EarlyStopping``'s stop epoch and ``LRSchedulerCallback``'s LR
  sequence (by step and by epoch), exactly;
* ``utils.checkpoint.save`` writes the JAX package's ``.npz`` for one
  state dict (the same ``arr_i`` in the same order, bit for bit, as does
  ``Model.save``'s ``.pdparams``); ``save`` / ``load`` round-trips the
  parameters and the optimizer state bit for bit; a manifest directory
  (the JAX package's elastic checkpoint) loads, a torn one raises;
* ``fit`` refuses the watchdog flags it cannot honour yet and writes the
  periodic elastic checkpoints of the elastic flags; ``_LazyLogs`` reads
  lazily.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpd
import paddle_tpu.hapi as jhapi
import paddle_tpu.nn as jnn
import paddle_tpu.vision as JV
from paddle_tpu.autograd import parameters_dict
from paddle_tpu.text import ernie as jernie
from paddle_tpu.text.datasets import Imdb as JImdb
from paddle_tpu.utils import checkpoint as jcheckpoint
import paddle_tpu_torch as P
import paddle_tpu_torch.hapi as thapi
import paddle_tpu_torch.vision as TV
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.hapi.model import _LazyLogs
from paddle_tpu_torch.text import ernie as ternie
from paddle_tpu_torch.text.datasets import Imdb
from paddle_tpu_torch.utils import checkpoint as tcheckpoint

TOL = 1e-4
TOL_PREDICT = 1e-5
FLOOR = 1e-2


@pytest.fixture(autouse=True)
def _cpu():
    with P.device_guard("cpu"):
        yield


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _JRecorder(jhapi.callbacks.Callback):
    def __init__(self):
        super().__init__()
        self.losses, self.lrs, self.epochs = [], [], []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])
        lr = self.model._optimizer._lr
        self.lrs.append(lr.get_lr() if hasattr(lr, "get_lr") else lr)

    def on_epoch_end(self, epoch, logs=None):
        self.epochs.append(epoch)


class _TRecorder(thapi.callbacks.Callback):
    on_train_batch_end = _JRecorder.on_train_batch_end
    on_epoch_end = _JRecorder.on_epoch_end

    def __init__(self):
        super().__init__()
        self.losses, self.lrs, self.epochs = [], [], []


def _carry(jnet, tnet):
    convert.from_jax_params({k: np.asarray(v) for k, v in
                             parameters_dict(jnet).items()}, tnet)


def _params_close(tnet, jnet, noise_step=None):
    """Every parameter within TOL of its largest value (floored).  With
    ``noise_step`` (Adam's largest step times the steps taken) the
    attention's key-projection biases are held within it of 0 in both
    packages instead: their gradient is 0 in exact arithmetic (softmax is
    shift-invariant along the keys), so each package's is rounding noise,
    which Adam turns into steps of about the LR in either direction."""
    ref = {k: np.asarray(v) for k, v in parameters_dict(jnet).items()}
    got = {k: _np(v) for k, v in tnet.named_parameters()}
    assert set(got) == set(ref)
    top = max(float(np.abs(v).max()) for v in ref.values())
    for k, r in ref.items():
        if noise_step is not None and k.endswith("k_proj.bias"):
            assert max(np.abs(got[k]).max(), np.abs(r).max()) <= noise_step
            continue
        err = float(np.abs(got[k] - r).max())
        assert err <= TOL * max(float(np.abs(r).max()), FLOOR * top), (k, err)


# -- LeNet on synthetic MNIST ------------------------------------------------

def _lenet_models():
    jnet = JV.models.LeNet()
    tnet = TV.models.LeNet(generator=torch.Generator().manual_seed(0))
    _carry(jnet, tnet)
    jm, tm = jhapi.Model(jnet), thapi.Model(tnet)
    jm.prepare(jpd.optimizer.Adam(learning_rate=1e-3), jnn.CrossEntropyLoss(),
               [jpd.metric.Accuracy()])
    tm.prepare(P.optimizer.Adam(learning_rate=1e-3), tnn.CrossEntropyLoss(),
               [P.metric.Accuracy()])
    return jm, tm


def test_lenet_fit_evaluate_predict_match_the_reference():
    jm, tm = _lenet_models()
    jtrain = JV.datasets.MNIST(mode="train", synthetic_size=48)
    ttrain = TV.datasets.MNIST(mode="train", synthetic_size=48)
    jrec, trec = _JRecorder(), _TRecorder()
    jm.fit(jtrain, batch_size=16, epochs=1, shuffle=False, verbose=0,
           callbacks=[jrec])
    tm.fit(ttrain, batch_size=16, epochs=1, shuffle=False, verbose=0,
           callbacks=[trec])
    assert len(trec.losses) == len(jrec.losses) == 3
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=TOL)
    _params_close(tm.network, jm.network)
    jtest = JV.datasets.MNIST(mode="test", synthetic_size=64)
    ttest = TV.datasets.MNIST(mode="test", synthetic_size=64)
    jl, tl = jm.evaluate(jtest, batch_size=8), tm.evaluate(ttest,
                                                           batch_size=8)
    assert set(tl) == set(jl) == {"loss", "acc"}
    np.testing.assert_allclose(tl["loss"], jl["loss"], rtol=TOL_PREDICT)
    assert tl["acc"] == jl["acc"]
    jp, tp = jm.predict(jtest, batch_size=8), tm.predict(ttest, batch_size=8)
    assert len(tp) == len(jp) == 1 and tp[0].shape == (16, 10)
    np.testing.assert_allclose(tp[0], jp[0], rtol=TOL_PREDICT,
                               atol=TOL_PREDICT * np.abs(jp[0]).max())
    unstacked = tm.predict(ttest, batch_size=8, stack_outputs=False)
    assert len(unstacked) == 2 and unstacked[0][0].shape == (8, 10)
    x, y = ttest[0]
    np.testing.assert_allclose(tm.predict_batch([x[None]]),
                               tp[0][:1], rtol=TOL_PREDICT, atol=1e-6)
    assert np.isfinite(tm.eval_batch([x[None]], np.array([y])))
    assert np.isfinite(tm.train_batch([x[None]], np.array([y])))


# -- the ERNIE sentence classifier on synthetic IMDB --------------------------

ERNIE = dict(vocab_size=5000, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=128,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


class _JClassifier(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.model = jernie.ErnieForSequenceClassification(
            jernie.ErnieConfig(**ERNIE), num_classes=2)

    def forward(self, ids):
        return self.model(ids, jnp.zeros_like(ids), attention_mask=ids != 0)


class _TClassifier(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.model = ternie.ErnieForSequenceClassification(
            ternie.ErnieConfig(**ERNIE), num_classes=2, device="cpu",
            generator=torch.Generator().manual_seed(1))

    def forward(self, ids):
        return self.model(ids, torch.zeros_like(ids), attention_mask=ids != 0)


def _recipe(O, sched):
    return O.AdamW(sched, weight_decay=0.01,
                   grad_clip=O.ClipGradByGlobalNorm(1.0))


def test_ernie_classifier_fit_matches_the_reference():
    jnet, tnet = _JClassifier(), _TClassifier()
    _carry(jnet, tnet)
    jm, tm = jhapi.Model(jnet), thapi.Model(tnet)
    jsched = jpd.optimizer.lr.LinearWarmup(1e-3, 2, 0.0, 1e-3)
    tsched = P.optimizer.lr.LinearWarmup(1e-3, 2, 0.0, 1e-3)
    jm.prepare(_recipe(jpd.optimizer, jsched), jnn.CrossEntropyLoss(),
               [jpd.metric.Accuracy()])
    tm.prepare(_recipe(P.optimizer, tsched), tnn.CrossEntropyLoss(),
               [P.metric.Accuracy()])
    kw = dict(mode="train", synthetic_size=24, maxlen=32)
    jrec, trec = _JRecorder(), _TRecorder()
    jm.fit(JImdb(**kw), batch_size=8, shuffle=False, verbose=0,
           callbacks=[jrec])
    tm.fit(Imdb(**kw), batch_size=8, shuffle=False, verbose=0,
           callbacks=[trec, thapi.callbacks.MetricsLogger()])
    assert len(trec.losses) == 3
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=TOL)
    _params_close(tnet, jnet, noise_step=3 * 1e-3)
    test = dict(mode="test", synthetic_size=16, maxlen=32)
    jl, tl = jm.evaluate(JImdb(**test), batch_size=8), tm.evaluate(
        Imdb(**test), batch_size=8)
    np.testing.assert_allclose(tl["loss"], jl["loss"], rtol=TOL_PREDICT)
    assert tl["acc"] == jl["acc"]
    jp, tp = jm.predict(JImdb(**test), batch_size=8), tm.predict(
        Imdb(**test), batch_size=8)
    np.testing.assert_allclose(tp[0], jp[0], rtol=TOL_PREDICT,
                               atol=TOL_PREDICT * np.abs(jp[0]).max())


# -- callbacks ---------------------------------------------------------------

def test_early_stopping_stops_at_the_reference_epoch():
    stops = []
    jm, tm = _lenet_models()
    for model, hapi, rec, ds in ((jm, jhapi, _JRecorder, JV.datasets),
                                 (tm, thapi, _TRecorder, TV.datasets)):
        r = rec()
        es = hapi.callbacks.EarlyStopping(monitor="loss", mode="max",
                                          patience=1, verbose=0)
        model.fit(ds.MNIST(mode="train", synthetic_size=32), batch_size=16,
                  epochs=6, shuffle=False, verbose=0, callbacks=[es, r])
        stops.append((r.epochs, model.stop_training, es.wait, es.best))
    assert stops[0][:3] == stops[1][:3] and stops[1][1]
    np.testing.assert_allclose(stops[1][3], stops[0][3], rtol=TOL)


@pytest.mark.parametrize("by_step,by_epoch", [(True, False), (False, True),
                                              (True, True)])
def test_lr_scheduler_callback_steps_as_in_the_reference(by_step, by_epoch):
    lrs = []
    jm, tm = _lenet_models()
    for model, pkg, hapi, rec, ds in (
            (jm, jpd, jhapi, _JRecorder, JV.datasets),
            (tm, P, thapi, _TRecorder, TV.datasets)):
        sched = pkg.optimizer.lr.StepDecay(0.01, step_size=2, gamma=0.5)
        model._optimizer.set_lr(sched)
        r = rec()
        model.fit(ds.MNIST(mode="train", synthetic_size=48), batch_size=16,
                  epochs=2, shuffle=False, verbose=0,
                  callbacks=[hapi.callbacks.LRSchedulerCallback(
                      by_step=by_step, by_epoch=by_epoch), r])
        lrs.append([float(x) for x in r.lrs] + [float(sched.get_lr())])
    assert lrs[1] == lrs[0] and len(lrs[0]) == 7


def test_lazy_logs_read_on_demand():
    calls = []
    logs = _LazyLogs(step=3)
    logs.set_lazy("loss", lambda: calls.append(1) or 0.5)
    assert "loss" in logs and len(logs) == 2 and not calls
    assert logs["loss"] == 0.5 and logs.get("loss") == 0.5 and calls == [1]
    assert logs.copy() == {"step": 3, "loss": 0.5}


def test_fit_refuses_the_flags_it_cannot_honour(tmp_path):
    """The watchdog flag still raises (item 10); the elastic flags are
    honoured since the port of elastic/ (a checkpoint every 2 steps)."""
    from paddle_tpu_torch.elastic import checkpoint as teckpt

    _, tm = _lenet_models()
    ds = TV.datasets.MNIST(mode="train", synthetic_size=16)
    flags = {"watchdog": True}
    saved = tflags.get_flags(list(flags))
    tflags.set_flags(flags)
    try:
        with pytest.raises(NotImplementedError, match="item 10"):
            tm.fit(ds, batch_size=16, verbose=0)
    finally:
        tflags.set_flags(saved)
    flags = {"elastic_save_every": 2, "elastic_ckpt_dir": str(tmp_path)}
    saved = tflags.get_flags(list(flags))
    tflags.set_flags(flags)
    try:
        tm.fit(TV.datasets.MNIST(mode="train", synthetic_size=64),
               batch_size=16, verbose=0)
    finally:
        tflags.set_flags(saved)
    assert teckpt.list_steps(str(tmp_path)) == [2, 4]


# -- checkpoints -------------------------------------------------------------

def _npz(path):
    with np.load(path + ".npz") as data:
        return {k: data[k] for k in data.files}


def test_checkpoint_npz_is_the_reference_file(tmp_path):
    jm, tm = _lenet_models()
    state = {"model": dict(tm.network.state_dict()), "step": 7,
             "extra": (np.arange(3, dtype=np.int32), None, [2.5])}
    jstate = {"model": {k: np.asarray(v) for k, v in
                        jm.network.state_dict().items()}, "step": 7,
              "extra": (np.arange(3, dtype=np.int32), None, [2.5])}
    tcheckpoint.save(state, str(tmp_path / "t"))
    jcheckpoint.save(jstate, str(tmp_path / "j"))
    got, ref = _npz(str(tmp_path / "t")), _npz(str(tmp_path / "j"))
    assert list(got) == list(ref) and len(got) == 10 + 1 + 2
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k],
                                                               ref[k]), k
    back = tcheckpoint.load(str(tmp_path / "t"))
    assert list(back["model"]) == sorted(state["model"])
    assert back["extra"][1] is None and isinstance(back["extra"], tuple)
    assert int(back["step"]) == 7
    tm.save(str(tmp_path / "tm"))
    jm.save(str(tmp_path / "jm"))
    got, ref = _npz(str(tmp_path / "tm.pdparams")), _npz(
        str(tmp_path / "jm.pdparams"))
    assert list(got) == list(ref)
    assert all(np.array_equal(got[k], ref[k]) for k in ref)
    from paddle_tpu.elastic import checkpoint as jeckpt
    from paddle_tpu_torch.elastic.checkpoint import CheckpointError

    flat = {k: np.asarray(v) for k, v in jm.network.state_dict().items()}
    jeckpt.write_state(str(tmp_path / "elastic"), flat, step=3)
    back = tcheckpoint.load(str(tmp_path / "elastic"))
    assert sorted(back) == sorted(flat)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
    (tmp_path / "torn").mkdir()
    (tmp_path / "torn" / "manifest.json").write_text("{}")
    with pytest.raises(CheckpointError, match="unreadable"):
        tcheckpoint.load(str(tmp_path / "torn"))


def test_save_load_round_trips_parameters_and_optimizer_state(tmp_path):
    _, tm = _lenet_models()
    ds = TV.datasets.MNIST(mode="train", synthetic_size=32)
    tm.fit(ds, batch_size=16, verbose=0)
    path = str(tmp_path / "ckpt")
    tm.save(path)
    assert os.path.exists(path + ".pdopt.npz")
    _, fresh = _lenet_models()
    fresh.load(path)
    for (k, a), b in zip(tm.network.state_dict().items(),
                         fresh.network.state_dict().values()):
        assert torch.equal(a, b), k
    s0, s1 = tm._optimizer._state, fresh._optimizer._state
    assert s1["step"] == s0["step"] == 2
    assert fresh._optimizer._step_count == 2
    for k, slots in s0["per_param"].items():
        assert all(torch.equal(a, b) for a, b in zip(slots,
                                                     s1["per_param"][k]))
    # in place into a state that exists, and the next step agrees
    before = [id(t) for slots in s1["per_param"].values() for t in slots]
    fresh.load(path)
    assert before == [id(t) for slots in fresh._optimizer._state[
        "per_param"].values() for t in slots]
    x = np.stack([ds[i][0] for i in range(4)])
    y = np.array([ds[i][1] for i in range(4)])
    assert tm.train_batch([x], y) == fresh.train_batch([x], y)
    fresh.load(path, reset_optimizer=True)
