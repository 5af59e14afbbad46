"""The port's data pipeline (``paddle_tpu_torch.io``) against the JAX
package's, on the CPU, exactly:

* the samplers' index streams (``SequenceSampler``, ``RandomSampler`` with
  and without replacement under one ``np.random.seed``, ``BatchSampler``)
  and ``DistributedBatchSampler``'s shards and epochs;
* ``default_collate_fn`` on nested samples, dtypes included (Python and
  numpy integers to int32, floats to float32);
* ``DataLoader`` batch streams in process, on worker threads and on two
  spawned worker processes through shared memory (shuffled under one
  seed, ``drop_last``), and ``IterableDataset`` batching;
* errors as in the JAX package: a worker thread's exception re-raised, a
  spawned worker's as ``RuntimeError``, ``prefetch_factor`` < 1 refused;
  a killed spawned worker surfaces within ``timeout``;
* ``DeviceFeeder`` / ``device_prefetch`` / ``stage`` / ``resolve_device``
  on the CPU (tensors of the host batches' values and dtypes, errors,
  early exit, the telemetry names);
* the collate's int32 labels and ids reach ``cross_entropy`` and
  ``embedding``, which cast at the op.

Spawned workers unpickle only port classes (``TensorDataset``, the
collate), so they import torch and the port, not this file.  Every
multiprocess loader passes a ``timeout``.
"""
import operator
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as P
import paddle_tpu_torch.io as tio
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.io import prefetch
from paddle_tpu_torch.utils import monitor, trace

SPAWN_TIMEOUT = 60


@pytest.fixture(autouse=True)
def _cpu():
    with P.device_guard("cpu"):
        yield


def _equal(a, b, where=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
        return
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
        return
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype,
                                                       b.dtype)
    assert np.array_equal(a, b), where


def _arrays(n=23):
    rng = np.random.default_rng(5)
    return [rng.normal(size=(n, 3)).astype(np.float32),
            np.arange(n, dtype=np.int64), rng.integers(0, 9, n)]


# -- samplers --------------------------------------------------------------

@pytest.mark.parametrize("replacement,num_samples", [(False, None),
                                                     (True, 30),
                                                     (False, 10)])
def test_random_sampler_draws_the_reference_indices(replacement,
                                                    num_samples):
    src = list(range(17))
    np.random.seed(3)
    ref = list(jio.RandomSampler(src, replacement, num_samples))
    np.random.seed(3)
    got = list(tio.RandomSampler(src, replacement, num_samples))
    assert got == ref and len(tio.RandomSampler(src, replacement,
                                                num_samples)) == len(ref)


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (False, True), (True, True)])
def test_batch_sampler_streams(shuffle, drop_last):
    src = list(range(23))
    np.random.seed(8)
    ref = list(jio.BatchSampler(src, shuffle=shuffle, batch_size=5,
                                drop_last=drop_last))
    np.random.seed(8)
    s = tio.BatchSampler(src, shuffle=shuffle, batch_size=5,
                         drop_last=drop_last)
    assert list(s) == ref and len(s) == len(ref)
    assert list(tio.SequenceSampler(src)) == list(jio.SequenceSampler(src))


@pytest.mark.parametrize("nranks,shuffle,drop_last", [
    (4, False, False), (3, True, False), (3, True, True), (2, False, True)])
def test_distributed_batch_sampler_shards(nranks, shuffle, drop_last):
    src = list(range(22))
    for rank in range(nranks):
        ref = jio.DistributedBatchSampler(src, 4, nranks, rank, shuffle,
                                          drop_last)
        got = tio.DistributedBatchSampler(src, 4, nranks, rank, shuffle,
                                          drop_last)
        for epoch in range(2):
            assert list(got) == list(ref), (rank, epoch)
            assert len(got) == len(ref)
        got.set_epoch(7)
        ref.set_epoch(7)
        assert list(got) == list(ref)


def test_distributed_sampler_defaults_to_the_launcher_env(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "3")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    s = tio.DistributedBatchSampler(list(range(10)), 2)
    assert (s.nranks, s.local_rank) == (3, 2)
    # padded to 12 with the first indices, then every third from rank 2
    assert [i for b in s for i in b] == [2, 5, 8, 1]


# -- collate and DataLoader --------------------------------------------------

def test_default_collate_matches_the_reference():
    samples = [({"a": np.int64(i), "b": [np.float32(i / 3), i]},
                np.full((2, 2), i, np.int16), float(i), True)
               for i in range(4)]
    got = tio.default_collate_fn(samples)
    _equal(got, jio.default_collate_fn(samples))
    assert got[0]["a"].dtype == np.int32 and got[2].dtype == np.float32


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("num_workers", [0, 3])
def test_dataloader_batches_equal_the_reference(num_workers, shuffle):
    arrays = _arrays()
    np.random.seed(21)
    ref = list(jio.DataLoader(jio.TensorDataset(arrays), batch_size=4,
                              shuffle=shuffle, drop_last=shuffle))
    np.random.seed(21)
    dl = tio.DataLoader(tio.TensorDataset(arrays), batch_size=4,
                        shuffle=shuffle, drop_last=shuffle,
                        num_workers=num_workers, prefetch_factor=1)
    assert len(dl) == len(ref)
    _equal(list(dl), ref)


def test_dataloader_on_two_spawned_workers_equals_the_reference():
    arrays = _arrays(41)
    np.random.seed(2)
    ref = list(jio.DataLoader(jio.TensorDataset(arrays), batch_size=4,
                              shuffle=True))
    np.random.seed(2)
    got = list(tio.DataLoader(tio.TensorDataset(arrays), batch_size=4,
                              shuffle=True, num_workers=2,
                              use_shared_memory=True, prefetch_factor=2,
                              timeout=SPAWN_TIMEOUT))
    _equal(got, ref)


def test_spawned_workers_start_side_by_side():
    """Each start returns only when both have begun (a barrier), so starts
    made one after another would break it; a failed start is raised and
    the started workers are stopped."""
    from paddle_tpu_torch.io import dataloader

    barrier = threading.Barrier(2, timeout=10)

    class Worker:
        pid = None
        stopped = False

        def start(self):
            barrier.wait()
            self.pid = 1

        def terminate(self):
            self.stopped = True

    workers = [Worker(), Worker()]
    dataloader._start_all(workers)
    assert [w.pid for w in workers] == [1, 1]

    class Failing(Worker):
        def start(self):
            raise OSError("no process")

    workers = [Worker(), Failing()]
    barrier = threading.Barrier(1)
    with pytest.raises(OSError, match="no process"):
        dataloader._start_all(workers)
    assert workers[0].stopped and not workers[1].stopped


def test_spawned_worker_errors_surface():
    ds = tio.TensorDataset([np.arange(10)])
    with pytest.raises(RuntimeError, match="worker failed on batch .*"
                       "IndexError"):
        list(tio.DataLoader(ds, batch_size=2, num_workers=2,
                            use_shared_memory=True, timeout=SPAWN_TIMEOUT,
                            collate_fn=operator.itemgetter(2)))
    # a worker that dies (SystemExit skips the worker's error report)
    with pytest.raises(RuntimeError, match="died without producing"):
        list(tio.DataLoader(ds, batch_size=2, num_workers=2,
                            use_shared_memory=True, timeout=2,
                            collate_fn=sys.exit))


class _Bad(tio.Dataset):
    def __getitem__(self, i):
        if i == 7:
            raise ValueError("boom")
        return np.float32(i)

    def __len__(self):
        return 10


class _Stream(tio.IterableDataset):
    def __iter__(self):
        for i in range(7):
            yield np.float32(i), i


class _JStream(jio.IterableDataset):
    def __iter__(self):
        for i in range(7):
            yield np.float32(i), i


def test_thread_worker_error_iterable_and_argument_checks():
    with pytest.raises(ValueError, match="boom"):
        list(tio.DataLoader(_Bad(), batch_size=2, num_workers=2))
    with pytest.raises(ValueError, match="prefetch_factor"):
        tio.DataLoader(_Bad(), prefetch_factor=0)
    for drop_last in (False, True):
        _equal(list(tio.DataLoader(_Stream(), batch_size=3,
                                   drop_last=drop_last)),
               list(jio.DataLoader(_JStream(), batch_size=3,
                                   drop_last=drop_last)))
    with pytest.raises(TypeError):
        len(tio.DataLoader(_Stream(), batch_size=3))
    assert tio.DataLoader(_Bad()).timeout == 60


def test_exports_are_the_reference_exports():
    names = {n for n in dir(jio) if not n.startswith("_")
             and not isinstance(getattr(jio, n), type(jio))}
    assert names <= set(dir(tio)), names - set(dir(tio))


# -- device prefetch --------------------------------------------------------

def test_device_feeder_stages_the_host_batches():
    dl = tio.DataLoader(tio.TensorDataset(_arrays()), batch_size=5)
    host = list(dl)
    start = monitor.counter("io.prefetch_batches").value()
    seq = trace.flight_recorder().last_seq
    feeder = tio.DeviceFeeder(dl, device="cpu", depth=2)
    staged = list(feeder)
    assert all(isinstance(t, torch.Tensor) for b in staged for t in b)
    _equal(staged, host)
    assert monitor.counter("io.prefetch_batches").value() - start == len(host)
    assert monitor.gauge("io.prefetch_depth").value() == 0
    names = {e["name"] for e in trace.flight_recorder().events_since(seq)}
    assert {"io::prefetch_feeder", "io::prefetch_put"} <= names
    assert feeder._thread is None
    # the loader's own prefetch and the functional form
    _equal(list(tio.DataLoader(tio.TensorDataset(_arrays()), batch_size=5,
                               prefetch_to_device="cpu")), host)
    _equal(list(tio.device_prefetch(host, "cpu", 1)), host)


def test_device_feeder_errors_and_early_exit():
    def source():
        yield {"x": np.ones(3, np.float32)}
        raise KeyError("late")

    it = tio.device_prefetch(source(), "cpu")
    assert torch.equal(next(it)["x"], torch.ones(3))
    with pytest.raises(KeyError, match="late"):
        next(it)
    with pytest.raises(ValueError):
        tio.DeviceFeeder([], "cpu", depth=0)
    feeder = tio.DeviceFeeder(({"i": np.int32(i)} for i in range(100)),
                              "cpu", depth=1)
    for b in feeder:
        assert b["i"].dtype == torch.int32
        break
    feeder.close()
    assert feeder._thread is None


def test_stage_and_resolve_device(monkeypatch):
    batch = {"ids": np.arange(6, dtype=np.int32).reshape(2, 3),
             "n": [np.float32(2.0), "tag"]}
    out = prefetch.stage(batch, "cpu")
    assert out["ids"].dtype == torch.int32 and out["n"][1] == "tag"
    per_leaf = prefetch.stage(batch, {"ids": "cpu"})
    assert per_leaf["ids"].device.type == "cpu"
    with pytest.raises(TypeError):
        prefetch.stage([np.ones(2)], {"ids": "cpu"})
    assert prefetch.resolve_device(None) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, want in (("gpu:1", "cuda:1"), ("cuda", "cuda:0"),
                       ("tpu", "cuda:0"), ("cpu", "cpu")):
        assert prefetch.resolve_device(name) == torch.device(want), name
    assert prefetch.resolve_device({"a": "gpu"}) == {
        "a": torch.device("cuda", 0)}


# -- int32 from the collate at ops that want int64 ----------------------------

def test_int32_labels_and_ids_reach_the_int64_ops():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(6, 5)).astype(np.float32)
    batch = tio.default_collate_fn([(np.int64(i % 5),) for i in range(6)])
    label = batch[0]
    assert label.dtype == np.int32
    t32 = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(label))
    t64 = TF.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(label.astype(np.int64)))
    ref = JF.cross_entropy(jnp.asarray(logits), jnp.asarray(label))
    assert torch.equal(t32, t64)
    np.testing.assert_allclose(t32.numpy(), np.asarray(ref), rtol=1e-6)
    loss = tnn.CrossEntropyLoss()(torch.from_numpy(logits),
                                  torch.from_numpy(label))
    assert torch.equal(loss, t32)
    w = torch.from_numpy(rng.normal(size=(9, 4)).astype(np.float32))
    ids = torch.from_numpy(np.array([[1, 0, 8]], np.int32))
    assert torch.equal(TF.embedding(ids, w, padding_idx=0),
                       TF.embedding(ids.long(), w, padding_idx=0))


def test_spawned_workers_exit_when_their_parent_is_killed(tmp_path):
    """A parent killed mid-epoch cannot terminate its workers; each idle
    worker sees its parent gone within its poll interval and exits."""
    import os
    import subprocess
    import time
    from pathlib import Path

    code = (
        "import multiprocessing as mp, os, sys\n"
        "import numpy as np\n"
        "from paddle_tpu_torch.io import DataLoader, TensorDataset\n"
        "if __name__ == '__main__':\n"
        "    it = iter(DataLoader(TensorDataset([np.arange(400)]),\n"
        "                         batch_size=2, num_workers=2,\n"
        "                         use_shared_memory=True, timeout=60))\n"
        "    next(it)\n"
        "    print(*[p.pid for p in mp.active_children()], flush=True)\n"
        "    os._exit(0)\n")
    script = tmp_path / "parent.py"
    script.write_text(code)
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(script)], timeout=120,
                         capture_output=True, text=True, cwd=str(tmp_path),
                         env=dict(os.environ, PYTHONPATH=str(root)))
    pids = [int(p) for p in out.stdout.split()]
    assert len(pids) >= 2, out.stderr

    def alive(pid):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        return True

    deadline = time.time() + 4 * 5.0 + 10
    while any(alive(p) for p in pids) and time.time() < deadline:
        time.sleep(0.5)
    assert not any(alive(p) for p in pids)
