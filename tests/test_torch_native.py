"""The port's host runtime against the JAX package's, on the CPU.

* ``core.native``: the library builds at first use from ``native/src``
  into ``build/paddle_tpu_torch/native/`` under a name keyed on the
  sources, and writes nothing under ``native/``; stats and the host
  profiler through it.
* The multi-slot feed: the port's ``NativeDataFeed`` against the JAX
  package's (the same C++ sources, each package's build), batches equal
  bit for bit with and without ``local_shuffle``; ``_PySlotFeed`` against
  ``_PySlotFeed`` the same (the two generators differ, so a shuffled order
  is compared only within one feed kind); ``InMemoryDataset`` /
  ``QueueDataset`` / ``DatasetFactory`` as in the JAX package.
* ``Executor.train_from_dataset``: the book's ``fit_a_line`` (fc 13 -> 1,
  ``square_error_cost``, mean, SGD) on ``UCIHousing`` rows written to a
  multi-slot file and read through ``InMemoryDataset``: the port's last
  loss and parameters within 1e-5 of the JAX package's from the same
  startup state, and equal bit for bit to ``Executor.run`` over the same
  batches (with ``prefetch_to_device`` too).
* The flag table: every name, default and type of the JAX package's, and
  ``_coerce``'s bool spellings.
* ``utils.profiler`` and ``utils.trace``: events, the chrome export with
  counters and the rank, spans in the flight recorder, traceparent
  propagation.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu.static as jstatic
from paddle_tpu.core import flags as jflags
from paddle_tpu.core import native as jnative
from paddle_tpu.io import multislot as jmultislot
from paddle_tpu.static import layers as JL
from paddle_tpu.text import UCIHousing as JUCIHousing
import paddle_tpu_torch.static as tstatic
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import native as tnative
from paddle_tpu_torch.io import multislot as tmultislot
from paddle_tpu_torch.static import layers as TL
from paddle_tpu_torch.text import UCIHousing
from paddle_tpu_torch.utils import monitor, profiler, trace

ROOT = Path(__file__).resolve().parents[1]
SLOTS = [("x", "float32", 4), ("label", "int64", 2), ("w", "float32", 1)]
TOL = 1e-5


def _write_rows(path, rng, n, short=False):
    with open(path, "w") as f:
        for i in range(n):
            x = rng.normal(size=4).round(4)
            lab = rng.integers(0, 100, 2)
            if short and i % 3 == 0:      # a short row: padded with 0
                x, lab = x[:2], lab[:1]
            f.write(",".join(map(str, x)) + ";" + ",".join(map(str, lab))
                    + f";{i * 0.5}\n")
    return str(path)


@pytest.fixture
def files(tmp_path):
    rng = np.random.default_rng(3)
    return [_write_rows(tmp_path / f"part{i}.txt", rng, 23 + 4 * i,
                        short=i == 1) for i in range(3)]


def _same(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


def test_native_library_builds_at_first_use_outside_native(tmp_path,
                                                            monkeypatch):
    def snapshot():
        return sorted((str(p.relative_to(ROOT)), p.stat().st_mtime_ns)
                      for p in (ROOT / "native").rglob("*")
                      if p.is_file() and "build" not in p.parts)

    before = snapshot()
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    path = tnative.library_path()
    assert path.parent == tmp_path / "native" and not path.exists()
    assert tnative.build() > 0.0 and path.exists()
    assert tnative.build() == 0.0
    assert snapshot() == before
    monkeypatch.undo()
    assert tnative.available(), tnative.build_error()
    assert tnative.library_path().relative_to(ROOT).parts[:3] == (
        "build", "paddle_tpu_torch", "native")
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_stats_and_host_profiler(tmp_path):
    tnative.stat_reset("port.test")
    tnative.stat_add("port.test", 5)
    tnative.stat_add("port.test")
    assert tnative.stat_get("port.test") == 6
    assert tnative.stat_list()["port.test"] == 6
    tnative.prof_clear()
    tnative.prof_enable()
    with profiler.RecordEvent("outer"):
        with profiler.RecordEvent("inner"):
            pass
    tnative.prof_disable()
    assert "outer" in profiler.summary("calls")
    with pytest.raises(ValueError):
        profiler.summary("bad")
    reg = monitor.MetricRegistry()
    reg.counter("port.events", "", ("kind",)).inc(3, kind="a")
    path = str(tmp_path / "trace.json")
    n = profiler.export_chrome_tracing(path, registry=reg)
    events = json.load(open(path))["traceEvents"]
    assert n == len(events) == 5
    assert {e["name"] for e in events} >= {"outer", "inner",
                                            "port.events{kind=a}"}
    assert all(e["pid"] == 0 for e in events)
    tnative.prof_clear()


@pytest.mark.parametrize("shuffle", [None, 7])
def test_native_feed_batches_equal_the_reference(files, shuffle):
    def run(mod):
        feed = mod.NativeDataFeed(SLOTS, batch_size=8, num_threads=2)
        feed.set_filelist(files)
        assert feed.load_into_memory() == 23 + 27 + 31
        if shuffle is not None:
            feed.local_shuffle(shuffle)
        return list(feed)

    _same(run(tnative), run(jnative))


@pytest.mark.parametrize("shuffle", [None, 7])
def test_python_feed_batches_equal_the_reference(files, shuffle):
    def run(mod):
        feed = mod._PySlotFeed(SLOTS, batch_size=8)
        feed.set_filelist(files)
        feed.load_into_memory()
        if shuffle is not None:
            feed.local_shuffle(shuffle)
        return list(feed)

    _same(run(tmultislot), run(jmultislot))
    # unshuffled, the Python feed reads what the native feed reads
    if shuffle is None:
        native = tnative.NativeDataFeed(SLOTS, batch_size=8)
        native.set_filelist(files)
        native.load_into_memory()
        _same(run(tmultislot), list(native))


def test_datasets_run_on_the_native_feed_as_in_the_reference(files):
    def run(mod):
        ds = mod.DatasetFactory().create_dataset("InMemoryDataset")
        ds.set_use_var(SLOTS)
        ds.set_batch_size(10)
        ds.set_thread(2)
        ds.set_filelist(files)
        ds.load_into_memory()
        ds.global_shuffle(seed=4)
        assert ds.get_memory_data_size() == 81
        with pytest.raises(RuntimeError):
            ds.set_batch_size(3)
        q = mod.QueueDataset()
        q.set_use_var(SLOTS)
        q.set_batch_size(16)
        q.set_filelist(files)
        with pytest.raises(RuntimeError):
            q.local_shuffle()
        return list(ds), list(q), list(q)

    ours, ref = run(tmultislot), run(jmultislot)
    for a, b in zip(ours, ref):
        _same(a, b)
    ds = tmultislot.InMemoryDataset()
    ds.set_use_var(SLOTS)
    assert isinstance(ds._ensure_feed(), tnative.NativeDataFeed)


# -- train_from_dataset: fit_a_line ------------------------------------------

def _fit_a_line(static, L):
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = 9
    with static.program_guard(main, startup):
        x = L.data("x", [13])
        y = L.data("y", [1])
        pred = L.fc(x, 1)
        loss = L.mean(L.square_error_cost(pred, y))
        static.optimizer.SGD(0.01).minimize(loss)
    return main, startup, loss


def _housing_file(tmp_path, ds):
    path = tmp_path / "housing.txt"
    with open(path, "w") as f:
        for i in range(len(ds)):
            x, y = ds[i]
            f.write(",".join(repr(float(v)) for v in x) + ";"
                    + repr(float(y[0])) + "\n")
    return str(path)


def _dataset(mod, path):
    ds = mod.InMemoryDataset()
    ds.set_use_var([("x", "float32", 13), ("y", "float32", 1)])
    ds.set_batch_size(32)
    ds.set_filelist([path])
    ds.load_into_memory()
    return ds


def test_train_from_dataset_fit_a_line_matches_the_reference(tmp_path):
    housing = UCIHousing(mode="train")
    assert np.array_equal(housing.features, JUCIHousing(mode="train").features)
    path = _housing_file(tmp_path, housing)

    jmain, jstart, jloss = _fit_a_line(jstatic, JL)
    jscope = jstatic.Scope()
    jexe = jstatic.Executor()
    jexe.run(jstart, scope=jscope)
    init = {k: np.asarray(jscope.find_var(k)) for k in jscope.keys()}
    jlast = jexe.train_from_dataset(jmain, _dataset(jmultislot, path),
                                    scope=jscope, fetch_list=[jloss])

    tmain, _, tloss = _fit_a_line(tstatic, TL)
    texe = tstatic.Executor("cpu")
    runs = {}
    for how in ("dataset", "prefetch", "run"):
        scope = convert.static_state_from_jax(jmain, init, tmain, "cpu")
        ds = _dataset(tmultislot, path)
        if how == "run":
            for batch in ds:
                last = texe.run(tmain, feed=batch, fetch_list=[tloss],
                                scope=scope)
        else:
            last = texe.train_from_dataset(
                tmain, ds, scope=scope, fetch_list=[tloss],
                prefetch_to_device=how == "prefetch")
        runs[how] = (last, [scope.find_var(v.name).numpy()
                            for v in tmain.list_vars() if v.persistable])
    for how in ("dataset", "prefetch"):
        assert np.array_equal(runs[how][0][0], runs["run"][0][0])
        assert all(np.array_equal(a, b)
                   for a, b in zip(runs[how][1], runs["run"][1]))
    np.testing.assert_allclose(runs["dataset"][0][0], jlast[0], rtol=TOL)
    jparams = [np.asarray(jscope.find_var(v.name))
               for v in jmain.list_vars() if v.persistable]
    for got, ref in zip(runs["dataset"][1], jparams):
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError):
        texe.train_from_dataset(tmain, None)


# -- flags -------------------------------------------------------------------

def test_flag_table_is_the_reference_table():
    assert list(tflags._DEFS) == list(jflags._DEFS)
    for name, (default, type_, help_) in jflags._DEFS.items():
        tdefault, ttype, thelp = tflags._DEFS[name]
        assert (tdefault, ttype) == (default, type_), name
        assert type(tdefault) is type(default) and thelp, name


@pytest.mark.parametrize("text", ["1", "true", "Yes", "ON", "0", "False",
                                  "no", "off", "", "maybe"])
def test_bool_spellings_coerce_as_in_the_reference(text):
    try:
        ref = jflags._coerce("f", text, bool)
    except ValueError:
        with pytest.raises(ValueError):
            tflags._coerce("f", text, bool)
        return
    assert tflags._coerce("f", text, bool) is ref


def test_flag_env_passthrough():
    code = ("from paddle_tpu_torch.core import flags\n"
            "print(flags.get_flag('watchdog'), flags.get_flag("
            "'flight_recorder_size'), flags.get_flag('ledger_dir'))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), PDTPU_FLAGS_watchdog="yes",
               PDTPU_FLAGS_flight_recorder_size="64",
               PDTPU_FLAGS_ledger_dir="/x")
    out = subprocess.run([sys.executable, "-c", code], env=env, timeout=120,
                         capture_output=True, text=True, check=True).stdout
    assert out.split() == ["True", "64", "/x"]


# -- trace -------------------------------------------------------------------

def test_spans_land_in_the_flight_recorder_with_their_ids(tmp_path):
    rec = trace.flight_recorder()
    start = rec.last_seq
    with trace.span("outer", step=3) as outer:
        carrier = trace.inject({})
        with trace.span("inner") as inner:
            assert trace.current_span() is inner
    assert trace.current_span() is None
    ctx = trace.extract(carrier)
    assert ctx.trace_id == outer.context.trace_id
    assert ctx.span_id == outer.context.span_id
    assert inner.context.parent_id == outer.context.span_id
    events = rec.events_since(start)
    assert [(e["kind"], e["name"]) for e in events] == [
        ("span_begin", "outer"), ("span_begin", "inner"),
        ("span_end", "inner"), ("span_end", "outer")]
    assert events[0]["step"] == 3 and events[0]["rank"] == 0
    assert "dur_ms" in events[-1]
    trace.register_postmortem_info("port.test", lambda: {"ok": 1})
    try:
        path = str(tmp_path / "flight.json")
        assert rec.dump(path) == len(json.load(open(path))["events"])
        assert json.load(open(path))["events"][-1]["kind"] == "port.test"
    finally:
        trace._pm_info.pop("port.test")
    small = trace.FlightRecorder(size=2)
    for i in range(4):
        small.record("k", name=str(i))
    assert [e["name"] for e in small.events()] == ["2", "3"]
    assert small.read_since(0)[1] is True
