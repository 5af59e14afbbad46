"""Profiler API (counterpart of paddle_tpu/utils/profiler.py): scoped host
events, summaries, chrome-trace timelines, and a device-trace bridge.

Reference parity: python/paddle/fluid/profiler.py (`start_profiler`,
`stop_profiler`, the `profiler(...)` context manager, `reset_profiler`) over
platform/profiler.h `RecordEvent` (:126) / `EnableProfiler` (:208), plus
tools/timeline.py's chrome://tracing export.  The host side records into
the native C++ event store (native/src/profiler.cc) through the port's
ctypes bridge (core/native.py); the device side is ``torch.profiler``
(CUPTI on the card) where the JAX package delegates to ``jax.profiler``.
"""
from __future__ import annotations

import contextlib
import functools
import json
import time
from typing import Optional

from ..distributed import env as _env
from ..core import native as _native
from . import monitor as _monitor

_SORTED_KEYS = (None, "total", "calls", "max", "min", "ave")

__all__ = [
    "RecordEvent", "record_event", "start_profiler", "stop_profiler",
    "reset_profiler", "profiler", "export_chrome_tracing", "summary",
    "start_device_trace", "stop_device_trace",
]


class RecordEvent:
    """Scoped host-side event (ref platform/profiler.h:126).

    Usable as a context manager or a decorator::

        with profiler.RecordEvent("data_load"):
            batch = next(loader)
    """

    def __init__(self, name: str):
        self.name = str(name)

    def __enter__(self):
        _native.prof_push(self.name)
        return self

    def __exit__(self, *exc):
        _native.prof_pop()
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with RecordEvent(self.name):
                return fn(*args, **kwargs)
        return wrapper


record_event = RecordEvent


def start_profiler(state: str = "All") -> None:
    """ref fluid/profiler.py start_profiler; `state` kept for API parity —
    host events are always recorded; the device trace is
    `start_device_trace`."""
    _native.prof_enable()


def stop_profiler(sorted_key: Optional[str] = None,
                  profile_path: Optional[str] = None,
                  stream=None) -> None:
    """Stop recording; emit the summary table (sorted per `sorted_key`:
    total|calls|max|min|ave, ref fluid stop_profiler) and optionally dump a
    chrome-trace timeline to `profile_path`.

    `stream` routes the summary: None → stdout (the fluid behavior), a
    file-like object → `.write()`, a logger → `.info()`."""
    _native.prof_disable()
    if profile_path:
        export_chrome_tracing(profile_path)
    s = summary(sorted_key)
    if not s:
        return
    if stream is None:
        print(s)
    elif hasattr(stream, "write"):
        stream.write(s if s.endswith("\n") else s + "\n")
    elif hasattr(stream, "info"):
        stream.info(s)
    else:
        raise TypeError(f"stream must be None, file-like, or a logger; "
                        f"got {type(stream).__name__}")


def reset_profiler() -> None:
    _native.prof_clear()


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: Optional[str] = None,
             profile_path: Optional[str] = None):
    """ref fluid/profiler.py:profiler context manager."""
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


def export_chrome_tracing(path: str, registry=None) -> int:
    """Dump all recorded host events as chrome://tracing JSON
    (ref tools/timeline.py), merging the metric registry's counter samples
    as chrome counter-track (`ph:"C"`) events.

    Every event's pid is this worker's rank (``torch.distributed`` when
    initialized, else `PADDLE_TRAINER_ID`; the native store writes pid 0)
    and `ph:"M"` `process_name`/`process_sort_index` metadata events label
    the process, so traces of several ranks merge into one timeline.
    Returns the number of events written."""
    rank = _env.get_rank()
    n = _native.prof_export_chrome(path)
    if n >= 0:
        with open(path) as f:
            data = json.load(f)
    else:  # native runtime unavailable: counters-only trace
        data = {"traceEvents": []}
    events = data.setdefault("traceEvents", [])
    for e in events:
        e["pid"] = rank
    ts_us = time.time() * 1e6
    reg = registry if registry is not None else _monitor.default_registry()
    for m in reg.metrics():
        if m.kind != "counter":
            continue
        for labels, value in m.samples():
            name = m.name
            if labels:
                name += "{" + ",".join(f"{k}={labels[k]}"
                                       for k in sorted(labels)) + "}"
            events.append({"name": name, "ph": "C", "pid": rank, "ts": ts_us,
                           "args": {"value": float(value)}})
    data["traceEvents"] = [
        {"name": "process_name", "ph": "M", "pid": rank,
         "args": {"name": f"paddle_tpu rank {rank}"}},
        {"name": "process_sort_index", "ph": "M", "pid": rank,
         "args": {"sort_index": rank}},
    ] + events
    with open(path, "w") as f:
        json.dump(data, f)
    return len(data["traceEvents"])


def summary(sorted_key: Optional[str] = None) -> str:
    """Aggregated per-event table, sorted descending by `sorted_key`
    (total|calls|max|min|ave; default total — ref profiler_helper.h)."""
    if sorted_key not in _SORTED_KEYS:
        raise ValueError(
            f"sorted_key must be one of {_SORTED_KEYS}, got {sorted_key!r}")
    return _native.prof_summary(sorted_key)


# ---------------------------------------------------------------- devices --
_device_prof = None


def start_device_trace(logdir: str) -> None:
    """Start a device trace written to `logdir` in TensorBoard's format
    when stopped: ``torch.profiler`` over the host and, where there is a
    card, CUDA activity (the reference's CUPTI DeviceTracer,
    platform/device_tracer.h:19)."""
    global _device_prof
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    if _device_prof is not None:
        raise RuntimeError("a device trace is already running")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(logdir))
    prof.start()
    _device_prof = prof


def stop_device_trace() -> None:
    global _device_prof
    prof, _device_prof = _device_prof, None
    if prof is not None:
        prof.stop()
