"""Host→device prefetch (counterpart of paddle_tpu/io/prefetch.py): overlap
the host-to-device copy of batch N+1 with the compute of batch N.

Reference parity: the DataFeed channel feeding per-thread DeviceWorkers
(framework/data_feed.h + device_worker.h:215) and operators/reader/
buffered_reader.cc, which double-buffers host batches onto the device
stream.  As in the JAX package, one background thread pulls collated host
batches from any iterable, stages them on the device and hands them to the
consumer through a bounded queue; the queue depth is the double buffer.

Where ``jax.device_put`` is asynchronous by itself, a torch copy issued
from the feeder thread would run on that thread's current stream, the
default stream, serialized with the consumer's compute, and would race the
consumer unless the two are ordered.  So each batch is staged so:

* each host array is copied into pinned memory;
* copied with ``non_blocking=True`` on the feeder's own
  ``torch.cuda.Stream`` (one a device), and an event is recorded on it
  after the batch's last copy;
* when the batch is handed out, the consumer's current stream waits on
  that event (a device-side wait: the host does not block), and every
  staged tensor is ``record_stream``-ed on the consumer's stream, so the
  caching allocator does not give its memory to the next copy before the
  consumer's kernels that read it have run.

On the CPU a batch's arrays become tensors and nothing else happens.
Leaves keep their numpy dtypes (the collate's int32 stays int32).

Telemetry, as in the JAX package: the ``io.prefetch_depth`` gauge tracks
how many staged batches sit ahead of the consumer (0 means the consumer is
data-starved), ``io.prefetch_batches`` counts staged batches, and the
feeder thread emits ``io::prefetch_feeder`` / ``io::prefetch_put`` spans.

Wired into ``DataLoader(prefetch_to_device=...)``, ``hapi.Model.fit`` and
``Executor.train_from_dataset``; use directly for custom loops::

    for batch in DeviceFeeder(loader):      # leaves are tensors on the card
        loss = step(*batch)
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..core import device as _device
from ..utils import monitor as _monitor
from ..utils import trace as _trace

__all__ = ["DeviceFeeder", "device_prefetch", "resolve_device", "stage"]

_m_depth = _monitor.gauge(
    "io.prefetch_depth", "Device-staged batches queued ahead of the consumer "
    "(DeviceFeeder); 0 in steady state means the feeder is the bottleneck.")
_m_batches = _monitor.counter(
    "io.prefetch_batches", "Batches staged host->device by DeviceFeeder "
    "threads.")


def resolve_device(device):
    """None -> the port's current device (the card unless the caller asked
    for the CPU); a ``"gpu:1"`` / ``"cuda"`` / ``"cpu"`` / ``"tpu"``
    string, a ``Place`` or a ``torch.device`` -> that ``torch.device``; a
    {leaf_name: device} dict resolves per entry (dict batches are then
    staged leaf by leaf)."""
    if isinstance(device, dict):
        return {k: resolve_device(v) for k, v in device.items()}
    return _device.resolve_device(device)


class _Staged:
    """A staged batch: its tree, the tensors copied to a card with their
    devices, and the event each card's copy stream recorded after them."""

    __slots__ = ("batch", "tensors", "events")

    def __init__(self, batch, tensors, events):
        self.batch = batch
        self.tensors = tensors
        self.events = events


class _Stager:
    """Stages batches on their devices; one copy stream a card."""

    def __init__(self):
        self._streams: Dict[torch.device, "torch.cuda.Stream"] = {}

    def _stream(self, dev: torch.device):
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(device=dev)
        return s

    def _leaf(self, x, dev: torch.device, copied: List):
        if isinstance(x, torch.Tensor):
            t = x
        elif isinstance(x, (np.ndarray, np.generic, bool, int, float)):
            t = torch.from_numpy(np.array(x, copy=True, order="C")
                                 if np.ndim(x) == 0 else
                                 np.ascontiguousarray(x))
        else:
            return x
        if dev.type != "cuda":
            return t.to(dev)
        if t.device.type == "cpu" and not t.is_pinned():
            t = t.pin_memory()
        with torch.cuda.stream(self._stream(dev)):
            out = t.to(dev, non_blocking=True)
        copied.append((out, dev))
        return out

    def _tree(self, b, dev, copied):
        if isinstance(b, dict):
            return {k: self._tree(v, dev, copied) for k, v in b.items()}
        if isinstance(b, tuple):
            return tuple(self._tree(v, dev, copied) for v in b)
        if isinstance(b, list):
            return [self._tree(v, dev, copied) for v in b]
        return self._leaf(b, dev, copied)

    def stage(self, batch, device) -> _Staged:
        copied: List[Tuple[torch.Tensor, torch.device]] = []
        if isinstance(device, dict):
            if not isinstance(batch, dict):
                raise TypeError(
                    "DeviceFeeder got a per-leaf device dict but a "
                    f"{type(batch).__name__} batch; per-leaf placement needs "
                    "dict batches ({name: array})")
            default = resolve_device(None)
            tree = {k: self._tree(v, device.get(k, default), copied)
                    for k, v in batch.items()}
        else:
            tree = self._tree(batch, device, copied)
        events = {dev: self._stream(dev).record_event()
                  for dev in {d for _, d in copied}}
        return _Staged(tree, copied, events)


def _handoff(staged: _Staged):
    """Order the consumer's stream after the batch's copies and tie the
    staged tensors' memory to it; returns the batch."""
    for dev, event in staged.events.items():
        torch.cuda.current_stream(dev).wait_event(event)
    for t, dev in staged.tensors:
        t.record_stream(torch.cuda.current_stream(dev))
    return staged.batch


class _FeederError:
    def __init__(self, exc: BaseException):
        self.exc = exc


class DeviceFeeder:
    """Iterate ``source`` with its batches already resident on ``device``.

    One feeder = one background thread + one bounded queue.  Iterating the
    feeder starts the thread; exhausting it, breaking out, or calling
    ``close()`` stops the thread and drains the queue.  Exceptions raised by
    the source (or by the staging) surface in the consumer."""

    _END = object()

    def __init__(self, source: Iterable[Any], device=None, depth: int = 2):
        if depth < 1:
            raise ValueError(f"DeviceFeeder depth must be >= 1, got {depth}")
        self._source = source
        self._device = resolve_device(device)
        self._depth = depth
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stager = _Stager()

    @property
    def depth(self) -> int:
        return self._depth

    def _put(self, item) -> bool:
        """Backpressured put: blocks while the queue is full, bails out when
        the consumer shut down (abandoned iterator)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            with _trace.span("io::prefetch_feeder", device=str(self._device)):
                n = 0
                for batch in self._source:
                    if self._stop.is_set():
                        return
                    with _trace.span("io::prefetch_put", batch=n):
                        # asynchronous on a card: the copy overlaps the
                        # consumer's running step
                        staged = self._stager.stage(batch, self._device)
                    n += 1
                    _m_batches.inc()
                    if not self._put(staged):
                        return
                    _m_depth.set(self._q.qsize())
                self._put(self._END)
        except BaseException as e:  # noqa: BLE001 — crosses the thread
            self._put(_FeederError(e))

    def __iter__(self):
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._worker, name="pdtpu-device-feeder", daemon=True)
        self._thread.start()
        try:
            while True:
                item = self._q.get()
                _m_depth.set(self._q.qsize())
                if item is self._END:
                    return
                if isinstance(item, _FeederError):
                    raise item.exc
                yield _handoff(item)
        finally:
            self.close()

    def close(self):
        """Stop the feeder thread and release queued batches."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        _m_depth.set(0)


def device_prefetch(source: Iterable[Any], device=None, depth: int = 2):
    """Functional form of :class:`DeviceFeeder` (returns an iterator)."""
    return iter(DeviceFeeder(source, device=device, depth=depth))


def stage(batch, device=None):
    """Stage ONE batch on ``device`` (same placement rules as DeviceFeeder),
    ordered before the caller's next work on the current stream.  The
    one-shot face of the feeder for callers whose batches are assembled on
    demand rather than pulled from an iterable."""
    return _handoff(_Stager().stage(batch, resolve_device(device)))
