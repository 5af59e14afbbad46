"""Multi-slot datasets over the native feed engine (counterpart of
paddle_tpu/io/multislot.py).

Reference parity: python/paddle/fluid/dataset.py — `DatasetFactory`,
`InMemoryDataset` (:328) and `QueueDataset` (:852), which configure the C++
DataFeed/Dataset service (framework/data_feed.h:108, data_set.h).  Here the
service is native/src/datafeed.cc (parallel parse + shuffle + async batch
assembly off the GIL), which the port builds itself (core/native.py);
slots are fixed-dim, as in the JAX package (the LoD-ragged slots of the
reference become pad/truncate-to-dim).

When the native library is unavailable the same API runs on a pure-Python
parser (slower, identical semantics) so behavior never depends on a local
toolchain; ``core.native.available()`` says which one runs.  The two
shuffle with different generators (the C++ engine's and
``random.Random(seed)``), so a shuffled order is reproducible only within
one of them.
"""
from __future__ import annotations

import random
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from ..core import native as _native

__all__ = ["DatasetFactory", "InMemoryDataset", "QueueDataset"]


class _PySlotFeed:
    """Pure-python fallback with the same line format as datafeed.cc."""

    def __init__(self, slots, batch_size):
        self.slots = slots
        self.batch_size = batch_size
        self._files: List[str] = []
        self._samples: List[Tuple[np.ndarray, np.ndarray]] = []
        self._fdim = sum(d for _, t, d in slots if not t.startswith("int"))
        self._idim = sum(d for _, t, d in slots if t.startswith("int"))

    def set_filelist(self, files):
        self._files = list(files)

    def load_into_memory(self):
        for path in self._files:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    fv = np.zeros(self._fdim, np.float32)
                    iv = np.zeros(self._idim, np.int64)
                    foff = ioff = 0
                    fields = line.split(";")
                    for (name, t, d), field in zip(self.slots, fields):
                        vals = [v for v in field.split(",") if v]
                        if t.startswith("int"):
                            arr = np.array([int(v) for v in vals[:d]], np.int64)
                            iv[ioff:ioff + len(arr)] = arr
                            ioff += d
                        else:
                            arr = np.array([float(v) for v in vals[:d]], np.float32)
                            fv[foff:foff + len(arr)] = arr
                            foff += d
                    self._samples.append((fv, iv))
        return len(self._samples)

    def local_shuffle(self, seed=0):
        random.Random(seed).shuffle(self._samples)

    @property
    def num_samples(self):
        return len(self._samples)

    def release_memory(self):
        self._samples = []

    def __iter__(self):
        for i in range(0, len(self._samples), self.batch_size):
            chunk = self._samples[i:i + self.batch_size]
            fmat = np.stack([c[0] for c in chunk]) if self._fdim else np.empty((len(chunk), 0))
            imat = np.stack([c[1] for c in chunk]) if self._idim else np.empty((len(chunk), 0), np.int64)
            out = {}
            foff = ioff = 0
            for name, t, d in self.slots:
                # .copy() matches NativeDataFeed._split: batches are always
                # owned arrays, never views into the sample store.
                if t.startswith("int"):
                    out[name] = imat[:, ioff:ioff + d].copy()
                    ioff += d
                else:
                    out[name] = fmat[:, foff:foff + d].copy()
                    foff += d
            yield out


class InMemoryDataset:
    """Load-all-then-shuffle dataset (ref fluid/dataset.py:328).

    Usage mirrors the reference:
        ds = InMemoryDataset()
        ds.set_use_var([("x", "float32", 8), ("y", "int64", 1)])
        ds.set_batch_size(32)
        ds.set_filelist(files)
        ds.load_into_memory()
        ds.local_shuffle()
        for batch in ds: ...   # dict name -> np.ndarray[batch, dim]
    """

    queue_backed = False

    def __init__(self):
        self._slots: List[Tuple[str, str, int]] = []
        self._batch_size = 1
        self._thread_num = 4
        self._files: List[str] = []
        self._feed = None

    # -- configuration (reference setter names) --
    # Configuration is fixed once the underlying feed exists (first lifecycle
    # call); later changes would be silently ignored, so they raise instead.
    def _check_not_built(self, what: str) -> None:
        if self._feed is not None:
            raise RuntimeError(
                f"{what} must be called before load_into_memory()/iteration; "
                "create a new dataset to change it")

    def set_use_var(self, slots: Sequence[Tuple[str, str, int]]) -> None:
        self._check_not_built("set_use_var")
        for n, _, d in slots:
            if ";" in str(n) or ":" in str(n):
                raise ValueError(f"slot name {n!r} may not contain ';' or ':'")
            if int(d) <= 0:
                raise ValueError(f"slot {n!r} dim must be positive, got {d}")
        self._slots = [(n, t, int(d)) for n, t, d in slots]

    def set_batch_size(self, batch_size: int) -> None:
        self._check_not_built("set_batch_size")
        self._batch_size = int(batch_size)

    def set_thread(self, thread_num: int) -> None:
        self._check_not_built("set_thread")
        self._thread_num = int(thread_num)

    def set_filelist(self, files: Sequence[str]) -> None:
        self._files = list(files)
        if self._feed is not None:
            self._feed.set_filelist(self._files)

    def _ensure_feed(self):
        if self._feed is None:
            if not self._slots:
                raise ValueError("call set_use_var() before loading data")
            if _native.available():
                self._feed = _native.NativeDataFeed(
                    self._slots, self._batch_size,
                    capacity=8, num_threads=self._thread_num)
            else:
                self._feed = _PySlotFeed(self._slots, self._batch_size)
            self._feed.set_filelist(self._files)
        return self._feed

    # -- lifecycle (reference method names) --
    def load_into_memory(self) -> int:
        return self._ensure_feed().load_into_memory()

    def local_shuffle(self, seed: int = 0) -> None:
        self._ensure_feed().local_shuffle(seed)

    def global_shuffle(self, fleet=None, seed: int = 0) -> None:
        # ref data_set.h global shuffle redistributes samples across trainers
        # via the PS; as in the JAX package each host reads a disjoint file
        # shard, so a per-host shuffle with a shared seed stands in for the
        # exchange for i.i.d. consumption.
        self.local_shuffle(seed)

    def release_memory(self) -> None:
        if self._feed is not None:
            self._feed.release_memory()

    def get_memory_data_size(self) -> int:
        return self._feed.num_samples if self._feed is not None else 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return iter(self._ensure_feed())


class QueueDataset(InMemoryDataset):
    """Streaming variant (ref fluid/dataset.py:852): no global load/shuffle —
    iteration parses files on the fly.  Implemented over the same engine; the
    load happens per-epoch and local_shuffle is a no-op (matching the
    reference's restriction that QueueDataset cannot shuffle)."""

    queue_backed = True

    def local_shuffle(self, seed: int = 0) -> None:
        raise RuntimeError("QueueDataset does not support shuffle "
                           "(ref fluid/dataset.py:928)")

    def global_shuffle(self, fleet=None, seed: int = 0) -> None:
        raise RuntimeError("QueueDataset does not support shuffle")

    def __iter__(self):
        feed = self._ensure_feed()
        if feed.num_samples == 0:
            feed.load_into_memory()
        it = iter(feed)
        try:
            yield from it
        finally:
            feed.release_memory()


class DatasetFactory:
    """ref fluid/dataset.py:44 — create_dataset("InMemoryDataset"|"QueueDataset")."""

    def create_dataset(self, datafeed_class: str = "QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        raise ValueError(f"unknown dataset class {datafeed_class!r}")
