"""DataLoader (counterpart of paddle_tpu/io/dataloader.py).

Reference parity: fluid/reader.py:123 ``DataLoader`` + fluid/dataloader/
(multiprocess workers over shared-memory mmap queues built on
memory/allocation/mmap_allocator.cc, and operators/reader/
buffered_reader.cc double-buffering to device).  The JAX package's own
design, not a wrapper over ``torch.utils.data.DataLoader``; batches stay
numpy on the host, in the JAX package's order, with its errors.  Three
modes:

  * in-process (``num_workers == 0``, or an ``IterableDataset``);
  * worker threads (``num_workers > 0``): numpy batching releases the GIL
    for the heavy copies; results are re-ordered to the sampler's order,
    at most ``num_workers * prefetch_factor`` batches ahead;
  * spawned worker processes (``num_workers > 0`` +
    ``use_shared_memory=True``) whose batch arrays return through POSIX
    shared memory (multiprocessing.shared_memory ≈ the reference's mmap
    allocator): only (name, dtype, shape) metadata crosses the result
    pipe, and the parent unlinks each segment once it has copied it out.
    Workers use the ``spawn`` start method: a forked child must not
    inherit the parent's CUDA context, so ``dataset`` and ``collate_fn``
    must be picklable.  A worker's exception surfaces in the consumer as
    the JAX package's ``RuntimeError``; workers that all died surface
    within ``timeout`` seconds.

``prefetch_to_device`` stages each batch on a device from a feeder thread
(io/prefetch.py): True for the port's current device, or a device.

Spawn caveat: like torch's spawn mode, user scripts must guard entry with
``if __name__ == "__main__"`` — the worker bootstrap re-imports __main__.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from typing import Callable, Optional

import numpy as np

from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler


def default_collate_fn(batch):
    """Stack samples into batch arrays (ref: fluid/dataloader/collate.py).
    Python and numpy integers become int32 (the JAX package's with x64
    off); the ops that want int64 (cross entropy's target, an embedding's
    ids) cast at the op."""
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int32)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    return np.asarray(batch)


def _flatten_batch(batch):
    """Flatten a collated batch (nested tuple/list/dict of arrays) into
    (leaves, spec) for shared-memory transport."""
    leaves = []

    def rec(b):
        if isinstance(b, tuple):
            return ("t", [rec(x) for x in b])
        if isinstance(b, list):
            return ("l", [rec(x) for x in b])
        if isinstance(b, dict):
            return ("d", [(k, rec(v)) for k, v in b.items()])
        arr = np.ascontiguousarray(b)
        leaves.append(arr)
        return ("a", len(leaves) - 1)

    return leaves, rec(batch)


def _unflatten_batch(spec, leaves):
    kind, payload = spec
    if kind == "a":
        return leaves[payload]
    if kind == "t":
        return tuple(_unflatten_batch(s, leaves) for s in payload)
    if kind == "l":
        return [_unflatten_batch(s, leaves) for s in payload]
    return {k: _unflatten_batch(s, leaves) for k, s in payload}


def _unlink_segments(metas):
    from multiprocessing import shared_memory

    for name, _d, _s in metas or ():
        try:
            s = shared_memory.SharedMemory(name=name)
            s.close()
            s.unlink()
        except FileNotFoundError:
            pass


_PARENT_POLL_S = 5.0   # how often an idle spawned worker checks its parent


def _start_all(procs):
    """Start the spawned workers side by side.  A spawn start returns only
    once its child, past the interpreter's start and the import of
    ``__main__``, has read its pickled arguments, so starting the workers
    one after another would add their start-ups up before the first batch
    (the JAX package's loop does).  The first start that fails is raised
    after the others were stopped."""
    errors = []

    def start(p):
        try:
            p.start()
        except BaseException as e:  # noqa: BLE001 — crosses the thread
            errors.append(e)

    threads = [threading.Thread(target=start, args=(p,), daemon=True)
               for p in procs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        for p in procs:
            if p.pid is not None:
                p.terminate()
        raise errors[0]


def _mp_worker_loop(dataset, collate_fn, index_q, result_q):
    """Worker process body: pull (i, indices), collate, publish leaves via
    POSIX shared memory, send only metadata over the pipe (ref
    mmap_allocator.cc memory-mapped return path)."""
    from multiprocessing import shared_memory

    parent = mp.parent_process()
    while True:
        try:
            item = index_q.get(timeout=_PARENT_POLL_S)
        except queue.Empty:
            # an orphan (the parent was killed before it could terminate
            # its workers) exits; the JAX package's waits forever
            if parent is not None and not parent.is_alive():
                return
            continue
        if item is None:
            return
        i, indices = item
        metas = []
        try:
            batch = collate_fn([dataset[j] for j in indices])
            leaves, spec = _flatten_batch(batch)
            for arr in leaves:
                shm = shared_memory.SharedMemory(
                    create=True, size=max(arr.nbytes, 1))
                metas.append((shm.name, str(arr.dtype), arr.shape))
                np.frombuffer(shm.buf, arr.dtype,
                              count=arr.size).reshape(arr.shape)[...] = arr
                shm.close()
            result_q.put((i, spec, metas, None))
        except Exception as e:  # noqa: BLE001 — crosses process boundary
            # reclaim segments already published for this batch, else a shm
            # failure compounds itself
            _unlink_segments(metas)
            result_q.put((i, None, None, f"{type(e).__name__}: {e}"))


class DataLoader:
    def __init__(self, dataset: Dataset, batch_size: Optional[int] = 1,
                 shuffle: bool = False, drop_last: bool = False,
                 batch_sampler: Optional[BatchSampler] = None,
                 collate_fn: Optional[Callable] = None, num_workers: int = 0,
                 prefetch_factor: int = 2, return_list: bool = True,
                 use_shared_memory: bool = False, timeout: int = 0,
                 prefetch_to_device=False):
        del return_list  # API-parity knob (we always return lists/dicts)
        if prefetch_factor < 1:
            raise ValueError(
                f"prefetch_factor must be >= 1, got {prefetch_factor} "
                "(1 = no worker read-ahead beyond the in-flight batch)")
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.use_shared_memory = use_shared_memory
        self.timeout = timeout or 60
        self.prefetch_factor = int(prefetch_factor)
        # True -> stage batches on the current device from a feeder thread
        # (io/prefetch.py DeviceFeeder); a torch.device, a Place or a
        # 'gpu:0'-style string targets a specific device
        self.prefetch_to_device = prefetch_to_device
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size or 1,
                                              drop_last=drop_last)

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset DataLoader has no length")
        return len(self.batch_sampler)

    # -- iteration -----------------------------------------------------------
    def _batches(self):
        if self._iterable:
            batch = []
            for sample in self.dataset:
                batch.append(sample)
                if self.batch_size and len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
        else:
            for indices in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        it = self._host_iter()
        if self.prefetch_to_device:
            from .prefetch import DeviceFeeder

            dev = (None if self.prefetch_to_device is True
                   else self.prefetch_to_device)
            it = iter(DeviceFeeder(it, device=dev))
        yield from it

    def _host_iter(self):
        """Host-side batch stream (worker threads/processes collate)."""
        if self.num_workers <= 0 or self._iterable:
            yield from self._batches()
            return
        if self.use_shared_memory:
            yield from self._multiprocess_iter()
            return
        yield from self._threaded_iter()

    def _multiprocess_iter(self):
        """Spawned worker processes + shared-memory batch return (ref
        fluid/reader.py:123 multiprocess mode).  Output order matches the
        sampler order."""
        from multiprocessing import shared_memory

        ctx = mp.get_context("spawn")
        index_q = ctx.Queue()
        result_q = ctx.Queue()
        batches = list(self.batch_sampler)
        # Backpressure: keep at most num_workers * prefetch_factor index
        # batches outstanding so /dev/shm holds a bounded number of
        # segments, mirroring the threaded path's max_ahead window.
        max_ahead = self.num_workers * self.prefetch_factor
        feed = [0]

        def feed_up_to(consumed):
            while feed[0] < len(batches) and feed[0] - consumed < max_ahead:
                index_q.put((feed[0], list(batches[feed[0]])))
                feed[0] += 1
            if feed[0] == len(batches):
                for _ in range(self.num_workers):
                    index_q.put(None)
                feed[0] += self.num_workers  # only send sentinels once

        feed_up_to(0)
        procs = [ctx.Process(target=_mp_worker_loop,
                             args=(self.dataset, self.collate_fn,
                                   index_q, result_q), daemon=True)
                 for _ in range(self.num_workers)]
        _start_all(procs)

        pending: dict = {}
        try:
            for want in range(len(batches)):
                while want not in pending:
                    try:
                        i, spec, metas, err = result_q.get(
                            timeout=self.timeout)
                    except queue.Empty:
                        # every worker gone, or one killed (a signal, an
                        # exit from native code) with a batch in hand: the
                        # JAX package waits on the survivors here forever
                        if (not any(p.is_alive() for p in procs)
                                or any(p.exitcode not in (None, 0)
                                       for p in procs)):
                            raise RuntimeError(
                                "DataLoader worker processes died without "
                                f"producing batch {want}") from None
                        continue
                    if err is not None:
                        raise RuntimeError(
                            f"DataLoader worker failed on batch {i}: {err}")
                    pending[i] = (spec, metas)
                spec, metas = pending.pop(want)
                leaves = []
                for name, dtype, shape in metas:
                    shm = shared_memory.SharedMemory(name=name)
                    n = int(np.prod(shape)) if shape else 1
                    arr = np.frombuffer(shm.buf, np.dtype(dtype),
                                        count=n).reshape(shape).copy()
                    shm.close()
                    shm.unlink()
                    leaves.append(arr)
                feed_up_to(want + 1)
                yield _unflatten_batch(spec, leaves)
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=5)
            # reclaim segments held by the reorder buffer and any still in
            # the result queue when iteration aborts early
            for _spec, metas in pending.values():
                _unlink_segments(metas)
            try:
                while True:
                    _i, _spec, metas, _err = result_q.get_nowait()
                    _unlink_segments(metas)
            except queue.Empty:
                pass

    def _threaded_iter(self):
        """Index batches are dealt to worker threads round-robin; results are
        re-ordered so output order matches the sampler order."""
        index_q: "queue.Queue" = queue.Queue()
        out: dict = {}
        out_cond = threading.Condition()
        n_batches = 0
        for i, indices in enumerate(self.batch_sampler):
            index_q.put((i, indices))
            n_batches += 1
        stop = object()
        for _ in range(self.num_workers):
            index_q.put(stop)

        max_ahead = self.num_workers * self.prefetch_factor
        next_out = [0]

        shutdown = [False]

        def worker():
            try:
                while True:
                    item = index_q.get()
                    if item is stop:
                        return
                    i, indices = item
                    try:
                        batch = self.collate_fn(
                            [self.dataset[j] for j in indices])
                    except Exception as e:  # propagate to consumer
                        batch = _WorkerError(e)
                    with out_cond:
                        while (i - next_out[0] > max_ahead
                               and not shutdown[0]):
                            out_cond.wait(timeout=1.0)
                        if shutdown[0]:
                            return
                        out[i] = batch
                        out_cond.notify_all()
            except BaseException as e:  # never die silently: unblock consumer
                with out_cond:
                    out.setdefault("error", _WorkerError(
                        e if isinstance(e, Exception) else RuntimeError(repr(e))))
                    out_cond.notify_all()
                raise

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for i in range(n_batches):
                with out_cond:
                    while i not in out:
                        if "error" in out:
                            raise out["error"].exc
                        if (not any(t.is_alive() for t in threads)
                                and i not in out):
                            raise RuntimeError(
                                "DataLoader worker threads exited without "
                                f"producing batch {i}")
                        out_cond.wait(timeout=1.0)
                    batch = out.pop(i)
                    next_out[0] = i + 1
                    out_cond.notify_all()
                if isinstance(batch, _WorkerError):
                    raise batch.exc
                yield batch
        finally:
            # Wake any worker blocked on the back-pressure wait so abandoned
            # iterators (early break) release their threads promptly.
            with out_cond:
                shutdown[0] = True
                out_cond.notify_all()
            for t in threads:
                t.join(timeout=1.0)


class _WorkerError:
    def __init__(self, exc):
        self.exc = exc
