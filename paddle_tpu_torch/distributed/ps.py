"""Parameter-server mode: host sparse embedding tables with pull/push,
async gradient merging and GEO delta sync (counterpart of
paddle_tpu/distributed/ps.py, host numpy code copied so that the port
imports nothing of the JAX package).

Reference parity: the PS runtime family — `ParameterSend/ParameterRecv` row
split across shards (operators/distributed/parameter_send.cc/…recv.cc),
`LargeScaleKV` (operators/distributed/large_scale_kv.h), the `Communicator`
hierarchy (communicator.h:180 — `AsyncCommunicator`:253 grad-merge queue,
`HalfAsyncCommunicator`:326, `SyncCommunicator`:365, `GeoCommunicator`:396
delta sync), FleetWrapper pull/push sparse (framework/fleet/fleet_wrapper.h:60)
and `HeartBeatMonitor` (operators/distributed/heart_beat_monitor.h).

Design (the JAX package's): dense training runs on the device; embedding
tables too large for device memory live in **host RAM**, sharded by row
hash.  Each step pulls just the touched rows as a dense slab (one small
host-to-device copy), the step differentiates with respect to the slab on
the device, and the sparse row update (SGD/Adagrad/Adam) applies on the
host.  Rows fault in lazily in pull order from a per-shard
``RandomState``, so the same seeds and the same ids in the same order give
the JAX package's rows bit for bit.  ``ps_server.py`` carries a table over
TCP.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

__all__ = [
    "SparseTable", "LargeScaleEmbedding", "AsyncCommunicator",
    "GeoCommunicator", "HeartBeatMonitor",
]


def _merge_duplicate_ids(ids: np.ndarray, grads: np.ndarray):
    """Sum grads of duplicate ids (the reference's SelectedRows MergeAdd
    before send).  Returns (unique_ids, merged_grads)."""
    uniq, inv = np.unique(ids, return_inverse=True)
    merged = np.zeros((len(uniq), grads.shape[1]), np.float32)
    np.add.at(merged, inv, grads)
    return uniq, merged


class _Shard:
    """One hash shard of a row-sharded table (ref: the per-pserver block of
    ParameterSend's row split).  Rows materialize lazily on first touch
    (large_scale_kv.h semantics: an unbounded KV of rows)."""

    def __init__(self, dim: int, initializer: Callable[[int], np.ndarray],
                 optimizer: str, beta1: float, beta2: float):
        self.dim = dim
        self.rows: Dict[int, np.ndarray] = {}
        self.accum: Dict[int, np.ndarray] = {}   # adagrad G / adam m
        self.accum2: Dict[int, np.ndarray] = {}  # adam v
        self.step_count: Dict[int, int] = {}
        self.init = initializer
        self.optimizer = optimizer
        self.beta1, self.beta2 = beta1, beta2
        self.lock = threading.Lock()

    def pull(self, ids: np.ndarray) -> np.ndarray:
        out = np.empty((len(ids), self.dim), np.float32)
        with self.lock:
            for i, r in enumerate(ids):
                row = self.rows.get(int(r))
                if row is None:
                    row = self.init(self.dim).astype(np.float32)
                    self.rows[int(r)] = row
                out[i] = row
        return out

    def push(self, ids: np.ndarray, grads: np.ndarray, lr: float) -> None:
        with self.lock:
            for r, g in zip(ids, grads):
                r = int(r)
                row = self.rows.get(r)
                if row is None:
                    row = self.init(self.dim).astype(np.float32)
                    self.rows[r] = row
                if self.optimizer == "sgd":
                    row -= lr * g
                elif self.optimizer == "adagrad":
                    acc = self.accum.setdefault(r, np.zeros(self.dim, np.float32))
                    acc += g * g
                    row -= lr * g / (np.sqrt(acc) + 1e-6)
                elif self.optimizer == "adam":
                    m = self.accum.setdefault(r, np.zeros(self.dim, np.float32))
                    v = self.accum2.setdefault(r, np.zeros(self.dim, np.float32))
                    t = self.step_count.get(r, 0) + 1
                    self.step_count[r] = t
                    m[:] = self.beta1 * m + (1 - self.beta1) * g
                    v[:] = self.beta2 * v + (1 - self.beta2) * g * g
                    mhat = m / (1 - self.beta1 ** t)
                    vhat = v / (1 - self.beta2 ** t)
                    row -= lr * mhat / (np.sqrt(vhat) + 1e-8)
                else:
                    raise ValueError(f"unknown optimizer {self.optimizer!r}")

    def apply_delta(self, ids: np.ndarray, delta: np.ndarray) -> None:
        with self.lock:
            for r, d in zip(ids, delta):
                r = int(r)
                row = self.rows.get(r)
                if row is None:
                    row = self.init(self.dim).astype(np.float32)
                    self.rows[r] = row
                row += d


class SparseTable:
    """Row-hash-sharded sparse table (ref LargeScaleKV + ParameterSend's
    VarBlock split).  num_shards models the pserver count; shard(i) is the
    multi-host seam."""

    _OPTIMIZERS = ("sgd", "adagrad", "adam")

    def __init__(self, dim: int, num_shards: int = 4,
                 initializer: Optional[Callable[[int], np.ndarray]] = None,
                 optimizer: str = "adagrad", seed: int = 0,
                 beta1: float = 0.9, beta2: float = 0.999):
        if optimizer not in self._OPTIMIZERS:
            # validated here, not at first push — a bad name must not kill
            # the AsyncCommunicator worker thread mid-training
            raise ValueError(f"unknown optimizer {optimizer!r}; "
                             f"one of {self._OPTIMIZERS}")
        self.dim = dim
        self.num_shards = num_shards

        def make_init(shard_idx):
            if initializer is not None:
                return initializer
            # per-shard RNG: shards fault rows in from different threads
            # (trainer pull vs async-communicator push) and numpy
            # RandomState is not thread-safe
            rng = np.random.RandomState(seed + shard_idx * 9973)
            scale = 1.0 / np.sqrt(dim)
            return lambda d: rng.uniform(-scale, scale, d)

        self.shards = [_Shard(dim, make_init(i), optimizer, beta1, beta2)
                       for i in range(num_shards)]

    def _route(self, ids: np.ndarray):
        ids = np.asarray(ids).reshape(-1)
        shard_of = ids % self.num_shards
        return ids, shard_of

    def pull(self, ids) -> np.ndarray:
        """Gather rows for (possibly duplicated) ids; returns [len(ids), dim]."""
        ids, shard_of = self._route(ids)
        out = np.empty((len(ids), self.dim), np.float32)
        for s in range(self.num_shards):
            m = shard_of == s
            if m.any():
                out[m] = self.shards[s].pull(ids[m])
        return out

    def push(self, ids, grads, lr: float = 0.1) -> None:
        """Apply sparse row updates; duplicate ids are pre-accumulated (the
        reference's MergeAdd on SelectedRows before send)."""
        ids, shard_of = self._route(ids)
        grads = np.asarray(grads, np.float32).reshape(len(ids), self.dim)
        uniq, merged = _merge_duplicate_ids(ids, grads)
        shard_of_u = uniq % self.num_shards
        for s in range(self.num_shards):
            m = shard_of_u == s
            if m.any():
                self.shards[s].push(uniq[m], merged[m], lr)

    def apply_delta(self, ids, delta) -> None:
        ids, shard_of = self._route(ids)
        delta = np.asarray(delta, np.float32).reshape(len(ids), self.dim)
        for s in range(self.num_shards):
            m = shard_of == s
            if m.any():
                self.shards[s].apply_delta(ids[m], delta[m])

    @property
    def num_rows(self) -> int:
        return sum(len(s.rows) for s in self.shards)

    def state_dict(self) -> Dict[str, np.ndarray]:
        """Rows AND optimizer slots — a restored table must take identical
        update steps (adagrad accumulators, adam moments + step counts)."""
        ids, rows, acc, acc2, steps = [], [], [], [], []
        zero = np.zeros(self.dim, np.float32)
        for s in self.shards:
            with s.lock:
                for r, row in s.rows.items():
                    ids.append(r)
                    rows.append(row.copy())
                    acc.append(s.accum.get(r, zero).copy())
                    acc2.append(s.accum2.get(r, zero).copy())
                    steps.append(s.step_count.get(r, 0))
        order = np.argsort(ids)
        ids = np.asarray(ids, np.int64)[order]

        def pack(lst):
            return np.stack(lst)[order] if lst else np.zeros((0, self.dim),
                                                             np.float32)

        return {"ids": ids, "rows": pack(rows), "accum": pack(acc),
                "accum2": pack(acc2),
                "steps": np.asarray(steps, np.int64)[order] if steps
                else np.zeros(0, np.int64)}

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        n = len(state["ids"])
        accum = state.get("accum")
        accum2 = state.get("accum2")
        steps = state.get("steps")
        for i in range(n):
            r = int(state["ids"][i])
            s = self.shards[r % self.num_shards]
            with s.lock:
                s.rows[r] = np.asarray(state["rows"][i], np.float32).copy()
                if accum is not None and len(accum):
                    s.accum[r] = np.asarray(accum[i], np.float32).copy()
                if accum2 is not None and len(accum2):
                    s.accum2[r] = np.asarray(accum2[i], np.float32).copy()
                if steps is not None and len(steps):
                    s.step_count[r] = int(steps[i])


class LargeScaleEmbedding:
    """The user-facing sparse layer for PS-style training (ref FleetWrapper
    pull_sparse/push_sparse around each batch, DownpourWorker flow
    device_worker.h:246).

    Usage in a functional train step::

        emb = LargeScaleEmbedding(dim=64)
        slab = emb.pull(ids)                        # host gather -> [n, dim]
        loss, (slab_grad, dense_grads) = step(slab, ids, ...)   # on device
        emb.push(ids, slab_grad, lr)                # host sparse update
    """

    def __init__(self, dim: int, num_shards: int = 4,
                 optimizer: str = "adagrad", seed: int = 0):
        self.table = SparseTable(dim, num_shards, optimizer=optimizer,
                                 seed=seed)
        self.dim = dim

    def pull(self, ids) -> np.ndarray:
        ids = np.asarray(ids)
        flat = self.table.pull(ids.reshape(-1))
        return flat.reshape(ids.shape + (self.dim,))

    def push(self, ids, grads, lr: float = 0.1) -> None:
        ids = np.asarray(ids)
        self.table.push(ids.reshape(-1), np.asarray(grads), lr)


class AsyncCommunicator:
    """Background grad-merge-and-apply pipeline (ref AsyncCommunicator
    communicator.h:253: per-var queues, merge `max_merge_var_num` grads,
    send).  Here "send" = apply to the host table; the queue decouples the
    training loop from the host-side sparse update."""

    def __init__(self, table: SparseTable, lr: float = 0.1,
                 max_merge: int = 4, queue_size: int = 64):
        self.table = table
        self.lr = lr
        self.max_merge = max_merge
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("AsyncCommunicator already started")
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Drain pending grads, then stop.  The worker exits only on the
        sentinel, so it keeps draining until the sentinel fits even if the
        bounded queue is full when stop() is called (no deadlock)."""
        if self._thread is not None:
            self._q.put(None)  # sentinel: processed strictly after pending
            self._thread.join()
            self._thread = None

    def send(self, ids: np.ndarray, grads: np.ndarray) -> None:
        """Enqueue a sparse grad (blocks when the queue is full — the
        reference's back-pressure on send queues)."""
        self._q.put((np.asarray(ids).reshape(-1).copy(),
                     np.asarray(grads, np.float32).copy()))

    def flush(self) -> None:
        self._q.join()

    def _loop(self) -> None:
        done = False
        while not done:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            batch = [item]
            # merge up to max_merge pending grads into one push
            for _ in range(self.max_merge - 1):
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._q.task_done()
                    done = True  # finish this batch, then exit
                    break
                batch.append(nxt)
            ids = np.concatenate([b[0] for b in batch])
            grads = np.concatenate(
                [b[1].reshape(len(b[0]), -1) for b in batch])
            self.table.push(ids, grads, self.lr)
            for _ in batch:
                self._q.task_done()


class GeoCommunicator:
    """GEO-SGD delta sync (ref GeoCommunicator communicator.h:396,
    geo_sgd_transpiler.py): each worker trains a LOCAL dense copy of the
    embedding rows it touches; every `trainer_nums`-ish steps it ships the
    accumulated delta (local - base) to the global table and re-pulls."""

    def __init__(self, table: SparseTable, sync_steps: int = 10):
        self.table = table
        self.sync_steps = sync_steps
        self._local: Dict[int, np.ndarray] = {}
        self._base: Dict[int, np.ndarray] = {}
        self._step = 0

    def pull(self, ids) -> np.ndarray:
        """Rows from the local copy, faulting-in from the global table."""
        ids = np.asarray(ids).reshape(-1)
        missing = [int(r) for r in np.unique(ids) if int(r) not in self._local]
        if missing:
            rows = self.table.pull(np.asarray(missing))
            for r, row in zip(missing, rows):
                self._local[r] = row.copy()
                self._base[r] = row.copy()
        return np.stack([self._local[int(r)] for r in ids])

    def update_local(self, ids, grads, lr: float = 0.1) -> None:
        """Local SGD on the worker copy; counts toward the sync cadence."""
        ids = np.asarray(ids).reshape(-1)
        self.pull(ids)  # fault in rows not yet seen by this worker
        grads = np.asarray(grads, np.float32).reshape(len(ids), -1)
        uniq, merged = _merge_duplicate_ids(ids, grads)
        for r, g in zip(uniq, merged):
            self._local[int(r)] -= lr * g
        self._step += 1
        if self._step % self.sync_steps == 0:
            self.sync()

    def sync(self) -> None:
        """Ship deltas, then rebase on the (possibly concurrently updated)
        global rows — the GEO convergence contract."""
        if not self._local:
            return
        ids = np.asarray(sorted(self._local), np.int64)
        delta = np.stack([self._local[int(r)] - self._base[int(r)]
                          for r in ids])
        self.table.apply_delta(ids, delta)
        fresh = self.table.pull(ids)
        for r, row in zip(ids, fresh):
            self._local[int(r)] = row.copy()
            self._base[int(r)] = row.copy()


class SyncCommunicator:
    """Barrier-per-step synchronous PS (ref ``SyncCommunicator``
    communicator.h:365 + the barrier counters of listen_and_serv_op.h:56):
    every trainer pushes its gradients, then blocks on a step barrier —
    pulls after the barrier see EVERY trainer's update, so the parameter
    trajectory matches a single process applying the merged gradient (the
    reference's TestDistBase correctness baseline).

    ``barrier`` is any callable ``(name: str) -> None`` that blocks until
    all ``num_workers`` arrive: a shared ``threading.Barrier`` wrapper for
    in-process workers, or ``RemoteSparseTable.barrier`` across processes.
    """

    def __init__(self, table, worker_id: int, num_workers: int,
                 lr: float = 0.1, barrier: Optional[Callable] = None):
        self.table = table
        self.worker_id = worker_id
        self.num_workers = num_workers
        self.lr = lr
        if barrier is None:
            remote = getattr(table, "barrier", None)
            if remote is not None:
                barrier = lambda name: remote(name, num_workers)  # noqa: E731
            else:
                raise ValueError(
                    "sync PS needs a barrier: pass one, or use a table "
                    "with a .barrier (RemoteSparseTable)")
        self._barrier = barrier
        self._step = 0

    def pull(self, ids) -> np.ndarray:
        """Pull, then rendezvous: no trainer may push step k+1 grads until
        every trainer has read the step-k parameters (the reference's GET
        barrier counter, listen_and_serv_op.h:56 — sync PS needs BOTH
        barriers or a fast trainer's push races a slow trainer's read)."""
        rows = self.table.pull(ids)
        self._barrier(f"pull_{self._step}")
        return rows

    def push_and_sync(self, ids, grads) -> None:
        """Push this trainer's gradient, then rendezvous (the SEND barrier
        counter).  Per-trainer lr scaling is the caller's choice
        (lr/num_workers reproduces the single-process merged-mean step for
        linear rules like sgd)."""
        self.table.push(ids, grads, self.lr)
        self._step += 1
        self._barrier(f"push_{self._step}")

    def barrier(self) -> None:
        self._step += 1
        self._barrier(f"push_{self._step}")


class HalfAsyncCommunicator(AsyncCommunicator):
    """Bounded-staleness PS (ref ``HalfAsyncCommunicator``
    communicator.h:326): pushes ride the async merge queue, but every
    ``barrier_every`` steps the trainer drains its queue and rendezvous
    with the other trainers — staleness is bounded by the window instead
    of unbounded like pure async."""

    def __init__(self, table, lr: float = 0.1, max_merge: int = 4,
                 queue_size: int = 64, barrier_every: int = 4,
                 worker_id: int = 0, num_workers: int = 1,
                 barrier: Optional[Callable] = None):
        super().__init__(table, lr=lr, max_merge=max_merge,
                         queue_size=queue_size)
        self.barrier_every = barrier_every
        self.worker_id = worker_id
        self.num_workers = num_workers
        if barrier is None:
            remote = getattr(table, "barrier", None)
            if remote is not None:
                barrier = lambda name: remote(name, num_workers)  # noqa: E731
            elif num_workers == 1:
                barrier = lambda name: None  # noqa: E731 — nothing to sync
            else:
                raise ValueError(
                    "half-async PS with num_workers > 1 needs a barrier: "
                    "pass one, or use a table with a .barrier "
                    "(RemoteSparseTable) — a silent no-op would void the "
                    "bounded-staleness contract")
        self._barrier = barrier
        self._step = 0
        self._window = 0

    def step_end(self) -> None:
        """Call once per training step; at the window boundary the local
        queue drains and all trainers rendezvous (BarrierTriggerDecrement
        semantics of the reference's half-async path)."""
        self._step += 1
        if self._step % self.barrier_every == 0:
            self.flush()
            self._window += 1
            self._barrier(f"window_{self._window}")


class HeartBeatMonitor:
    """Tracks per-worker liveness (ref heart_beat_monitor.h: pserver thread
    logging trainers whose last beat is stale).  A worker beating again
    after being reported dead is re-registered (``on_revive``) — the
    rescue path a restarted worker takes."""

    def __init__(self, worker_num: int, timeout_s: float = 30.0,
                 on_dead: Optional[Callable[[int], None]] = None,
                 on_revive: Optional[Callable[[int], None]] = None):
        self.timeout_s = timeout_s
        self.on_dead = on_dead
        self.on_revive = on_revive
        self._beats = {i: time.monotonic() for i in range(worker_num)}
        self._reported: set = set()
        self._lock = threading.Lock()
        self._running = False
        self._thread: Optional[threading.Thread] = None

    def beat(self, worker_id: int) -> None:
        revived = False
        with self._lock:
            if worker_id not in self._beats:
                revived = True  # a brand-new/replacement worker id
            elif worker_id in self._reported:
                revived = True
            self._beats[worker_id] = time.monotonic()
            self._reported.discard(worker_id)
        if revived:
            from ..utils import trace as _trace

            _trace.flight_recorder().record(
                "worker_revive", name=f"worker{worker_id}", worker=worker_id)
            if self.on_revive is not None:
                self.on_revive(worker_id)

    def dead_workers(self) -> List[int]:
        now = time.monotonic()
        with self._lock:
            return [w for w, t in self._beats.items()
                    if now - t > self.timeout_s]

    def start(self, interval_s: float = 1.0) -> None:
        self._running = True

        def loop():
            while self._running:
                to_report = []
                now = time.monotonic()
                with self._lock:
                    # staleness re-checked under the same lock as the report
                    # marker, so a beat() landing in between cannot get a
                    # worker reported as dead
                    for w, t in self._beats.items():
                        if now - t > self.timeout_s and w not in self._reported:
                            self._reported.add(w)
                            to_report.append(w)
                for w in to_report:
                    from ..utils import trace as _trace

                    _trace.flight_recorder().record(
                        "worker_dead", name=f"worker{w}", worker=w,
                        timeout_s=self.timeout_s)
                    if self.on_dead is not None:
                        try:
                            self.on_dead(w)
                        except Exception:
                            # a failing callback must not kill liveness
                            # monitoring for every other worker
                            import traceback
                            traceback.print_exc()
                time.sleep(interval_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None
