"""Elastic membership: heartbeat liveness, eviction, resume coordination
(counterpart of paddle_tpu/elastic/membership.py).

Reference parity: the fleet elastic manager (the etcd-backed membership of
paddle.distributed.fleet.elastic: workers register, a watchdog scrapes
heartbeats, the job relaunches at the surviving scale) and
heart_beat_monitor.h's pserver-side staleness scan.

Design (the JAX package's): membership state is a shared *directory*
instead of an etcd cluster — every rank atomically rewrites ``hb.<rank>.json``
({rank, pid, step, ts}) on a background thread, and any rank can evaluate
the same liveness predicate by reading the directory.  That keeps the
coordination substrate identical to the checkpoint substrate (a shared
filesystem), needs no new wire protocol, and is exactly what the
subprocess chaos tests exercise: SIGKILL stops the victim's heartbeat
file from advancing, survivors see its age cross ``dead_after_s``.

The recovery protocol is detect → record → evict → resume:

* ``detect_and_evict`` flight-records ``worker_dead`` for every stale
  rank, then claims an ``evicted.<rank>`` marker with O_CREAT|O_EXCL —
  first writer wins, so exactly one survivor records the
  ``worker_evicted`` event and bumps ``elastic.worker_deaths`` even
  though every survivor observes the shrunken world;
* the caller rebuilds its mesh at ``world_size()`` (initial world minus
  evictions), restores the latest elastic checkpoint, and calls
  ``record_resume`` — completing the event chain the flight dump pins.

Stragglers are detected from the ``step`` field each heartbeat carries:
a live rank more than ``straggler_steps`` behind the front-runner is
flight-recorded ``straggler`` (once per incident, rearmed on catch-up).
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..utils import monitor as _monitor
from ..utils import trace as _trace

__all__ = ["ElasticMember", "MembershipView", "ELASTIC_DIR_ENV",
           "read_heartbeats", "heartbeat_ages", "current_member"]

ELASTIC_DIR_ENV = "PDTPU_ELASTIC_DIR"

_m_deaths = _monitor.counter(
    "elastic.worker_deaths",
    "Workers evicted from the elastic membership after their heartbeat "
    "aged past dead_after_s (counted once per eviction, by the rank that "
    "won the eviction marker).")


def read_heartbeats(directory: str) -> Dict[int, dict]:
    """All parseable ``hb.<rank>.json`` bodies under ``directory``, keyed by
    rank — the raw per-rank {rank, pid, step, ts} records every membership
    consumer (liveness, the watchdog's cross-rank straggler attribution,
    the telemetry ``/healthz`` endpoint) joins on.  Unreadable or torn
    files are skipped (the writer is atomic, but the rank may be dead)."""
    out: Dict[int, dict] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for n in names:
        if not (n.startswith("hb.") and n.endswith(".json")):
            continue
        try:
            rank = int(n.split(".")[1])
            with open(os.path.join(directory, n)) as f:
                out[rank] = json.load(f)
        except (OSError, ValueError, IndexError):
            continue
    return out


def heartbeat_ages(directory: str,
                   now: Optional[float] = None) -> Dict[int, float]:
    """Seconds since each rank's last heartbeat write."""
    now = time.time() if now is None else now
    return {r: now - float(hb.get("ts", 0.0))
            for r, hb in read_heartbeats(directory).items()}


# the process's active member (set by start(), cleared by stop()) — the
# telemetry /healthz endpoint reports membership through this handle
_current: Optional["ElasticMember"] = None


def current_member() -> Optional["ElasticMember"]:
    return _current


@dataclass
class MembershipView:
    """One consistent read of the membership directory."""
    live: Tuple[int, ...]
    dead: Tuple[int, ...]        # stale heartbeat, not yet evicted
    evicted: Tuple[int, ...]
    steps: Dict[int, int] = field(default_factory=dict)

    @property
    def world_size(self) -> int:
        return len(self.live) + len(self.dead)

    @property
    def generation(self) -> int:
        """Bumps once per eviction — callers key mesh rebuilds on it."""
        return len(self.evicted)


class ElasticMember:
    """One rank's handle on the shared membership directory."""

    def __init__(self, directory: str, rank: int, world_size: int,
                 interval_s: float = 0.5, dead_after_s: float = 3.0,
                 straggler_steps: int = 0):
        self.dir = directory
        self.rank = int(rank)
        self.initial_world = int(world_size)
        self.interval_s = float(interval_s)
        self.dead_after_s = float(dead_after_s)
        self.straggler_steps = int(straggler_steps)
        os.makedirs(self.dir, exist_ok=True)
        self._step = 0
        self._t0 = time.time()   # grace anchor for ranks that never wrote
        self._lock = threading.Lock()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._seen_evicted: Set[int] = set()
        self._flagged_stragglers: Set[int] = set()

    @classmethod
    def from_env(cls, directory: Optional[str] = None,
                 world_size: Optional[int] = None,
                 **kwargs) -> "ElasticMember":
        """Build from the launcher contract: PDTPU_ELASTIC_DIR (exported by
        ``distributed.launch --elastic_dir``) plus PADDLE_TRAINER_ID /
        PADDLE_TRAINERS_NUM."""
        directory = directory or os.environ.get(ELASTIC_DIR_ENV)
        if not directory:
            raise ValueError(
                f"pass directory or set ${ELASTIC_DIR_ENV} "
                "(distributed.launch --elastic_dir exports it)")
        rank = int(os.environ.get("PADDLE_TRAINER_ID", 0))
        world = world_size or int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
        return cls(directory, rank, world, **kwargs)

    # -- heartbeat side ------------------------------------------------------
    def _hb_path(self, rank: int) -> str:
        return os.path.join(self.dir, f"hb.{rank}.json")

    def beat(self) -> None:
        """Atomically rewrite this rank's heartbeat file (tmp + replace —
        a reader never sees a torn write)."""
        with self._lock:
            step = self._step
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=f".hb{self.rank}")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"rank": self.rank, "pid": os.getpid(),
                           "step": step, "ts": time.time()}, f)
            os.replace(tmp, self._hb_path(self.rank))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def set_step(self, step: int) -> None:
        """Advance the progress marker the next heartbeat publishes (also
        beats immediately, so step-granular liveness needs no extra calls)."""
        with self._lock:
            self._step = int(step)
        self.beat()

    def start(self) -> "ElasticMember":
        global _current
        self.beat()
        self._running = True

        def loop():
            while self._running:
                try:
                    self.beat()
                except OSError:
                    pass  # a full/unreachable share must not kill training
                time.sleep(self.interval_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        _current = self
        return self

    def stop(self) -> None:
        global _current
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if _current is self:
            _current = None

    # -- observer side -------------------------------------------------------
    def _read_hb(self, rank: int) -> Optional[dict]:
        try:
            with open(self._hb_path(rank)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _evicted_ranks(self) -> Set[int]:
        out: Set[int] = set()
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for n in names:
            if n.startswith("evicted."):
                try:
                    out.add(int(n.split(".", 1)[1]))
                except ValueError:
                    continue
        return out

    def view(self) -> MembershipView:
        now = time.time()
        evicted = self._evicted_ranks()
        live: List[int] = []
        dead: List[int] = []
        steps: Dict[int, int] = {}
        for r in range(self.initial_world):
            if r in evicted:
                continue
            hb = self._read_hb(r)
            if hb is None:
                # never-written rank: dead only once the grace window (our
                # own start time) has passed — a slow-starting peer is not
                # a casualty
                (dead if now - self._t0 > self.dead_after_s
                 else live).append(r)
                continue
            steps[r] = int(hb.get("step", 0))
            age = now - float(hb.get("ts", 0.0))
            (dead if age > self.dead_after_s else live).append(r)
        return MembershipView(live=tuple(live), dead=tuple(dead),
                              evicted=tuple(sorted(evicted)), steps=steps)

    def world_size(self) -> int:
        """Current elastic world: initial world minus evictions."""
        return self.initial_world - len(self._evicted_ranks())

    def live_ranks(self) -> Tuple[int, ...]:
        return self.view().live

    def detect_and_evict(self) -> List[int]:
        """One round of the detect → record → evict protocol.  Returns the
        ranks newly seen as evicted by THIS member (whether this rank won
        the marker or another survivor did), so every caller reacts to the
        world change exactly once."""
        v = self.view()
        for r in v.dead:
            _trace.flight_recorder().record(
                "worker_dead", name=f"worker{r}", worker=r,
                dead_after_s=self.dead_after_s, detector=self.rank)
            marker = os.path.join(self.dir, f"evicted.{r}")
            try:
                fd = os.open(marker, os.O_WRONLY | os.O_CREAT | os.O_EXCL)
            except FileExistsError:
                continue  # another survivor won the eviction
            except OSError:
                continue
            with os.fdopen(fd, "w") as f:
                json.dump({"rank": r, "by": self.rank,
                           "ts": time.time()}, f)
            _m_deaths.inc()
            _trace.flight_recorder().record(
                "worker_evicted", name=f"worker{r}", worker=r,
                by=self.rank)
        newly = sorted(self._evicted_ranks() - self._seen_evicted)
        self._seen_evicted.update(newly)
        return newly

    def stragglers(self) -> List[int]:
        """Live ranks more than ``straggler_steps`` behind the front-runner
        (flight-recorded once per incident; rearmed when they catch up)."""
        if self.straggler_steps <= 0:
            return []
        v = self.view()
        if not v.steps:
            return []
        front = max(v.steps.values())
        lagging = [r for r in v.live
                   if front - v.steps.get(r, 0) > self.straggler_steps]
        for r in lagging:
            if r not in self._flagged_stragglers:
                self._flagged_stragglers.add(r)
                _trace.flight_recorder().record(
                    "straggler", name=f"worker{r}", worker=r,
                    step=v.steps.get(r, 0), front=front)
        self._flagged_stragglers.intersection_update(lagging)
        return lagging

    def record_resume(self, step: int, world: int) -> None:
        """Flight-record the resume that completes the detect → record →
        evict → resume chain, and mirror the new world into
        ``distributed.env`` so ``get_world_size()`` agrees with the mesh
        the caller rebuilt."""
        from ..distributed import env as _env

        _env.set_elastic_world(world)
        _trace.flight_recorder().record(
            "elastic_resume", name=f"rank{self.rank}", rank=self.rank,
            step=int(step), world=int(world))
