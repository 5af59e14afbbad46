"""Distributed tracing + flight recorder (counterpart of
paddle_tpu/utils/trace.py).

Reference parity: the reference correlates host `RecordEvent` trees with
device activity per process and merges them offline (tools/timeline.py over
CUPTI/profiler protos) — but it never correlates *across* processes: each
trainer/pserver timeline is an island and a dead worker leaves only an
exit code.

The JAX package's design, kept as it is: a W3C-traceparent-style context
layer on top of the native event store (core/native.py).

* ``SpanContext`` — (trace_id, span_id, parent_id) with thread-local
  current-span tracking.  One job-level trace_id comes from
  ``PDTPU_TRACE_ID`` when a launcher exports it, so spans from all ranks
  share one trace.
* ``span(name, **attrs)`` — context manager that nests under
  ``profiler.RecordEvent`` (spans land in the native event store and come
  out in chrome traces / summaries) and logs begin/end into the flight
  recorder with the span's ids and attributes.
* ``inject(carrier)`` / ``extract(carrier)`` — propagate the current
  context across process boundaries.
* ``FlightRecorder`` — bounded ring of the last N structured events
  (``flight_recorder_size`` flag).  ``arm_postmortem`` hooks
  ``sys.excepthook`` and SIGTERM so a dying rank dumps the ring to JSON —
  the post-mortem a crashed worker leaves behind.
* ``arm_from_env`` — with ``PDTPU_TRACE_DIR`` set: enables the profiler,
  arms the post-mortem, and atexit-dumps the per-rank chrome trace.  The
  JAX package calls it at import inside launch workers; importing the
  port starts nothing, so a worker of the port's launcher
  (``distributed/launch.py``, which exports the directory) arms it
  itself.

A rank is ``torch.distributed``'s when its default group is initialized,
else ``PADDLE_TRAINER_ID`` (``distributed/env.py``).
"""
from __future__ import annotations

import atexit
import json
import os
import re
import signal
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..distributed import env as _env
from ..core import flags as _flags
from . import profiler as _profiler

__all__ = [
    "SpanContext", "Span", "span", "current_span", "current_context",
    "inject", "extract", "job_trace_id", "FlightRecorder", "flight_recorder",
    "arm_postmortem", "arm_from_env", "register_postmortem_info",
    "TRACE_ID_ENV", "TRACE_DIR_ENV",
]

TRACE_ID_ENV = "PDTPU_TRACE_ID"
TRACE_DIR_ENV = "PDTPU_TRACE_DIR"

# version 00, 16-byte trace id, 8-byte span id, flags (sampled)
_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def _rand_hex(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


_job_trace_id_cached: Optional[str] = None
_job_lock = threading.Lock()


def job_trace_id() -> str:
    """The process's job-level trace id: ``PDTPU_TRACE_ID`` when a
    launcher exports it (every rank shares it), else minted once per
    process."""
    global _job_trace_id_cached
    if _job_trace_id_cached is None:
        with _job_lock:
            if _job_trace_id_cached is None:
                env = os.environ.get(TRACE_ID_ENV, "")
                _job_trace_id_cached = (
                    env if re.fullmatch(r"[0-9a-f]{32}", env)
                    else _rand_hex(16))
    return _job_trace_id_cached


def _rank() -> int:
    return _env.get_rank()


class SpanContext:
    """Immutable (trace_id, span_id, parent_id) triple, W3C-trace-context
    shaped: 32-hex trace id shared by the whole job, 16-hex span id."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: Optional[str] = None,
                 span_id: Optional[str] = None,
                 parent_id: Optional[str] = None):
        self.trace_id = trace_id or job_trace_id()
        self.span_id = span_id or _rand_hex(8)
        self.parent_id = parent_id

    def child(self) -> "SpanContext":
        return SpanContext(self.trace_id, _rand_hex(8), self.span_id)

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_traceparent(cls, value: str) -> "Optional[SpanContext]":
        m = _TRACEPARENT_RE.match(str(value).strip().lower())
        if m is None:
            return None
        return cls(trace_id=m.group(1), span_id=m.group(2))

    def __repr__(self):
        return (f"SpanContext(trace_id={self.trace_id!r}, "
                f"span_id={self.span_id!r}, parent_id={self.parent_id!r})")

    def __eq__(self, other):
        return (isinstance(other, SpanContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id
                and self.parent_id == other.parent_id)


_tls = threading.local()


def _span_stack() -> List["Span"]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_span() -> "Optional[Span]":
    st = _span_stack()
    return st[-1] if st else None


def current_context() -> Optional[SpanContext]:
    sp = current_span()
    return sp.context if sp is not None else None


def inject(carrier: Dict[str, str]) -> Dict[str, str]:
    """Write the current context into `carrier` (W3C ``traceparent`` key).
    No current span → carrier untouched.  Returns the carrier."""
    ctx = current_context()
    if ctx is not None:
        carrier["traceparent"] = ctx.to_traceparent()
    return carrier


def extract(carrier: Optional[Dict[str, str]]) -> Optional[SpanContext]:
    """Read a context out of `carrier`; None on absent/malformed."""
    if not carrier:
        return None
    tp = carrier.get("traceparent")
    if not tp:
        return None
    return SpanContext.from_traceparent(tp)


class Span:
    """Scoped span: nests under the thread's current span (or under
    ``parent`` when given — how a PS server parents its handler span under
    the calling trainer's context), pushes a ``profiler.RecordEvent`` so
    the span lands in the native event store, and records begin/end into
    the flight recorder.

    ::

        with trace.span("executor::run", program=7) as sp:
            ...                       # sp.context carries the ids
            sp.set_attr("ops", 42)
    """

    def __init__(self, name: str, parent: Optional[SpanContext] = None,
                 **attrs: Any):
        self.name = str(name)
        self._parent = parent
        self.attrs = dict(attrs)
        self.context: Optional[SpanContext] = None
        self._event: Optional[_profiler.RecordEvent] = None
        self._t0 = 0.0

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        base = self._parent if self._parent is not None else current_context()
        self.context = base.child() if base is not None else SpanContext()
        self._event = _profiler.RecordEvent(self.name)
        self._event.__enter__()
        _span_stack().append(self)
        self._t0 = time.perf_counter()
        flight_recorder().record("span_begin", name=self.name,
                                 ctx=self.context, **self.attrs)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur_ms = (time.perf_counter() - self._t0) * 1000.0
        fields = dict(self.attrs)
        fields["dur_ms"] = round(dur_ms, 3)
        if exc_type is not None:
            fields["error"] = exc_type.__name__
        flight_recorder().record("span_end", name=self.name,
                                 ctx=self.context, **fields)
        st = _span_stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:          # mispaired exit: drop without corrupting
            st.remove(self)
        self._event.__exit__(exc_type, exc, tb)
        return False

    def __call__(self, fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with Span(self.name, **self.attrs):
                return fn(*args, **kwargs)
        return wrapper


span = Span


# ---------------------------------------------------------------------------
# Flight recorder: bounded ring of structured events, dumped post-mortem.
# ---------------------------------------------------------------------------
def _json_safe(value: Any) -> Any:
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _json_safe(v) for k, v in value.items()}
    return repr(value)


class FlightRecorder:
    """Ring buffer of the last N structured events (``flight_recorder_size``
    flag).  Appends are lock-free (deque with maxlen); every event is stamped
    with wall time, rank, thread, and the ids of the event's span context
    (explicit ``ctx=`` or the thread's current span)."""

    def __init__(self, size: Optional[int] = None):
        if size is None:
            size = int(_flags.get_flag("flight_recorder_size"))
        self._events: "deque" = deque(maxlen=max(1, int(size)))
        self._seq = 0
        self._seq_lock = threading.Lock()

    @property
    def size(self) -> int:
        return self._events.maxlen

    @property
    def last_seq(self) -> int:
        """Monotonic count of events ever recorded (ring evictions
        included) — cursor anchor for :meth:`events_since`."""
        return self._seq

    def events_since(self, seq: int) -> List[Dict[str, Any]]:
        """Events with a ``seq`` stamp strictly greater than ``seq`` still
        present in the ring — the incremental read the watchdog and the
        telemetry ``/spans`` endpoint poll with (events evicted between
        polls are simply gone; the ring is a window, not a log)."""
        return [e for e in self._events if e.get("seq", 0) > seq]

    def read_since(self, seq: int) -> Tuple[List[Dict[str, Any]], bool]:
        """:meth:`events_since` plus an explicit truncation verdict: True
        when the ring has already evicted (or :meth:`clear`-ed) events the
        ``seq`` cursor was entitled to, so pollers of ``/spans`` and
        ``/ledger`` can tell "nothing happened" apart from "you fell
        behind the window" instead of silently losing events."""
        events = list(self._events)
        if self._seq <= seq:
            truncated = False          # cursor is current (or from the
            #                            future after a restart) — nothing
            #                            was missed
        elif not events:
            truncated = True           # events were recorded past the
            #                            cursor but none survive (cleared
            #                            ring, or size-0 window)
        else:
            oldest = min(e.get("seq", 0) for e in events)
            truncated = oldest > seq + 1
        return [e for e in events if e.get("seq", 0) > seq], truncated

    def record(self, kind: str, name: str = "",
               ctx: Optional[SpanContext] = None, **fields: Any) -> None:
        if ctx is None:
            ctx = current_context()
        with self._seq_lock:
            self._seq += 1
            seq = self._seq
        ev: Dict[str, Any] = {
            "seq": seq,
            "ts": time.time(),
            "kind": str(kind),
            "name": str(name),
            "rank": _rank(),
            "thread": threading.current_thread().name,
        }
        if ctx is not None:
            ev["trace_id"] = ctx.trace_id
            ev["span_id"] = ctx.span_id
            if ctx.parent_id:
                ev["parent_id"] = ctx.parent_id
        for k, v in fields.items():
            ev[k] = _json_safe(v)
        self._events.append(ev)

    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()

    def to_json(self) -> Dict[str, Any]:
        return {
            "meta": {
                "rank": _rank(),
                "pid": os.getpid(),
                "trace_id": job_trace_id(),
                "size": self.size,
                "dumped_at": time.time(),
            },
            "events": self.events(),
        }

    def dump(self, path: str) -> int:
        """Write the ring as JSON; returns the event count.  Written via a
        temp file + rename so a dump racing a second signal never leaves a
        truncated file."""
        with _pm_info_lock:
            providers = list(_pm_info.items())
        for kind, provider in providers:
            try:
                info = provider()
            except Exception:
                continue
            if info is not None:
                self.record(kind, **{"info": info})
        doc = self.to_json()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return len(doc["events"])


# -- post-mortem info providers ---------------------------------------------
# Modules register a zero-arg callable keyed by event kind; dump() calls each
# one and records its (JSON-safe) snapshot into the ring just before writing,
# so a crash dump carries live state the ring itself never saw.
_pm_info: Dict[str, Callable[[], Any]] = {}
_pm_info_lock = threading.Lock()


def register_postmortem_info(kind: str, provider: Callable[[], Any]) -> None:
    """Attach `provider`'s snapshot to every flight-recorder dump as one
    event of `kind`.  The provider returns a JSON-safe dict (or None to
    skip); it must not raise — but a dump is a last-gasp path, so failures
    are swallowed there regardless."""
    with _pm_info_lock:
        _pm_info[str(kind)] = provider


_flight: Optional[FlightRecorder] = None
_flight_lock = threading.Lock()


def flight_recorder() -> FlightRecorder:
    """The process-wide flight recorder (created on first use so the
    ``flight_recorder_size`` flag/env is honored)."""
    global _flight
    if _flight is None:
        with _flight_lock:
            if _flight is None:
                _flight = FlightRecorder()
    return _flight


# ---------------------------------------------------------------------------
# Post-mortem arming: excepthook + SIGTERM dump, launch-worker bootstrap.
# ---------------------------------------------------------------------------
_armed_paths: List[str] = []


def arm_postmortem(path: str, signals=(signal.SIGTERM,)) -> None:
    """Dump the flight recorder to `path` when the process dies abnormally:
    an uncaught exception (``sys.excepthook`` — the exception itself is
    recorded first) or a termination signal (the launcher's abort path).
    Prior hooks/handlers are chained, not replaced."""
    _armed_paths.append(path)
    prev_hook = sys.excepthook

    def hook(exc_type, exc, tb):
        try:
            flight_recorder().record("exception", name=exc_type.__name__,
                                     message=str(exc)[:500])
            flight_recorder().dump(path)
        except OSError:
            pass
        prev_hook(exc_type, exc, tb)

    sys.excepthook = hook

    for sig in signals:
        try:
            prev = signal.getsignal(sig)

            def handler(signum, frame, _prev=prev):
                try:
                    flight_recorder().record(
                        "signal", name=signal.Signals(signum).name)
                    flight_recorder().dump(path)
                except OSError:
                    pass
                if callable(_prev):
                    _prev(signum, frame)
                else:
                    # default disposition: exit like the signal killed us
                    # (SystemExit runs atexit, so the chrome trace dumps too)
                    sys.exit(128 + signum)

            signal.signal(sig, handler)
        except (ValueError, OSError):
            pass  # not the main thread / unsupported signal: excepthook only


_armed_from_env = False


def arm_from_env() -> Optional[str]:
    """Launch-worker bootstrap (idempotent) when ``PDTPU_TRACE_DIR`` is
    set: start the host profiler, arm the post-mortem dump to
    ``flight.rank<r>.json``, and register an atexit export of the per-rank
    chrome trace ``trace.rank<r>.json``.  Returns the trace dir (or None
    when the env var is unset)."""
    global _armed_from_env
    trace_dir = os.environ.get(TRACE_DIR_ENV)
    if not trace_dir or _armed_from_env:
        return trace_dir or None
    _armed_from_env = True
    rank = _rank()
    os.makedirs(trace_dir, exist_ok=True)
    trace_path = os.path.join(trace_dir, f"trace.rank{rank}.json")
    flight_path = os.path.join(trace_dir, f"flight.rank{rank}.json")
    _profiler.start_profiler()
    arm_postmortem(flight_path)

    def _dump_at_exit():
        try:
            _profiler.export_chrome_tracing(trace_path)
        except Exception:
            pass
        try:
            flight_recorder().dump(flight_path)
        except OSError:
            pass

    atexit.register(_dump_at_exit)
    flight_recorder().record("worker_start", name=f"rank{rank}",
                             trace_dir=trace_dir)
    return trace_dir
