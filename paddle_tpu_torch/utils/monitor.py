"""Typed metrics (counterpart of paddle_tpu/utils/monitor.py).

Only what the ported paths record is copied: thread-safe ``Counter``,
``Gauge`` and ``Histogram`` metrics with optional labels, ``.value()`` and
the bucket-interpolated ``percentile`` estimator, and get-or-create
``counter`` / ``gauge`` / ``histogram`` on a process-wide default registry,
the read-time gauge (``Gauge.set_function`` / ``remove``, which the PS
server uses), and the reads the profiler's chrome export takes
(``samples``, ``MetricRegistry.get`` / ``metrics``).
Collection is gated by the ``metrics`` flag (``PDTPU_FLAGS_metrics``,
default on): with it off every instrumented path still runs but records
nothing.  Exporters, metric history and the SLO engine are not ported yet.

Metric names match ``^[a-z0-9_.]+$`` and keep the JAX package's names letter
for letter (``serve.ttft_ms``, ``serve.kv_prefix_hits``, ...).
"""
from __future__ import annotations

import math
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core import flags as _flags

__all__ = ["Counter", "Gauge", "Histogram", "MetricRegistry",
           "default_registry", "counter", "gauge", "histogram", "enabled",
           "TIME_MS_BUCKETS"]

_NAME_RE = re.compile(r"^[a-z0-9_.]+$")

# Bucket ladder for wall-time histograms in milliseconds.
TIME_MS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                   100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)


def enabled() -> bool:
    """True when metric collection is on (the ``metrics`` flag)."""
    return bool(_flags.get_flag("metrics"))


class Metric:
    """Base: a named family of samples keyed by label values.  Mutators are
    no-ops while the ``metrics`` flag is off; reads always work."""

    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"metric name {name!r} must match "
                             f"{_NAME_RE.pattern}")
        self.name = name
        self.description = description
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._cells: Dict[Tuple[str, ...], Any] = {}

    def _key(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        if tuple(sorted(labels)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def samples(self) -> List[Tuple[Dict[str, str], Any]]:
        """Snapshot [(labels, value)], safe to iterate while writers run."""
        with self._lock:
            items = list(self._cells.items())
        return [(dict(zip(self.labelnames, k)), v) for k, v in items]


class Counter(Metric):
    """Monotonically increasing count."""

    kind = "counter"

    def inc(self, value: float = 1, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name!r}: cannot inc by {value}")
        key = self._key(labels)
        if not enabled():
            return
        with self._lock:
            self._cells[key] = self._cells.get(key, 0) + value

    def value(self, **labels):
        with self._lock:
            return self._cells.get(self._key(labels), 0)


class Gauge(Metric):
    """Last-written value; optionally computed at read time through
    ``set_function`` (the callback gauge the PS server's heartbeat age
    uses)."""

    kind = "gauge"

    def __init__(self, name: str, description: str = "",
                 labelnames: Sequence[str] = ()):
        super().__init__(name, description, labelnames)
        self._functions: Dict[Tuple[str, ...], Callable[[], float]] = {}

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        if not enabled():
            return
        with self._lock:
            self._cells[key] = value

    def set_function(self, fn: Callable[[], float], **labels) -> None:
        """Register ``fn`` to produce this sample's value when it is read."""
        key = self._key(labels)
        with self._lock:
            self._functions[key] = fn

    def remove(self, **labels) -> None:
        """Drop the sample (and any read-time function) for ``labels``."""
        key = self._key(labels)
        with self._lock:
            self._cells.pop(key, None)
            self._functions.pop(key, None)

    def value(self, **labels):
        key = self._key(labels)
        with self._lock:
            fn = self._functions.get(key)
            if fn is None:
                return self._cells.get(key, 0)
        try:
            return fn()
        except Exception:
            return math.nan

    def samples(self) -> List[Tuple[Dict[str, str], Any]]:
        with self._lock:
            items = dict(self._cells)
            fns = list(self._functions.items())
        if fns and enabled():
            # evaluated outside the lock; a raising callback reads as nan
            for key, fn in fns:
                try:
                    items[key] = fn()
                except Exception:
                    items[key] = math.nan
        return [(dict(zip(self.labelnames, k)), v) for k, v in items.items()]


class _HistCell:
    __slots__ = ("count", "total", "mn", "mx", "bucket_counts")

    def __init__(self, nbuckets: int):
        self.count = 0
        self.total = 0.0
        self.mn = math.inf
        self.mx = -math.inf
        self.bucket_counts = [0] * nbuckets


class Histogram(Metric):
    """Bucketed distribution with count / sum / min / max."""

    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, description, labelnames)
        bounds = tuple(sorted(float(b) for b in (buckets or TIME_MS_BUCKETS)))
        if not bounds or not math.isinf(bounds[-1]):
            bounds = bounds + (math.inf,)
        self.buckets = bounds

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        if not enabled():
            return
        v = float(value)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = _HistCell(len(self.buckets))
            cell.count += 1
            cell.total += v
            cell.mn = min(cell.mn, v)
            cell.mx = max(cell.mx, v)
            for i, bound in enumerate(self.buckets):
                if v <= bound:
                    cell.bucket_counts[i] += 1
                    break

    def _cell_percentile(self, cell: _HistCell, q: float) -> float:
        """The q-th percentile from one cell's bucket counts: find the
        target rank's bucket and interpolate linearly inside it (the
        Prometheus ``histogram_quantile`` estimator), clamped to the
        observed [min, max]."""
        if cell.count == 0:
            return math.nan
        rank = (q / 100.0) * cell.count
        cum, lo = 0, 0.0
        for bound, n in zip(self.buckets, cell.bucket_counts):
            prev = cum
            cum += n
            if cum >= rank and n:
                hi = cell.mx if math.isinf(bound) else bound
                est = lo + (hi - lo) * ((rank - prev) / n)
                return min(max(est, cell.mn), cell.mx)
            if not math.isinf(bound):
                lo = bound
        return cell.mx

    def percentile(self, q: float, **labels) -> float:
        """The q-th percentile estimate of one labelled cell; nan when the
        cell was never observed."""
        if not 0 <= q <= 100:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        with self._lock:
            cell = self._cells.get(self._key(labels))
            if cell is None:
                return math.nan
            snap = _HistCell(len(self.buckets))
            snap.count, snap.total = cell.count, cell.total
            snap.mn, snap.mx = cell.mn, cell.mx
            snap.bucket_counts = list(cell.bucket_counts)
        return self._cell_percentile(snap, q)

    def count(self, **labels) -> int:
        with self._lock:
            cell = self._cells.get(self._key(labels))
            return cell.count if cell else 0


class MetricRegistry:
    """Named metrics with get-or-create registration: registering the same
    (name, type, labelnames) twice returns the same object."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.RLock()

    def _get_or_create(self, cls, name: str, description: str,
                       labelnames: Sequence[str], **kwargs) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind} "
                        f"with labels {m.labelnames}")
                return m
            m = cls(name, description, labelnames, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name: str, description: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, description, labelnames)

    def gauge(self, name: str, description: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, description, labelnames)

    def histogram(self, name: str, description: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, description, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def metrics(self) -> List[Metric]:
        """Every registered metric, by name."""
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def reset(self) -> None:
        """Zero every metric's samples; registrations stay."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            with m._lock:
                m._cells.clear()


_default = MetricRegistry()


def default_registry() -> MetricRegistry:
    return _default


def counter(name: str, description: str = "",
            labelnames: Sequence[str] = ()) -> Counter:
    return _default.counter(name, description, labelnames)


def gauge(name: str, description: str = "",
          labelnames: Sequence[str] = ()) -> Gauge:
    return _default.gauge(name, description, labelnames)


def histogram(name: str, description: str = "",
              labelnames: Sequence[str] = (),
              buckets: Optional[Sequence[float]] = None) -> Histogram:
    return _default.histogram(name, description, labelnames, buckets)
