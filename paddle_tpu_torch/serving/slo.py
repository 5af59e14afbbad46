"""Admission errors and the ``serve.*`` metrics the decode paths record
(counterpart of paddle_tpu/serving/slo.py).

Copied: ``AdmissionError``, ``QuotaExceededError`` and the ``LOAD_SHED``,
``REQUEST_MS`` and ``TTFT_MS`` metrics, under the JAX package's names.
``SLOPolicy`` (projected-p99 admission) waits for the serving frontend.
"""
from __future__ import annotations

from ..core.errors import ResourceExhaustedError
from ..utils import monitor as _monitor

__all__ = ["AdmissionError", "QuotaExceededError", "TTFT_MS", "REQUEST_MS",
           "LOAD_SHED"]


class AdmissionError(ResourceExhaustedError):
    """A request was refused at admission time (load shed); nothing was
    executed.  Clients should back off and retry."""


class QuotaExceededError(AdmissionError):
    """Per-tenant in-flight request quota exhausted."""


TTFT_MS = _monitor.histogram(
    "serve.ttft_ms", "Time to first result activity (ms): submit -> first "
    "generated token on the decode paths.")
REQUEST_MS = _monitor.histogram(
    "serve.request_ms", "End-to-end request latency (ms): submit -> the "
    "sequence retired, labeled by tenant and shape bucket ('decode' for "
    "decode streams).", labelnames=("tenant", "bucket"))
LOAD_SHED = _monitor.counter(
    "serve.load_shed", "Requests refused at admission (typed "
    "AdmissionError), by reason.", labelnames=("reason",))
