"""Metrics (counterpart of paddle_tpu.metric; ref:
python/paddle/metric/metrics.py — Metric ABC, Accuracy, Precision, Recall,
Auc; fluid/metrics.py).  Accumulation is host-side numpy."""
from .metrics import (Accuracy, Auc, ChunkEvaluator, DetectionMAP,
                      Metric, Precision, Recall)

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc",
           "ChunkEvaluator", "DetectionMAP"]
