"""Embedding lookup (counterpart of paddle_tpu/nn/functional/input.py)."""
from __future__ import annotations


def embedding(x, weight):
    return weight[x.long()]
