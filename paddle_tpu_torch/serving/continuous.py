"""Decode handles (counterpart of paddle_tpu/serving/continuous.py).

Only ``DecodeHandle``, which the paged decoder hands out, is ported.
``ContinuousBatcher`` and ``make_toy_lm`` have no kernel and wait for a
later slice.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

__all__ = ["DecodeHandle"]


class DecodeHandle:
    """One sequence's view of a decoder: fills ``tokens`` as the decode
    progresses; ``done`` flips when it retires (finished or evicted)."""

    def __init__(self, prompt: Sequence[int], max_new_tokens: int):
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.tokens: List[int] = []
        self.done = False
        self.evicted = False
        self.slot: Optional[int] = None
        self._t_submit = time.perf_counter()
        self._ttft_recorded = False
