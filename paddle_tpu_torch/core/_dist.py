"""The process's rank and world size before ``distributed/`` is ported
(ROADMAP.md Queue 1 item 8): ``torch.distributed`` when its default group
is initialized, else the launcher's ``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM``, as ``paddle_tpu/distributed/env.py:29-42`` reads
``jax.process_index`` / ``process_count`` first and the env after."""
from __future__ import annotations

import os

import torch


def _initialized() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    if _initialized():
        return torch.distributed.get_rank()
    try:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
    except ValueError:
        return 0


def world_size() -> int:
    if _initialized():
        return torch.distributed.get_world_size()
    try:
        return int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1)
    except ValueError:
        return 1
