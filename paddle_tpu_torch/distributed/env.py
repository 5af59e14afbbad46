"""Process environment (counterpart of paddle_tpu/distributed/env.py; ref
dygraph/parallel.py:62 ``ParallelEnv`` and fleet's env-var role maker).

A rank and a world size come from ``torch.distributed``'s default group
when it is initialized, else from the launcher's ``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM`` (``distributed/launch.py``), in the order the JAX
package reads ``jax.process_index`` / ``process_count`` and then the env.
In the port a process is one device, so the rank is also the device's
place in the job.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

_data_axis_stack = []

# elastic world override: after an eviction the surviving job's logical
# world is smaller than the launcher said at start-up; the elastic
# membership (ROADMAP.md item 8c) sets it so every world-size consumer
# agrees with the rebuilt mesh.  None = no override.
_elastic_world: Optional[int] = None


def set_elastic_world(world: Optional[int]) -> None:
    """Override (or clear, with None) the process's logical world size
    after an elastic membership change."""
    global _elastic_world
    _elastic_world = None if world is None else int(world)


def _initialized() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    if _initialized():
        return torch.distributed.get_rank()
    return int(os.environ.get("PADDLE_TRAINER_ID", 0))


def get_world_size() -> int:
    if _elastic_world is not None:
        return _elastic_world
    if _initialized():
        return torch.distributed.get_world_size()
    return int(os.environ.get("PADDLE_TRAINERS_NUM", 1))


def current_data_axis() -> Optional[str]:
    """The mesh dim data-parallel collectives reduce over when a caller
    named one with ``data_axis_scope``; None outside any scope."""
    return _data_axis_stack[-1] if _data_axis_stack else None


class _DataAxisScope:
    def __init__(self, axis: str):
        self.axis = axis

    def __enter__(self):
        _data_axis_stack.append(self.axis)
        return self

    def __exit__(self, *exc):
        _data_axis_stack.pop()
        return False


def data_axis_scope(axis: str) -> _DataAxisScope:
    return _DataAxisScope(axis)


class ParallelEnv:
    """ref: dygraph/parallel.py:62."""

    @property
    def rank(self):
        return get_rank()

    @property
    def local_rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def nranks(self):
        return get_world_size()

    @property
    def device_id(self):
        return 0
