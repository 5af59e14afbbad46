"""Elastic fault-tolerant training (counterpart of paddle_tpu/elastic/;
ref: paddle.distributed.fleet elastic + the checkpoint saver; PAPERS.md
arxiv 2112.02752 "End-to-end Adaptive Distributed Training on
PaddlePaddle").

Three composable pieces:

* :mod:`~paddle_tpu_torch.elastic.checkpoint` — sharded,
  resharding-capable manifest checkpoints written and read by every rank
  (save on one mesh shape, restore on another; byte-compatible with the
  JAX package's);
* :mod:`~paddle_tpu_torch.elastic.membership` — heartbeat liveness,
  eviction, and the detect → record → evict → resume protocol;
* :mod:`~paddle_tpu_torch.elastic.failover` — PS-mode hot standby
  promotion from durable table snapshots.

Importing this package registers the ``elastic.*`` metric family
(checkpoint_ms, restore_ms, resharded_leaves, worker_deaths, failovers).
"""
from . import checkpoint, failover, membership  # noqa: F401
from .checkpoint import (  # noqa: F401
    CheckpointError,
    ElasticCheckpoint,
    latest_step,
    load_manifest,
    restore_checkpoint,
    restore_model,
    save_checkpoint,
)
from .failover import (  # noqa: F401
    SnapshotError,
    StandbyServer,
    TableSnapshotter,
    load_table_snapshot,
    save_table_snapshot,
)
from .membership import ELASTIC_DIR_ENV, ElasticMember, MembershipView  # noqa: F401

__all__ = [
    "CheckpointError", "ElasticCheckpoint", "latest_step", "load_manifest",
    "restore_checkpoint", "restore_model", "save_checkpoint",
    "SnapshotError", "StandbyServer", "TableSnapshotter",
    "load_table_snapshot", "save_table_snapshot",
    "ELASTIC_DIR_ENV", "ElasticMember", "MembershipView",
]
