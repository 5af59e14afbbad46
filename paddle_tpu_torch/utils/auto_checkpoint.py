"""Auto-checkpoint: elastic epoch-level resume (counterpart of
paddle_tpu/utils/auto_checkpoint.py).

Reference parity: fluid/incubate/checkpoint/auto_checkpoint.py —
`AutoCheckpointChecker` (:71) reading the job environment,
`train_epoch_range` (the generator that wraps the epoch loop so a relaunched
job fast-forwards to the last saved epoch), and checkpoint_saver.py over the
fleet fs client.  HDFS gives way to a local/NFS directory; the state is
saved with utils.checkpoint (the npz + tree layout), or, with a
``ShardingPlan``, in the elastic manifest format (elastic/checkpoint.py)
so a relaunched job can resume on a different mesh.

Usage::

    acp = AutoCheckpoint("ckpt_dir", job_id="exp1")
    for epoch in acp.train_epoch_range(10):
        state = train_one_epoch(state)
        acp.save(epoch, state)          # atomic per-epoch snapshot
    # on restart, train_epoch_range resumes after the last saved epoch and
    # acp.restored_state holds the snapshot to continue from.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Iterator, Optional

from . import checkpoint as _ckpt

__all__ = ["AutoCheckpoint", "train_epoch_range"]

_ENV_JOB_ID = "PDTPU_JOB_ID"  # ref: the cloud job-id env the checker reads
_ENV_CKPT_DIR = "PDTPU_CHECKPOINT_DIR"


def _is_flat_array_dict(state: Any) -> bool:
    return isinstance(state, dict) and all(
        hasattr(v, "shape") and hasattr(v, "dtype") for v in state.values())


class AutoCheckpoint:
    """Epoch-granular checkpoint/resume manager."""

    def __init__(self, ckpt_dir: Optional[str] = None,
                 job_id: Optional[str] = None, keep_last: int = 2,
                 plan=None):
        self.ckpt_dir = ckpt_dir or os.environ.get(_ENV_CKPT_DIR)
        if not self.ckpt_dir:
            raise ValueError("pass ckpt_dir or set $" + _ENV_CKPT_DIR)
        self.job_id = job_id or os.environ.get(_ENV_JOB_ID, "default")
        self.keep_last = keep_last
        # with a ShardingPlan, flat dict states are written in the elastic
        # manifest format (elastic/checkpoint.py) so a relaunched job can
        # resume on a different mesh; other pytrees and plan=None keep the
        # legacy npz+tree layout, and load() reads either
        self.plan = plan
        self.root = os.path.join(self.ckpt_dir, self.job_id)
        os.makedirs(self.root, exist_ok=True)
        self.restored_state: Any = None
        self._restored_epoch = self._read_meta()

    # -- metadata -----------------------------------------------------------
    def _meta_path(self) -> str:
        return os.path.join(self.root, "meta.json")

    def _read_meta(self) -> int:
        try:
            with open(self._meta_path()) as f:
                return int(json.load(f)["last_epoch"])
        except (OSError, ValueError, KeyError):
            return -1

    def _write_meta(self, epoch: int) -> None:
        # write-then-rename: a crash mid-save never corrupts the pointer
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".meta")
        with os.fdopen(fd, "w") as f:
            json.dump({"last_epoch": epoch, "job_id": self.job_id}, f)
        os.replace(tmp, self._meta_path())

    # -- save/restore -------------------------------------------------------
    def _epoch_dir(self, epoch: int) -> str:
        return os.path.join(self.root, f"epoch_{epoch}")

    def save(self, epoch: int, state: Any) -> None:
        """Atomic snapshot: state written to a temp dir, renamed into place,
        then the meta pointer advances — the order a crash can't corrupt."""
        tmp = self._epoch_dir(epoch) + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        if self.plan is not None and _is_flat_array_dict(state):
            from ..elastic import checkpoint as _eckpt

            _eckpt.write_state(os.path.join(tmp, "state"), state,
                               step=epoch, plan=self.plan)
        else:
            _ckpt.save(state, os.path.join(tmp, "state"))
        final = self._epoch_dir(epoch)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._write_meta(epoch)
        self._gc(epoch)

    def _gc(self, newest: int) -> None:
        # saves are sequential, so at most the one dir that just fell out of
        # the keep window exists; stop at the first missing dir (O(1) per
        # save instead of scanning to epoch 0 — matters on NFS)
        for e in range(newest - self.keep_last, -1, -1):
            d = self._epoch_dir(e)
            if not os.path.exists(d):
                break
            shutil.rmtree(d)

    def load(self, epoch: int) -> Any:
        path = os.path.join(self._epoch_dir(epoch), "state")
        if self.plan is not None and os.path.isdir(path):
            from ..elastic import checkpoint as _eckpt

            if os.path.exists(os.path.join(path, _eckpt.MANIFEST_NAME)):
                state, _meta = _eckpt.read_state(path, plan=self.plan)
                return state
        return _ckpt.load(path)

    @property
    def last_epoch(self) -> int:
        return self._restored_epoch

    # -- the epoch range ----------------------------------------------------
    def train_epoch_range(self, max_epoch: int,
                          start: int = 0) -> Iterator[int]:
        """Yield epochs [start, max_epoch), fast-forwarding past epochs a
        previous incarnation of this job already saved (ref
        auto_checkpoint.py train_epoch_range)."""
        first = start
        if self._restored_epoch >= start:
            first = self._restored_epoch + 1
            try:
                self.restored_state = self.load(self._restored_epoch)
            except OSError as e:
                # fast-forwarding without the state would silently resume
                # later epochs from uninitialized weights — fail loudly
                raise RuntimeError(
                    f"meta.json points at epoch {self._restored_epoch} but "
                    f"its snapshot could not be loaded ({e}); remove "
                    f"{self.root} to restart from scratch") from e
        for epoch in range(first, max_epoch):
            yield epoch


def train_epoch_range(max_epoch: int, acp: AutoCheckpoint) -> Iterator[int]:
    """Free-function form of the reference API; takes the AutoCheckpoint the
    caller saves through (constructing one internally would leave the caller
    no handle for .save()/.restored_state, making resume impossible)."""
    yield from acp.train_epoch_range(max_epoch)
