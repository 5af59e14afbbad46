"""PS-mode hot failover: durable table snapshots + standby promotion
(counterpart of paddle_tpu/elastic/failover.py).

Reference parity: the fleet PS HA story — pserver checkpoint/load
(ListenAndServOp's checkpoint notify + SaveOp on the pserver side) plus
heart_beat_monitor.h's liveness scan, composed into the promote-on-death
pattern of classic parameter-server deployments.

Only the host-side sparse table needs failover (dense state rides
elastic/checkpoint.py); the wire is ps_server.py's framed TCP.  The
snapshot file is the JAX package's byte for byte, so either package's
standby replays the other's snapshots.
Three pieces:

* ``save_table_snapshot``/``load_table_snapshot`` — one self-verifying
  file (``PDES`` magic + schema + SHA-256 + npz payload, the
  compile_cache.py blob discipline) written atomically, so the standby
  always finds either the previous durable snapshot or the new one;
* ``TableSnapshotter`` — a background thread snapshotting a live primary
  table every ``every_s``;
* ``StandbyServer`` — probes the primary endpoint; after ``max_missed``
  consecutive probe failures it flight-records ``failover``, bumps
  ``elastic.failovers``, replays the last durable snapshot into its own
  table, and starts serving on its (pre-announced) port.  Clients point a
  fresh ``RemoteSparseTable`` at ``standby.endpoint`` — the reference's
  communicator rescue path, made explicit.
"""
from __future__ import annotations

import hashlib
import io
import os
import socket
import struct
import tempfile
import threading
import time
from typing import Dict, Optional

import numpy as np

from ..utils import monitor as _monitor
from ..utils import trace as _trace

__all__ = ["save_table_snapshot", "load_table_snapshot", "SnapshotError",
           "TableSnapshotter", "StandbyServer", "replan_for_survivors"]

_MAGIC = b"PDES"
_SCHEMA = 1

_m_failovers = _monitor.counter(
    "elastic.failovers",
    "Standby PS promotions: the primary missed max_missed consecutive "
    "probes and the standby started serving from the last durable table "
    "snapshot.")


class SnapshotError(RuntimeError):
    """A table snapshot failed integrity verification."""


def save_table_snapshot(table, path: str) -> str:
    """Atomically persist ``table.state_dict()`` as one self-verifying
    blob.  Safe to call on a live table (state_dict snapshots under the
    table's own locking)."""
    state = table.state_dict()
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in state.items()})
    payload = buf.getvalue()
    blob = (_MAGIC + struct.pack("<I", _SCHEMA)
            + hashlib.sha256(payload).digest() + payload)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".snap")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load_table_snapshot(path: str) -> Dict[str, np.ndarray]:
    """Digest-verified snapshot load; raises ``SnapshotError`` on any
    corruption/skew — replaying wrong rows is worse than not promoting."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise SnapshotError(f"unreadable snapshot {path}: {e}") from e
    if len(data) < 4 + 4 + 32 or data[:4] != _MAGIC:
        raise SnapshotError(f"bad snapshot magic: {path}")
    (schema,) = struct.unpack("<I", data[4:8])
    if schema != _SCHEMA:
        raise SnapshotError(f"snapshot schema {schema} != {_SCHEMA}: {path}")
    digest, payload = data[8:40], data[40:]
    if hashlib.sha256(payload).digest() != digest:
        _trace.flight_recorder().record(
            "snapshot_corrupt", name=os.path.basename(path), path=path)
        raise SnapshotError(f"snapshot digest mismatch: {path}")
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class TableSnapshotter:
    """Background durable-snapshot loop over a live primary table."""

    def __init__(self, table, path: str, every_s: float = 1.0):
        self.table = table
        self.path = path
        self.every_s = float(every_s)
        self._running = False
        self._thread: Optional[threading.Thread] = None

    def snapshot_now(self) -> str:
        return save_table_snapshot(self.table, self.path)

    def start(self) -> "TableSnapshotter":
        self.snapshot_now()
        self._running = True

        def loop():
            while self._running:
                time.sleep(self.every_s)
                if not self._running:
                    return
                try:
                    self.snapshot_now()
                except OSError:
                    pass  # a full disk must not kill the primary

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _probe(endpoint: str, timeout_s: float = 1.0) -> bool:
    """One-shot liveness probe: a fresh connection + _OP_NUM_ROWS round
    trip (no _Conn — its reconnect/backoff retries would mask exactly the
    deadness this is measuring)."""
    from ..distributed import ps_server as _pss

    host, port = endpoint.rsplit(":", 1)
    try:
        with socket.create_connection((host, int(port)),
                                      timeout=timeout_s) as s:
            s.settimeout(timeout_s)
            _pss._send_msg(s, _pss._OP_NUM_ROWS, [])
            op, _arrays, _tp = _pss._recv_msg(s)
            return op == _pss._OP_OK
    except (OSError, ConnectionError, struct.error):
        return False


class StandbyServer:
    """Hot standby for a PSServer primary.

    Owns an (empty) table of the same geometry; monitors the primary; on
    sustained probe failure, replays the last durable snapshot into its
    table and starts serving.  ``port`` may be fixed up front so clients
    know the failover endpoint before it is live."""

    def __init__(self, table, snapshot_path: str, primary_endpoint: str,
                 probe_interval_s: float = 0.5, max_missed: int = 3,
                 host: str = "127.0.0.1", port: int = 0):
        self.table = table
        self.snapshot_path = snapshot_path
        self.primary_endpoint = primary_endpoint
        self.probe_interval_s = float(probe_interval_s)
        self.max_missed = int(max_missed)
        self._host = host
        self._port = port
        self.server = None
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._promoted = threading.Event()

    @property
    def promoted(self) -> bool:
        return self._promoted.is_set()

    @property
    def endpoint(self) -> Optional[str]:
        return self.server.endpoint if self.server is not None else None

    def wait_promoted(self, timeout: Optional[float] = None) -> bool:
        return self._promoted.wait(timeout)

    def promote(self) -> "StandbyServer":
        """Replay the last durable snapshot and start serving.  Called by
        the monitor loop on primary loss; callable directly for a manual
        (planned) failover."""
        from ..distributed.ps_server import PSServer

        replayed = 0
        try:
            snap = load_table_snapshot(self.snapshot_path)
            self.table.load_state_dict(snap)
            replayed = int(len(snap.get("ids", ())))
        except SnapshotError as e:
            # no durable snapshot yet: promote empty (first-write wins) but
            # leave the reason in the flight dump
            _trace.flight_recorder().record(
                "failover_snapshot_missing", name="ps_standby",
                error=repr(e))
        self.server = PSServer(self.table, host=self._host,
                               port=self._port).start()
        _m_failovers.inc()
        _trace.flight_recorder().record(
            "failover", name="ps_primary", primary=self.primary_endpoint,
            standby=self.server.endpoint, replayed_rows=replayed)
        self._promoted.set()
        return self

    def start(self) -> "StandbyServer":
        self._running = True

        def loop():
            missed = 0
            while self._running and not self.promoted:
                if _probe(self.primary_endpoint,
                          timeout_s=max(self.probe_interval_s, 0.2)):
                    missed = 0
                else:
                    missed += 1
                    _trace.flight_recorder().record(
                        "ps_probe_missed", name="ps_primary",
                        primary=self.primary_endpoint, missed=missed)
                    if missed >= self.max_missed:
                        self.promote()
                        return
                time.sleep(self.probe_interval_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.server is not None:
            self.server.stop()


def replan_for_survivors(program, world: int, devices=None,
                         feed_shapes=None, fetch_names=(),
                         reason: str = "eviction"):
    """Re-derive the sharding plan for the post-eviction world through the
    autoplan cost-model search (the JAX package's bridge to
    parallel/autoplan.py).  The port has no plan search yet: it comes with
    the static-program half of the parallel engine, ROADMAP.md Queue 1
    item 9b.  Until then survivors restore onto a plan they build
    themselves (or with no plan)."""
    raise NotImplementedError(
        "replan_for_survivors needs the autoplan search (parallel/"
        "autoplan.py), ROADMAP.md Queue 1 item 9b; restore the checkpoint "
        "onto a ShardingPlan built for the surviving world instead")
