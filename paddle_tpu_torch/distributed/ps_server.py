"""Cross-process parameter-server transport (counterpart of
paddle_tpu/distributed/ps_server.py).

Reference parity: the PS RPC runtime — `RPCClient`/`RPCServer` over gRPC
with zero-copy LoDTensor serialization
(operators/distributed/grpc/grpc_client.cc, sendrecvop_utils.cc,
send_recv.proto.in), request handlers for Send/Get
(request_handler_impl.cc), and `ListenAndServOp`'s serve loop
(operators/distributed_ops/listen_and_serv_op.cc).

Only the host sparse table (``ps.SparseTable``) needs a wire: the
transport is a small length-prefixed binary framing over TCP — each
message is op byte + array count + per-array (dtype, shape, raw bytes),
numpy buffers without pickling — kept byte for byte as the JAX package
frames it, so a port client talks to a JAX-package server and the
reverse.  `PSServer` hosts a SparseTable; `RemoteSparseTable` exposes the
SAME pull/push/apply_delta/state_dict API as the in-process table, routing
rows to servers by ``id % num_servers`` (the reference's ParameterSend row
split across pservers), so AsyncCommunicator/GeoCommunicator work
unchanged across the process boundary.  Mutating requests carry a
(client_id, seq) tag the server dedupes on (replays apply once); the
barrier and heartbeat opcodes serve the sync / half-async communicators
and ``ps.HeartBeatMonitor``.
"""
from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np

from ..utils import monitor as _monitor
from ..utils import trace as _trace
from .ps import SparseTable

__all__ = ["PSServer", "RemoteSparseTable", "serve_forever"]

_OP_PULL = 1
_OP_PUSH = 2
_OP_DELTA = 3
_OP_NUM_ROWS = 4
_OP_STATE = 5
_OP_LOAD = 6
_OP_SHUTDOWN = 7
_OP_BARRIER = 8   # named rendezvous (ref listen_and_serv barrier counters)
_OP_BEAT = 9      # trainer heartbeat (ref heart_beat_monitor.h)
_OP_OK = 100
_OP_ERR = 101

_STATE_KEYS = ("ids", "rows", "accum", "accum2", "steps")

_OP_NAMES = {
    _OP_PULL: "pull", _OP_PUSH: "push", _OP_DELTA: "delta",
    _OP_NUM_ROWS: "num_rows", _OP_STATE: "state", _OP_LOAD: "load",
    _OP_SHUTDOWN: "shutdown", _OP_BARRIER: "barrier", _OP_BEAT: "beat",
}

# -- telemetry (utils/monitor.py; ref: the reference's brpc/gRPC server
# exposes per-method counts + latency through brpc's builtin /vars) ---------
_m_rpc_count = _monitor.counter(
    "ps.rpc_count", "PS server requests handled, per opcode.",
    labelnames=("op",))
_m_rpc_ms = _monitor.histogram(
    "ps.rpc_latency_ms", "PS server request handling latency (ms), per "
    "opcode (recv-to-reply, host wall time).", labelnames=("op",))
_m_rpc_errors = _monitor.counter(
    "ps.rpc_errors", "PS server requests that raised and returned an error "
    "frame, per opcode.", labelnames=("op",))
_m_beat_age = _monitor.gauge(
    "ps.heartbeat_age_seconds", "Seconds since the stalest worker's last "
    "heartbeat on this server (-1 before any beat; ref "
    "heart_beat_monitor.h).", labelnames=("server",))


def _send_msg(sock: socket.socket, op: int, arrays: Sequence[np.ndarray],
              traceparent: Optional[str] = None):
    """Frame = op byte + array count + per-array blocks + an optional
    trailing W3C traceparent (trace context rides the RPC payload, so
    server-side handling is correlated to the calling trainer's span —
    the cross-process analogue of the reference's per-process timelines)."""
    parts = [struct.pack("<BI", op, len(arrays))]
    for a in arrays:
        a = np.ascontiguousarray(a)
        ds = a.dtype.str.encode()
        parts.append(struct.pack("<B", len(ds)))
        parts.append(ds)
        parts.append(struct.pack("<B", a.ndim))
        if a.ndim:
            parts.append(struct.pack(f"<{a.ndim}q", *a.shape))
        parts.append(struct.pack("<Q", a.nbytes))
        parts.append(a.tobytes())
    if traceparent:
        parts.append(traceparent.encode("ascii"))
    payload = b"".join(parts)
    sock.sendall(struct.pack("<Q", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("peer closed mid-message")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _recv_msg(sock: socket.socket):
    (total,) = struct.unpack("<Q", _recv_exact(sock, 8))
    buf = _recv_exact(sock, total)
    off = 0
    op, count = struct.unpack_from("<BI", buf, off)
    off += 5
    arrays = []
    for _ in range(count):
        (dlen,) = struct.unpack_from("<B", buf, off)
        off += 1
        dtype = np.dtype(buf[off:off + dlen].decode())
        off += dlen
        (ndim,) = struct.unpack_from("<B", buf, off)
        off += 1
        shape = struct.unpack_from(f"<{ndim}q", buf, off) if ndim else ()
        off += 8 * ndim
        (nbytes,) = struct.unpack_from("<Q", buf, off)
        off += 8
        arr = np.frombuffer(buf, dtype, count=(nbytes // dtype.itemsize),
                            offset=off).reshape(shape).copy()
        off += nbytes
        arrays.append(arr)
    # trailing bytes (absent in pre-trace frames) are the traceparent
    traceparent = buf[off:].decode("ascii", errors="replace") or None
    return op, arrays, traceparent


class PSServer:
    """Serves one SparseTable over TCP (ref listen_and_serv_op.cc serve
    loop; one handler thread per connection ≈ its RPC thread pool)."""

    def __init__(self, table: SparseTable, host: str = "127.0.0.1",
                 port: int = 0, barrier_timeout_s: float = 60.0,
                 monitor=None):
        self.table = table
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()
        self._accept_thread: Optional[threading.Thread] = None
        self._running = False
        self.barrier_timeout_s = barrier_timeout_s
        self.monitor = monitor  # optional HeartBeatMonitor fed by _OP_BEAT
        self._barriers: Dict[bytes, threading.Barrier] = {}
        self._barrier_lock = threading.Lock()
        self._open_conns: set = set()
        # exactly-once bookkeeping: per-client high-water mark (LRU-bounded)
        # + in-flight markers so a resend racing the original apply waits
        from collections import OrderedDict

        self._applied_seq: "OrderedDict[int, int]" = OrderedDict()
        self._applied_max_clients = 4096
        self._inflight: set = set()
        self._applied_lock = threading.Lock()
        self._applied_cv = threading.Condition(self._applied_lock)
        # heartbeat-age telemetry: last beat per worker, surfaced as a
        # collect-time gauge (beats also feed the optional HeartBeatMonitor
        # above, which owns dead/revive callbacks)
        self._last_beats: Dict[int, float] = {}
        self._beats_lock = threading.Lock()
        _m_beat_age.set_function(self._heartbeat_age, server=str(self.port))

    def _heartbeat_age(self) -> float:
        with self._beats_lock:
            beats = list(self._last_beats.values())
        if not beats:
            return -1.0
        return max(0.0, time.monotonic() - min(beats))

    # -- exactly-once for mutating ops ------------------------------------
    # `_Conn` retries are at-least-once; push/delta carry a trailing
    # (client_id, seq) tag — allocated and sent under one client-side lock
    # hold, so per-client arrival order equals seq order — and the server
    # dedupes on a per-client high-water mark.  An in-flight marker covers
    # the resend-races-the-original-apply window: the duplicate WAITS for
    # the first apply to finish, then reads the updated mark.  Client state
    # is LRU-bounded (a retry is seconds-scale; eviction after 4096 newer
    # clients cannot race a live resend).
    def _begin_apply(self, tag: Sequence[np.ndarray]) -> bool:
        """True → caller must apply (then _record_applied / _abort_apply);
        False → duplicate of an already-applied request, just ack."""
        if not tag:
            return True  # legacy client without the tag: at-least-once
        cid, seq = (int(x) for x in tag[0])
        with self._applied_cv:
            while (cid, seq) in self._inflight:
                self._applied_cv.wait()
            if seq <= self._applied_seq.get(cid, -1):
                return False
            self._inflight.add((cid, seq))
            return True

    def _record_applied(self, tag: Sequence[np.ndarray]) -> None:
        if not tag:
            return
        cid, seq = (int(x) for x in tag[0])
        with self._applied_cv:
            self._applied_seq[cid] = max(seq, self._applied_seq.get(cid, -1))
            self._applied_seq.move_to_end(cid)
            while len(self._applied_seq) > self._applied_max_clients:
                self._applied_seq.popitem(last=False)
            self._inflight.discard((cid, seq))
            self._applied_cv.notify_all()

    def _abort_apply(self, tag: Sequence[np.ndarray]) -> None:
        """Apply raised: release the in-flight marker WITHOUT advancing the
        mark, so a retry of the same seq is attempted, not skipped."""
        if not tag:
            return
        cid, seq = (int(x) for x in tag[0])
        with self._applied_cv:
            self._inflight.discard((cid, seq))
            self._applied_cv.notify_all()

    def _get_barrier(self, name: bytes, n: int) -> threading.Barrier:
        with self._barrier_lock:
            b = self._barriers.get(name)
            if b is None or b.parties != n:
                b = threading.Barrier(n)
                self._barriers[name] = b
            return b

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "PSServer":
        self._running = True
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        return self

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            # track live connection SOCKETS (not threads) so stop() can
            # close them — otherwise established handler sockets keep the
            # port busy and a same-port restart fails to bind
            with self._barrier_lock:
                self._open_conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        try:
            self._serve_conn_inner(conn)
        finally:
            with self._barrier_lock:
                self._open_conns.discard(conn)

    def _serve_conn_inner(self, conn: socket.socket):
        with conn:
            try:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                return        # stop() closed it before this thread ran
            while True:
                try:
                    op, arrays, tp = _recv_msg(conn)
                except (ConnectionError, OSError):
                    return
                opname = _OP_NAMES.get(op, f"op{op}")
                # parent this request's span under the calling trainer's
                # context (the traceparent rides the frame) so client and
                # server spans share one trace_id across the process gap
                caller = _trace.extract({"traceparent": tp})
                t0 = time.perf_counter()
                with _trace.span(f"ps::{opname}", parent=caller,
                                 server=str(self.port)):
                    try:
                        if op == _OP_PULL:
                            rows = self.table.pull(arrays[0])
                            _send_msg(conn, _OP_OK, [rows])
                        elif op == _OP_PUSH:
                            ids, grads, lr = arrays[:3]
                            if not self._begin_apply(arrays[3:]):
                                _send_msg(conn, _OP_OK, [])
                                continue
                            try:
                                self.table.push(ids, grads, float(lr[0]))
                            except BaseException:
                                self._abort_apply(arrays[3:])
                                raise
                            self._record_applied(arrays[3:])
                            _send_msg(conn, _OP_OK, [])
                        elif op == _OP_DELTA:
                            if not self._begin_apply(arrays[2:]):
                                _send_msg(conn, _OP_OK, [])
                                continue
                            try:
                                self.table.apply_delta(arrays[0], arrays[1])
                            except BaseException:
                                self._abort_apply(arrays[2:])
                                raise
                            self._record_applied(arrays[2:])
                            _send_msg(conn, _OP_OK, [])
                        elif op == _OP_NUM_ROWS:
                            _send_msg(conn, _OP_OK,
                                      [np.asarray([self.table.num_rows],
                                                  np.int64)])
                        elif op == _OP_STATE:
                            st = self.table.state_dict()
                            _send_msg(conn, _OP_OK,
                                      [st[k] for k in _STATE_KEYS])
                        elif op == _OP_LOAD:
                            self.table.load_state_dict(
                                dict(zip(_STATE_KEYS, arrays)))
                            _send_msg(conn, _OP_OK, [])
                        elif op == _OP_BARRIER:
                            name = bytes(arrays[0]).decode()
                            n = int(arrays[1][0])
                            b = self._get_barrier(name.encode(), n)
                            try:
                                idx = b.wait(timeout=self.barrier_timeout_s)
                                if idx == 0:
                                    # all parties released; step-named
                                    # barriers are never reused — drop the
                                    # entry so a long run doesn't leak one
                                    # per step
                                    with self._barrier_lock:
                                        self._barriers.pop(name.encode(),
                                                           None)
                            except threading.BrokenBarrierError:
                                _send_msg(conn, _OP_ERR, [np.frombuffer(
                                    f"barrier {name!r} broken (a worker "
                                    "missed the rendezvous within "
                                    f"{self.barrier_timeout_s}s)".encode(),
                                    np.uint8)])
                                continue
                            _send_msg(conn, _OP_OK, [])
                        elif op == _OP_BEAT:
                            worker = int(arrays[0][0])
                            with self._beats_lock:
                                self._last_beats[worker] = time.monotonic()
                            if self.monitor is not None:
                                self.monitor.beat(worker)
                            _trace.flight_recorder().record(
                                "heartbeat", name=f"worker{worker}",
                                server=self.port, worker=worker)
                            _send_msg(conn, _OP_OK, [])
                        elif op == _OP_SHUTDOWN:
                            _send_msg(conn, _OP_OK, [])
                            self.stop()
                            return
                        else:
                            _send_msg(conn, _OP_ERR,
                                      [np.frombuffer(f"bad op {op}".encode(),
                                                     np.uint8)])
                    except Exception as e:  # noqa: BLE001 — report to client
                        _m_rpc_errors.inc(op=opname)
                        try:
                            _send_msg(conn, _OP_ERR, [np.frombuffer(
                                f"{type(e).__name__}: {e}".encode(),
                                np.uint8)])
                        except OSError:
                            return
                    finally:
                        # runs on every exit path (continue/return included):
                        # one count + one latency sample per request
                        _m_rpc_count.inc(op=opname)
                        _m_rpc_ms.observe(
                            (time.perf_counter() - t0) * 1000.0, op=opname)

    def stop(self):
        self._running = False
        _m_beat_age.remove(server=str(self.port))
        try:
            self._sock.close()
        except OSError:
            pass
        with self._barrier_lock:
            conns = list(self._open_conns)
            self._open_conns.clear()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass


class _Conn:
    """One persistent client connection (lock-serialized request/response)
    with reconnect-and-retry on transport failure (ref the brpc channel's
    retry policy / communicator rescue paths): exponential backoff, then
    the request is re-sent on a fresh socket.  The transport is
    at-least-once; mutating ops become exactly-once by carrying a
    (client_id, seq) tag from :meth:`next_tag` that the server dedupes on —
    a push/delta that landed before the connection dropped is recognized
    and skipped on resend."""

    def __init__(self, endpoint: str, max_retries: int = 5,
                 backoff_s: float = 0.2, timeout_s: float = 120.0):
        import os

        host, port = endpoint.rsplit(":", 1)
        self._addr = (host, int(port))
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.timeout_s = timeout_s
        self.lock = threading.Lock()
        # survives reconnects (unlike per-socket state on the server side)
        self._client_id = int.from_bytes(os.urandom(8), "little") >> 1
        self._seq = 0
        self.sock: Optional[socket.socket] = None
        self._connect()

    def next_tag(self) -> np.ndarray:
        """Fresh (client_id, seq) dedupe tag — one per logical mutating
        request; retries of that request re-send the SAME tag.  For
        concurrent callers use ``call(..., mutating=True)`` instead, which
        allocates the tag under the same lock hold as the send (otherwise
        a lower seq can arrive after a higher one and be dropped as a
        replay by the server's high-water mark)."""
        with self.lock:
            self._seq += 1
            return np.asarray([self._client_id, self._seq], np.int64)

    def _connect(self):
        self.sock = socket.create_connection(self._addr,
                                             timeout=self.timeout_s)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def call(self, op: int, arrays: Sequence[np.ndarray],
             retryable: bool = True, mutating: bool = False):
        import time as _time

        opname = _OP_NAMES.get(op, f"op{op}")
        endpoint = f"{self._addr[0]}:{self._addr[1]}"
        # client-side RPC span: its context is injected into the frame, so
        # the server's handler span is a child — one trace_id across the
        # trainer/pserver boundary
        with _trace.span(f"ps.rpc::{opname}", endpoint=endpoint) as sp:
            tp = sp.context.to_traceparent()
            with self.lock:
                if mutating:
                    # allocate seq inside the SAME lock hold as the send:
                    # per-client arrival order then equals seq order, which
                    # the server's high-water dedupe relies on
                    self._seq += 1
                    arrays = list(arrays) + [
                        np.asarray([self._client_id, self._seq], np.int64)]
                delay = self.backoff_s
                retries = self.max_retries if retryable else 0
                for attempt in range(retries + 1):
                    try:
                        if self.sock is None:
                            self._connect()
                        _send_msg(self.sock, op, arrays, traceparent=tp)
                        rop, out, _ = _recv_msg(self.sock)
                        break
                    except (ConnectionError, OSError, socket.timeout):
                        try:
                            if self.sock is not None:
                                self.sock.close()
                        except OSError:
                            pass
                        self.sock = None
                        _trace.flight_recorder().record(
                            "rpc_retry", name=opname, endpoint=endpoint,
                            attempt=attempt)
                        if attempt == retries:
                            raise
                        _time.sleep(delay)
                        delay = min(delay * 2, 5.0)
        if rop == _OP_ERR:
            raise RuntimeError(
                "PS server error: " + bytes(out[0]).decode(errors="replace"))
        return out

    def close(self):
        try:
            if self.sock is not None:
                self.sock.close()
        except OSError:
            pass
        self.sock = None


class RemoteSparseTable:
    """Client-side table with the SparseTable API, rows routed to servers
    by ``id % num_servers`` (ref ParameterSend VarBlock row split).  Plug
    it into AsyncCommunicator/GeoCommunicator for cross-process PS."""

    def __init__(self, endpoints: Sequence[str], dim: int):
        self.dim = dim
        self._conns = [_Conn(e) for e in endpoints]
        self.n = len(self._conns)

    def _route(self, ids):
        ids = np.asarray(ids, np.int64).reshape(-1)
        return ids, ids % self.n

    def pull(self, ids) -> np.ndarray:
        ids, srv = self._route(ids)
        out = np.empty((len(ids), self.dim), np.float32)
        for s in range(self.n):
            m = srv == s
            if m.any():
                (rows,) = self._conns[s].call(_OP_PULL, [ids[m]])
                out[m] = rows
        return out

    def push(self, ids, grads, lr: float = 0.1) -> None:
        ids, srv = self._route(ids)
        grads = np.asarray(grads, np.float32).reshape(len(ids), self.dim)
        lr_arr = np.asarray([lr], np.float32)
        for s in range(self.n):
            m = srv == s
            if m.any():
                self._conns[s].call(_OP_PUSH, [ids[m], grads[m], lr_arr],
                                    mutating=True)

    def apply_delta(self, ids, delta) -> None:
        ids, srv = self._route(ids)
        delta = np.asarray(delta, np.float32).reshape(len(ids), self.dim)
        for s in range(self.n):
            m = srv == s
            if m.any():
                self._conns[s].call(_OP_DELTA, [ids[m], delta[m]],
                                    mutating=True)

    @property
    def num_rows(self) -> int:
        return sum(int(c.call(_OP_NUM_ROWS, [])[0][0]) for c in self._conns)

    def state_dict(self) -> Dict[str, np.ndarray]:
        parts = [dict(zip(_STATE_KEYS, c.call(_OP_STATE, [])))
                 for c in self._conns]
        out = {k: np.concatenate([p[k] for p in parts]) for k in _STATE_KEYS}
        order = np.argsort(out["ids"])
        return {k: v[order] for k, v in out.items()}

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        ids = np.asarray(state["ids"], np.int64)
        srv = ids % self.n
        for s in range(self.n):
            m = srv == s
            self._conns[s].call(
                _OP_LOAD, [np.asarray(state[k])[m] for k in _STATE_KEYS])

    def barrier(self, name: str, num_workers: int) -> None:
        """Named rendezvous on server 0 (ref listen_and_serv barrier
        counters): blocks until ``num_workers`` clients arrive.

        NOT retried on transport failure: a re-sent barrier request would
        count the same worker twice and release the rendezvous early —
        a dropped connection here must surface as an error instead."""
        self._conns[0].call(_OP_BARRIER,
                            [np.frombuffer(name.encode(), np.uint8),
                             np.asarray([num_workers], np.int64)],
                            retryable=False)

    def beat(self, worker_id: int) -> None:
        """Heartbeat to every server's monitor (ref HeartBeatMonitor)."""
        for c in self._conns:
            c.call(_OP_BEAT, [np.asarray([worker_id], np.int64)])

    def shutdown_servers(self) -> None:
        for c in self._conns:
            try:
                c.call(_OP_SHUTDOWN, [])
            except (RuntimeError, OSError, ConnectionError):
                pass

    def close(self) -> None:
        for c in self._conns:
            c.close()


def serve_forever(dim: int, port: int, num_shards: int = 4,
                  optimizer: str = "adagrad", seed: int = 0) -> None:
    """Blocking server entry point for a dedicated pserver process
    (ref: the pserver side of fleet launch_ps, launch.py:226)."""
    import time

    server = PSServer(SparseTable(dim, num_shards, optimizer=optimizer,
                                  seed=seed), port=port)
    server.start()
    while server._running:
        time.sleep(0.2)
