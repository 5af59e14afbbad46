"""The port's PS transport (paddle_tpu_torch/distributed/ps_server.py)
against the JAX package's, on the CPU.

Counterparts of tests/test_ps_server.py (semantics, state, errors, replay
dedup, 2-process GEO-SGD), tests/test_ps_sync.py (sync and half-async
communicators, reconnect, worker restart, barriers) and
tests/test_heter_ps.py (the heterogeneous split, with the dense half in
torch), plus the wire itself: a port client against a JAX-package server
and a JAX-package client against a port server.

Servers bind 127.0.0.1:0 and stop in each test's teardown; the trainer
processes run in their own process group under a hard timeout.
"""
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.distributed.ps as jps
import paddle_tpu.distributed.ps_server as jsrv
from paddle_tpu_torch.distributed.ps import (
    AsyncCommunicator,
    GeoCommunicator,
    HalfAsyncCommunicator,
    HeartBeatMonitor,
    SparseTable,
    SyncCommunicator,
)
from paddle_tpu_torch.distributed.ps_server import PSServer, RemoteSparseTable

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 4
IDS = np.arange(6, dtype=np.int64)


@pytest.fixture
def server():
    srv = PSServer(SparseTable(dim=8, num_shards=2, optimizer="sgd", seed=3))
    srv.start()
    yield srv
    srv.stop()


# -- the wire, across packages ----------------------------------------------

@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("jax", "torch"), ("torch", "jax")])
def test_port_and_jax_package_interoperate(server_pkg, client_pkg):
    """Every opcode across the package boundary, both ways: the frames are
    the same bytes, so pulls, pushes (dedup tag included), deltas, state,
    load, barrier and heartbeat round-trip, and the rows equal an
    in-process table's."""
    s_mod = (jsrv, jps) if server_pkg == "jax" else (
        sys.modules[PSServer.__module__], sys.modules[SparseTable.__module__])
    c_mod = jsrv if client_pkg == "jax" else sys.modules[
        RemoteSparseTable.__module__]
    srv = s_mod[0].PSServer(s_mod[1].SparseTable(
        dim=8, num_shards=2, optimizer="adagrad", seed=3)).start()
    try:
        remote = c_mod.RemoteSparseTable([srv.endpoint], dim=8)
        local = SparseTable(dim=8, num_shards=2, optimizer="adagrad", seed=3)
        ids = np.array([1, 5, 9, 1, 12], np.int64)
        np.testing.assert_array_equal(remote.pull(ids), local.pull(ids))
        g = np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32)
        remote.push(ids, g, lr=0.5)
        local.push(ids, g, lr=0.5)
        d = np.full((2, 8), 0.25, np.float32)
        remote.apply_delta(ids[:2], d)
        local.apply_delta(ids[:2], d)
        np.testing.assert_array_equal(remote.pull(ids), local.pull(ids))
        assert remote.num_rows == local.num_rows == 4
        st = remote.state_dict()
        for k, v in local.state_dict().items():
            np.testing.assert_array_equal(st[k], v, err_msg=k)
        remote.load_state_dict(st)
        remote.barrier("solo", 1)
        remote.beat(0)
        np.testing.assert_array_equal(remote.pull(ids), local.pull(ids))
        remote.close()
    finally:
        srv.stop()


def test_frames_are_the_jax_packages_bytes():
    from paddle_tpu_torch.distributed import ps_server as psrv

    class Sink:
        def __init__(self):
            self.data = b""

        def sendall(self, b):
            self.data += b

    arrays = [np.arange(6, dtype=np.int64).reshape(2, 3),
              np.ones((2, 4), np.float32), np.asarray([0.5], np.float32),
              np.zeros((), np.float64)]
    a, b = Sink(), Sink()
    psrv._send_msg(a, psrv._OP_PUSH, arrays, traceparent="00-ab-cd-01")
    jsrv._send_msg(b, jsrv._OP_PUSH, arrays, traceparent="00-ab-cd-01")
    assert a.data == b.data
    assert [getattr(psrv, n) for n in dir(psrv) if n.startswith("_OP_")] \
        == [getattr(jsrv, n) for n in dir(jsrv) if n.startswith("_OP_")]


# -- tests/test_ps_server.py ------------------------------------------------

def test_remote_matches_local_semantics(server):
    remote = RemoteSparseTable([server.endpoint], dim=8)
    local = SparseTable(dim=8, num_shards=2, optimizer="sgd", seed=3)
    ids = np.array([1, 5, 9, 1], np.int64)
    np.testing.assert_array_equal(remote.pull(ids), local.pull(ids))
    g = np.ones((4, 8), np.float32)
    remote.push(ids, g, lr=0.5)
    local.push(ids, g, lr=0.5)
    np.testing.assert_array_equal(remote.pull(ids), local.pull(ids))
    remote.apply_delta(np.array([5]), np.full((1, 8), 2.0, np.float32))
    local.apply_delta(np.array([5]), np.full((1, 8), 2.0, np.float32))
    np.testing.assert_array_equal(remote.pull(ids), local.pull(ids))
    assert remote.num_rows == local.num_rows == 3
    remote.close()


def test_remote_state_roundtrip(server):
    remote = RemoteSparseTable([server.endpoint], dim=8)
    ids = np.arange(6, dtype=np.int64)
    remote.push(ids, np.random.default_rng(0).normal(
        size=(6, 8)).astype(np.float32), lr=0.1)
    st = remote.state_dict()
    assert list(st["ids"]) == list(range(6))
    srv2 = PSServer(SparseTable(dim=8, num_shards=2, optimizer="sgd"))
    srv2.start()
    try:
        remote2 = RemoteSparseTable([srv2.endpoint], dim=8)
        remote2.load_state_dict(st)
        np.testing.assert_array_equal(remote2.pull(ids), remote.pull(ids))
        remote2.close()
    finally:
        srv2.stop()
    remote.close()


def test_remote_error_propagates(server):
    remote = RemoteSparseTable([server.endpoint], dim=8)
    with pytest.raises(RuntimeError, match="PS server error"):
        remote._conns[0].call(2, [np.array([1], np.int64),
                                  np.ones((1, 3), np.float32),
                                  np.asarray([0.1], np.float32)])
    assert remote.pull(np.array([1])).shape == (1, 8)
    remote.close()


_TRAINER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    sys.modules["jax"] = None            # the port's trainer needs no JAX
    import numpy as np
    from paddle_tpu_torch.distributed.ps import GeoCommunicator
    from paddle_tpu_torch.distributed.ps_server import RemoteSparseTable

    endpoint, rank = sys.argv[1], int(sys.argv[2])
    table = RemoteSparseTable([endpoint], dim=4)
    geo = GeoCommunicator(table, sync_steps=5)
    rng = np.random.default_rng(7)
    targets = rng.normal(size=(16, 4)).astype(np.float32)
    my_ids = np.arange(16)[rank::2]
    for step in range(60):
        ids = my_ids[(step % 4) * 2:(step % 4) * 2 + 2]
        rows = geo.pull(ids)
        geo.update_local(ids, rows - targets[ids], lr=0.3)
    geo.sync()
    table.close()
    print("trainer", rank, "done")
""")


def _run_trainers(script, args_of, n, timeout=120):
    procs = [subprocess.Popen([sys.executable, str(script)] + args_of(r),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT,
                              start_new_session=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append((p.returncode, out.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return outs


@pytest.mark.parametrize("server_pkg", ["torch", "jax"])
def test_two_process_geo_sgd_converges(tmp_path, server_pkg):
    """Two port trainer processes against one pserver (the port's, or the
    JAX package's) converge with GEO-SGD delta sync."""
    mk = (SparseTable, PSServer) if server_pkg == "torch" else (
        jps.SparseTable, jsrv.PSServer)
    table = mk[0](dim=4, num_shards=2, optimizer="sgd", seed=11)
    srv = mk[1](table)
    srv.start()
    script = tmp_path / "trainer.py"
    script.write_text(_TRAINER.format(repo=_REPO))
    try:
        for rc, out in _run_trainers(script, lambda r: [srv.endpoint, str(r)],
                                     2):
            assert rc == 0, out
        targets = np.random.default_rng(7).normal(
            size=(16, 4)).astype(np.float32)
        final = table.pull(np.arange(16, dtype=np.int64))
        assert np.abs(final - targets).max() < 0.05
        assert table.num_rows == 16
    finally:
        srv.stop()


@pytest.mark.parametrize("op", ["push", "delta"])
def test_replay_deduped(server, op):
    """A mutating request re-sent with the same (client_id, seq) tag — what
    the retry path does after a transport failure whose request landed —
    applies once; a fresh tag applies again."""
    from paddle_tpu_torch.distributed.ps_server import (_OP_DELTA, _OP_PUSH,
                                                        _Conn)

    conn = _Conn(server.endpoint)
    remote = RemoteSparseTable([server.endpoint], dim=8)
    ids = np.array([7], np.int64)
    before = remote.pull(ids).copy()
    if op == "push":
        args = [ids, np.ones((1, 8), np.float32),
                np.asarray([0.5], np.float32)]
        code = _OP_PUSH
    else:
        args = [ids, np.full((1, 8), 2.0, np.float32)]
        code = _OP_DELTA
    tag = conn.next_tag()
    conn.call(code, args + [tag])
    once = remote.pull(ids).copy()
    assert not np.array_equal(once, before)
    conn.call(code, args + [tag])
    np.testing.assert_array_equal(remote.pull(ids), once)
    conn.call(code, args + [conn.next_tag()])
    assert not np.array_equal(remote.pull(ids), once)
    conn.close()
    remote.close()


# -- tests/test_ps_sync.py --------------------------------------------------

def _loss_and_grad(rows, w_true):
    diff = rows - w_true
    return float(np.mean(diff * diff)), 2.0 * diff / diff.size


def _run_threads(target, n=2, timeout=60):
    errors = []

    def wrap(w):
        try:
            target(w)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    ts = [threading.Thread(target=wrap, args=(w,)) for w in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    assert not errors, errors


def test_sync_ps_matches_single_process_loss_sequence():
    """2 trainers x 1 server sync-PS reproduce the single-process loss
    sequence (TestDistBase's contract)."""
    w_true = np.random.RandomState(0).randn(len(IDS), DIM).astype(np.float32)
    lr = 0.5
    base = SparseTable(dim=DIM, num_shards=2, optimizer="sgd", seed=7)
    base_losses = []
    for _ in range(10):
        loss, grad = _loss_and_grad(base.pull(IDS), w_true)
        base_losses.append(loss)
        base.push(IDS, grad, lr)
    srv = PSServer(SparseTable(dim=DIM, num_shards=2, optimizer="sgd",
                               seed=7), barrier_timeout_s=20.0).start()
    losses = {0: [], 1: []}

    def trainer(wid):
        table = RemoteSparseTable([srv.endpoint], dim=DIM)
        comm = SyncCommunicator(table, wid, 2, lr=lr / 2)
        for _ in range(10):
            loss, grad = _loss_and_grad(comm.pull(IDS), w_true)
            losses[wid].append(loss)
            comm.push_and_sync(IDS, grad)
        table.close()

    try:
        _run_threads(trainer)
    finally:
        srv.stop()
    np.testing.assert_allclose(losses[0], base_losses, rtol=1e-5)
    np.testing.assert_allclose(losses[1], base_losses, rtol=1e-5)


def test_half_async_bounded_staleness():
    srv = PSServer(SparseTable(dim=DIM, num_shards=2, optimizer="sgd",
                               seed=1), barrier_timeout_s=20.0).start()
    try:
        def trainer(wid):
            table = RemoteSparseTable([srv.endpoint], dim=DIM)
            comm = HalfAsyncCommunicator(table, lr=1.0, barrier_every=4,
                                         worker_id=wid, num_workers=2)
            comm.start()
            try:
                for _ in range(8):
                    comm.send(IDS, np.ones((len(IDS), DIM), np.float32))
                    comm.step_end()
            finally:
                comm.stop()
            table.close()

        _run_threads(trainer)
        table = RemoteSparseTable([srv.endpoint], dim=DIM)
        start = SparseTable(dim=DIM, num_shards=2, optimizer="sgd",
                            seed=1).pull(IDS)
        np.testing.assert_allclose(start - table.pull(IDS),
                                   np.full((len(IDS), DIM), 16.0), rtol=1e-5)
        table.close()
    finally:
        srv.stop()


def test_client_reconnects_after_connection_drop():
    srv = PSServer(SparseTable(dim=DIM, num_shards=2, optimizer="sgd",
                               seed=5)).start()
    try:
        client = RemoteSparseTable([srv.endpoint], dim=DIM)
        rows_before = client.pull(IDS)
        for c in client._conns:
            c.sock.close()
        np.testing.assert_array_equal(client.pull(IDS), rows_before)
        client.push(IDS, np.ones((len(IDS), DIM), np.float32), lr=0.5)
        for c in client._conns:
            c.sock.close()
        np.testing.assert_allclose(client.pull(IDS), rows_before - 0.5,
                                   rtol=1e-6)
        client.close()
    finally:
        srv.stop()


def test_worker_restart_mid_training_job_completes():
    w_true = np.random.RandomState(3).randn(len(IDS), DIM).astype(np.float32)
    dead, revived = [], []
    monitor = HeartBeatMonitor(worker_num=1, timeout_s=0.5,
                               on_dead=dead.append, on_revive=revived.append)
    srv = PSServer(SparseTable(dim=DIM, num_shards=2, optimizer="sgd",
                               seed=3), monitor=monitor).start()
    monitor.start(interval_s=0.1)

    def run_worker(steps):
        table = RemoteSparseTable([srv.endpoint], dim=DIM)
        comm = GeoCommunicator(table, sync_steps=2)
        last = None
        for _ in range(steps):
            table.beat(0)
            last, grad = _loss_and_grad(comm.pull(IDS), w_true)
            comm.update_local(IDS, grad, lr=2.0)
        comm.sync()
        table.close()
        return last

    try:
        first_loss = run_worker(6)
        time.sleep(1.0)
        assert dead == [0]
        final_loss = run_worker(6)
        assert revived == [0]
    finally:
        monitor.stop()
        srv.stop()
    assert final_loss < first_loss * 0.7, (first_loss, final_loss)


def test_barrier_not_retried_and_server_entries_freed():
    srv = PSServer(SparseTable(dim=DIM, num_shards=2, optimizer="sgd"),
                   barrier_timeout_s=10.0).start()
    try:
        c0 = RemoteSparseTable([srv.endpoint], dim=DIM)
        c1 = RemoteSparseTable([srv.endpoint], dim=DIM)
        for step in range(5):
            t = threading.Thread(target=c1.barrier, args=(f"s{step}", 2))
            t.start()
            c0.barrier(f"s{step}", 2)
            t.join(timeout=10)
        assert len(srv._barriers) == 0
        c0._conns[0].sock.close()
        with pytest.raises((ConnectionError, OSError)):
            c0.barrier("s_dead", 2)
        c0.close()
        c1.close()
    finally:
        srv.stop()


def test_half_async_requires_barrier_for_multiworker():
    table = SparseTable(dim=DIM, num_shards=2, optimizer="sgd")
    with pytest.raises(ValueError, match="barrier"):
        HalfAsyncCommunicator(table, num_workers=2)
    HalfAsyncCommunicator(table, num_workers=1)


# -- tests/test_heter_ps.py -------------------------------------------------

HDIM, VOCAB, BATCH = 8, 64, 16


@pytest.fixture
def heter_server():
    srv = PSServer(SparseTable(dim=HDIM, num_shards=2, optimizer="sgd",
                               seed=11)).start()
    yield srv
    srv.stop()


def test_heterogeneous_split_trains(heter_server):
    """Sparse rows on the (remote) host table, the dense half in torch:
    the rows' gradient comes out of the same backward as the dense one and
    is pushed through the AsyncCommunicator."""
    remote = RemoteSparseTable([heter_server.endpoint], dim=HDIM)
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.normal(0, 0.3, (HDIM, 1)), dtype=torch.float32)
    true_emb = rng.normal(0, 1, (VOCAB, HDIM)).astype(np.float32)
    true_w = rng.normal(0, 1, (HDIM, 1)).astype(np.float32)
    comm = AsyncCommunicator(remote, lr=0.3)
    comm.start()
    losses = []
    try:
        for _ in range(60):
            ids = rng.integers(0, VOCAB, (BATCH,))
            y = torch.tensor(true_emb[ids] @ true_w)
            rows = torch.tensor(remote.pull(ids), requires_grad=True)
            w.requires_grad_(True)
            loss = ((rows @ w - y) ** 2).mean()
            loss.backward()
            with torch.no_grad():
                w = (w - 0.1 * w.grad).detach()
            comm.send(ids, rows.grad.numpy())
            losses.append(float(loss.detach()))
        comm.flush()
    finally:
        comm.stop()
    assert np.mean(losses[-10:]) < 0.5 * np.mean(losses[:10]), losses
    assert remote.num_rows > 0
    assert remote.state_dict()["rows"].shape[1] == HDIM
    remote.close()


def test_dense_params_never_cross_the_wire(heter_server):
    remote = RemoteSparseTable([heter_server.endpoint], dim=HDIM)
    sent_shapes = []
    conn = remote._conns[0]
    orig_call = conn.call

    def spy(op, arrays, **kw):
        sent_shapes.extend(tuple(np.asarray(a).shape) for a in arrays)
        return orig_call(op, arrays, **kw)

    conn.call = spy
    rng = np.random.default_rng(1)
    w = torch.tensor(rng.normal(0, 0.3, (HDIM, 1)), dtype=torch.float32)
    ids = rng.integers(0, VOCAB, (BATCH,))
    rows = torch.tensor(remote.pull(ids), requires_grad=True)
    ((rows @ w) ** 2).sum().backward()
    remote.push(ids, rows.grad.numpy(), lr=0.1)
    assert (HDIM, 1) not in sent_shapes
    assert any(s == (BATCH, HDIM) for s in sent_shapes)
    remote.close()
