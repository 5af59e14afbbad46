"""The port's parameter-server tables and communicators
(paddle_tpu_torch/distributed/ps.py) against the JAX package's
(paddle_tpu/distributed/ps.py), on the CPU.

Each test of tests/test_ps.py has a counterpart here run on the port; the
rows a table faults in, and every optimizer's updates, are held against
the JAX table bit for bit for the same seeds and the same pull order.  The
end-to-end loop trains its dense head in torch where the JAX test trains
it with jax.
"""
import time

import numpy as np
import pytest
import torch

import paddle_tpu.distributed.ps as jps
from paddle_tpu_torch.distributed import (
    AsyncCommunicator,
    GeoCommunicator,
    HeartBeatMonitor,
    LargeScaleEmbedding,
    SparseTable,
)

PULL_ORDERS = {
    "ascending": [[0, 1, 2, 3, 4, 5, 6, 7]],
    "duplicates": [[5, 9, 5, 9, 1], [1, 40, 3]],
    "interleaved": [[17, 4, 99, 4], [3, 17, 250, 8, 8, 1000]],
}


@pytest.mark.parametrize("order", sorted(PULL_ORDERS))
@pytest.mark.parametrize("num_shards,seed,dim", [(4, 0, 8), (3, 7, 5),
                                                 (1, 11, 16)])
def test_rows_fault_in_as_the_jax_table_does(order, num_shards, seed, dim):
    port = SparseTable(dim=dim, num_shards=num_shards, seed=seed)
    ref = jps.SparseTable(dim=dim, num_shards=num_shards, seed=seed)
    for ids in PULL_ORDERS[order]:
        got, want = port.pull(ids), ref.pull(ids)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert port.num_rows == ref.num_rows
    for k, v in ref.state_dict().items():
        np.testing.assert_array_equal(port.state_dict()[k], v)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_updates_match_the_jax_table_bitwise(optimizer):
    port = SparseTable(dim=6, num_shards=3, optimizer=optimizer, seed=5)
    ref = jps.SparseTable(dim=6, num_shards=3, optimizer=optimizer, seed=5)
    rng = np.random.default_rng(0)
    for step in range(4):
        ids = rng.integers(0, 20, 9)              # with duplicates
        grads = rng.normal(size=(9, 6)).astype(np.float32)
        port.push(ids, grads, lr=0.3)
        ref.push(ids, grads, lr=0.3)
        delta = rng.normal(size=(3, 6)).astype(np.float32)
        port.apply_delta(ids[:3], delta)
        ref.apply_delta(ids[:3], delta)
    probe = np.arange(20)
    np.testing.assert_array_equal(port.pull(probe), ref.pull(probe))
    for k, v in ref.state_dict().items():
        np.testing.assert_array_equal(port.state_dict()[k], v, err_msg=k)


def test_sparse_table_pull_initializes_lazily_and_consistently():
    t = SparseTable(dim=4, num_shards=3, seed=0)
    a = t.pull([5, 9, 5])
    assert a.shape == (3, 4)
    np.testing.assert_array_equal(a[0], a[2])
    assert t.num_rows == 2
    np.testing.assert_array_equal(t.pull([5])[0], a[0])


def test_sparse_table_sgd_push_math():
    t = SparseTable(dim=2, num_shards=2, optimizer="sgd",
                    initializer=lambda d: np.zeros(d))
    t.push([7, 8], np.array([[1.0, 2.0], [3.0, 4.0]], np.float32), lr=0.5)
    np.testing.assert_allclose(t.pull([7])[0], [-0.5, -1.0])
    np.testing.assert_allclose(t.pull([8])[0], [-1.5, -2.0])


def test_sparse_table_duplicate_ids_accumulate():
    t = SparseTable(dim=1, num_shards=2, optimizer="sgd",
                    initializer=lambda d: np.zeros(d))
    t.push([3, 3, 3], np.array([[1.0], [1.0], [1.0]]), lr=1.0)
    np.testing.assert_allclose(t.pull([3])[0], [-3.0])


def test_sparse_table_adagrad_scales_updates():
    t = SparseTable(dim=1, num_shards=1, optimizer="adagrad",
                    initializer=lambda d: np.zeros(d))
    t.push([0], np.array([[2.0]]), lr=1.0)
    np.testing.assert_allclose(t.pull([0])[0], [-1.0], atol=1e-5)


def test_sparse_table_adam_first_step():
    t = SparseTable(dim=1, num_shards=1, optimizer="adam",
                    initializer=lambda d: np.zeros(d))
    t.push([0], np.array([[3.0]]), lr=0.1)
    np.testing.assert_allclose(t.pull([0])[0], [-0.1], atol=1e-4)


def test_unknown_optimizer_raises_at_construction():
    with pytest.raises(ValueError, match="unknown optimizer"):
        SparseTable(dim=2, optimizer="rmsprop")


def test_state_dict_roundtrip_across_packages():
    """A port table's state loads into a JAX table of another shard count
    and the reverse, rows and slots intact."""
    t = SparseTable(dim=3, num_shards=2, seed=1, optimizer="adam")
    t.pull([1, 2, 10])
    t.push([1, 10], np.ones((2, 3), np.float32), lr=0.1)
    j = jps.SparseTable(dim=3, num_shards=4, seed=99, optimizer="adam")
    j.load_state_dict(t.state_dict())
    np.testing.assert_array_equal(j.pull([1, 2, 10]), t.pull([1, 2, 10]))
    back = SparseTable(dim=3, num_shards=3, seed=5, optimizer="adam")
    back.load_state_dict(j.state_dict())
    for k, v in t.state_dict().items():
        np.testing.assert_array_equal(back.state_dict()[k], v, err_msg=k)


def test_state_dict_preserves_optimizer_slots():
    def mk():
        return SparseTable(dim=1, num_shards=1, optimizer="adagrad",
                           initializer=lambda d: np.zeros(d))

    t = mk()
    t.push([0], np.array([[2.0]]), lr=1.0)
    restored = mk()
    restored.load_state_dict(t.state_dict())
    t.push([0], np.array([[2.0]]), lr=1.0)
    restored.push([0], np.array([[2.0]]), lr=1.0)
    np.testing.assert_array_equal(restored.pull([0]), t.pull([0]))


def test_async_communicator_stop_without_flush_no_deadlock():
    t = SparseTable(dim=1, num_shards=1, optimizer="sgd",
                    initializer=lambda d: np.zeros(d))
    comm = AsyncCommunicator(t, lr=1.0, max_merge=2, queue_size=2)
    comm.start()
    for _ in range(6):
        comm.send(np.array([1]), np.array([[1.0]]))
    comm.stop()
    np.testing.assert_allclose(t.pull([1])[0], [-6.0])


def test_async_communicator_merges_and_applies():
    t = SparseTable(dim=2, num_shards=2, optimizer="sgd",
                    initializer=lambda d: np.zeros(d))
    comm = AsyncCommunicator(t, lr=1.0, max_merge=4)
    comm.start()
    try:
        for _ in range(8):
            comm.send(np.array([4]), np.array([[1.0, 1.0]]))
        comm.flush()
    finally:
        comm.stop()
    np.testing.assert_allclose(t.pull([4])[0], [-8.0, -8.0])


def test_geo_communicator_delta_sync_two_workers():
    table = SparseTable(dim=1, num_shards=1, optimizer="sgd",
                        initializer=lambda d: np.zeros(d))
    w1 = GeoCommunicator(table, sync_steps=2)
    w2 = GeoCommunicator(table, sync_steps=2)
    w1.pull([0])
    w2.pull([0])
    w1.update_local([0], np.array([[1.0]]), lr=1.0)
    w1.update_local([0], np.array([[1.0]]), lr=1.0)
    np.testing.assert_allclose(table.pull([0])[0], [-2.0])
    w2.update_local([0], np.array([[1.0]]), lr=1.0)
    w2.update_local([0], np.array([[1.0]]), lr=1.0)
    np.testing.assert_allclose(table.pull([0])[0], [-4.0])
    np.testing.assert_allclose(w2.pull([0])[0], [-4.0])


def test_heartbeat_monitor_detects_dead_worker():
    dead = []
    mon = HeartBeatMonitor(worker_num=2, timeout_s=0.2, on_dead=dead.append)
    mon.start(interval_s=0.05)
    try:
        t_end = time.monotonic() + 0.6
        while time.monotonic() < t_end:
            mon.beat(0)
            time.sleep(0.03)
    finally:
        mon.stop()
    assert 1 in dead and 0 not in dead


def test_end_to_end_embedding_on_host_dense_in_torch():
    """DownpourWorker flow: pull -> dense step in torch (autograd gives the
    slab's gradient) -> push; the embedding learns an id -> class map, and
    the first step's row gradient equals the JAX package's within fp32
    rounding."""
    import jax
    import jax.numpy as jnp

    emb = LargeScaleEmbedding(dim=8, optimizer="adagrad", seed=0)
    rng = np.random.RandomState(0)
    w0 = rng.randn(8, 4).astype(np.float32) * 0.1
    W = torch.tensor(w0)

    def step(slab, y, W):
        slab = torch.tensor(slab, requires_grad=True)
        W = W.clone().requires_grad_(True)
        lp = torch.log_softmax(slab @ W, -1)
        loss = -lp.gather(1, torch.as_tensor(y)[:, None]).mean()
        loss.backward()
        return float(loss.detach()), slab.grad.numpy(), W.grad

    def jax_slab_grad(slab, y, W):
        def f(s):
            lp = jax.nn.log_softmax(s @ jnp.asarray(W))
            return -jnp.take_along_axis(lp, jnp.asarray(y)[:, None], 1).mean()
        return np.asarray(jax.grad(f)(jnp.asarray(slab)))

    losses = []
    for it in range(60):
        ids = rng.randint(0, 40, size=16)
        y = ids % 4
        slab = emb.pull(ids)
        loss, g_slab, g_W = step(slab, y, W)
        if it == 0:
            np.testing.assert_allclose(g_slab, jax_slab_grad(slab, y, w0),
                                       rtol=1e-5, atol=1e-7)
        emb.push(ids, g_slab, lr=0.5)
        W = W - 0.5 * g_W
        losses.append(loss)
    assert losses[-1] < 0.25 * losses[0], losses[::10]
    assert emb.table.num_rows <= 40
