"""The port's elastic membership, PS hot failover, launcher restarts and
the chaos run (paddle_tpu_torch/elastic/{membership,failover}.py,
distributed/launch.py) against the JAX package's, on the CPU.

Counterparts of tests/test_elastic_chaos.py:

* membership: stale heartbeats flip ranks to dead after ``dead_after_s``,
  eviction markers are claimed once (O_EXCL) across observers, the grace
  window, stragglers flagged once, ``record_resume`` mirrors the world
  into ``distributed.env``, ``from_env``;
* failover: digest-checked table snapshots (a JAX-package snapshot
  replays in the port, byte for byte the same file), a ``StandbyServer``
  that promotes on the primary's death and serves the snapshot bitwise,
  and the empty promotion;
* the launcher's restart budget and flight-dump pointer;
* the chaos run: three worker processes, world 1 each (a process group
  cannot lose a member, so, as the JAX package's chaos workers do, they
  share only the membership and checkpoint directories), train the JAX
  test's static program from the JAX package's initial state; one is
  SIGKILLed; the survivors detect, evict, restore the leader's latest
  checkpoint no later than their own step and finish every step on the
  JAX package's reference trajectory (rel 2e-3, the JAX program built
  under a fresh process's names), and their flight dumps show
  ``worker_dead`` ->
  exactly one ``worker_evicted`` -> ``elastic_restore`` ->
  ``elastic_resume``.  The JAX chain's ``autoplan_replan`` step (the
  survivors re-deriving a plan through the cost-model search,
  ``failover.replan_for_survivors``) waits for ROADMAP.md Queue 1 item 9b:
  here it raises ``NotImplementedError``.

Heartbeats run at test scale (0.1 s beats, 1 s dead-after); every thread,
server and process stops in the test's teardown, and the worker
processes run in their own process groups under a hard timeout.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

from paddle_tpu.elastic import checkpoint as jeckpt
from paddle_tpu.elastic import failover as jfailover
from paddle_tpu_torch.distributed import env as dist_env
from paddle_tpu_torch.distributed.launch import launch
from paddle_tpu_torch.distributed.ps import SparseTable
from paddle_tpu_torch.distributed.ps_server import PSServer, RemoteSparseTable
from paddle_tpu_torch.elastic import failover
from paddle_tpu_torch.elastic.failover import (
    SnapshotError, StandbyServer, TableSnapshotter, load_table_snapshot,
    save_table_snapshot)
from paddle_tpu_torch.elastic.membership import ElasticMember
from paddle_tpu_torch.utils import monitor
from paddle_tpu_torch.utils import trace as trace_mod

_REPO = Path(__file__).resolve().parents[1]


def _kinds():
    return [e["kind"] for e in trace_mod.flight_recorder().events()]


# -- membership --------------------------------------------------------------

def _age_heartbeat(directory, rank, by_s: float):
    p = os.path.join(directory, f"hb.{rank}.json")
    with open(p) as f:
        hb = json.load(f)
    hb["ts"] -= by_s
    with open(p, "w") as f:
        json.dump(hb, f)


def test_membership_detects_stale_heartbeat(tmp_path):
    d = str(tmp_path)
    m0 = ElasticMember(d, rank=0, world_size=2, dead_after_s=1.0)
    m1 = ElasticMember(d, rank=1, world_size=2, dead_after_s=1.0)
    m0.beat()
    m1.beat()
    v = m0.view()
    assert v.live == (0, 1) and v.dead == () and v.world_size == 2
    _age_heartbeat(d, 1, by_s=5.0)
    m0.beat()
    v = m0.view()
    assert v.live == (0,) and v.dead == (1,)


def test_membership_evicts_exactly_once_across_observers(tmp_path):
    d = str(tmp_path)
    reg = monitor.default_registry()
    deaths0 = reg.get("elastic.worker_deaths").value()
    members = [ElasticMember(d, rank=r, world_size=3, dead_after_s=0.5)
               for r in (0, 2)]
    for m in members:
        m.beat()
    ElasticMember(d, rank=1, world_size=3).beat()
    _age_heartbeat(d, 1, by_s=5.0)
    assert members[0].detect_and_evict() == [1]
    assert members[1].detect_and_evict() == [1]
    assert members[0].detect_and_evict() == []
    assert (tmp_path / "evicted.1").exists()
    assert reg.get("elastic.worker_deaths").value() - deaths0 == 1
    assert members[0].world_size() == 2
    assert members[0].view().evicted == (1,)
    assert members[0].view().generation == 1


def test_membership_grace_period_for_slow_starters(tmp_path):
    m0 = ElasticMember(str(tmp_path), rank=0, world_size=2,
                       dead_after_s=0.4)
    m0.beat()
    assert m0.view().dead == ()
    time.sleep(0.5)
    m0.beat()
    assert m0.view().dead == (1,)


def test_membership_straggler_flagged_once(tmp_path):
    d = str(tmp_path)
    m0 = ElasticMember(d, rank=0, world_size=2, straggler_steps=2)
    m1 = ElasticMember(d, rank=1, world_size=2, straggler_steps=2)
    m0.set_step(10)
    m1.set_step(1)
    n0 = _kinds().count("straggler")
    assert m0.stragglers() == [1]
    assert m0.stragglers() == [1]
    n1 = _kinds().count("straggler")
    assert n1 - n0 == 1
    m1.set_step(10)
    assert m0.stragglers() == []
    m1.set_step(10)
    m0.set_step(20)
    assert m0.stragglers() == [1]
    assert _kinds().count("straggler") - n1 == 1


def test_record_resume_overrides_world_size(tmp_path):
    m = ElasticMember(str(tmp_path), rank=0, world_size=4)
    try:
        m.record_resume(step=7, world=3)
        assert dist_env.get_world_size() == 3
        ev = [e for e in trace_mod.flight_recorder().events()
              if e["kind"] == "elastic_resume"]
        assert ev and ev[-1]["world"] == 3 and ev[-1]["step"] == 7
    finally:
        dist_env.set_elastic_world(None)


def test_member_from_env_and_background_beats(tmp_path, monkeypatch):
    monkeypatch.setenv("PDTPU_ELASTIC_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "5")
    m = ElasticMember.from_env(dead_after_s=9.0, interval_s=0.05)
    assert (m.dir, m.rank, m.initial_world) == (str(tmp_path), 2, 5)
    assert m.dead_after_s == 9.0
    m.start()
    try:
        ts0 = json.loads((tmp_path / "hb.2.json").read_text())["ts"]
        time.sleep(0.3)
        assert json.loads((tmp_path / "hb.2.json").read_text())["ts"] > ts0
    finally:
        m.stop()
    with pytest.raises(ValueError, match="PDTPU_ELASTIC_DIR"):
        monkeypatch.delenv("PDTPU_ELASTIC_DIR")
        ElasticMember.from_env()


# -- PS failover ---------------------------------------------------------------

def test_table_snapshot_roundtrip_and_corruption(tmp_path):
    t = SparseTable(dim=4, num_shards=2, optimizer="sgd", seed=3)
    ids = np.arange(6, dtype=np.int64)
    t.push(ids, np.ones((6, 4), np.float32), lr=0.5)
    path = str(tmp_path / "t.snap")
    save_table_snapshot(t, path)
    t2 = SparseTable(dim=4, num_shards=2, optimizer="sgd", seed=99)
    t2.load_state_dict(load_table_snapshot(path))
    np.testing.assert_array_equal(t2.pull(ids), t.pull(ids))
    # the JAX package's snapshot of the same table is the same file, and
    # each package replays the other's
    jpath = str(tmp_path / "j.snap")
    jfailover.save_table_snapshot(t, jpath)
    assert Path(jpath).read_bytes() == Path(path).read_bytes()
    for k, v in jfailover.load_table_snapshot(path).items():
        np.testing.assert_array_equal(load_table_snapshot(jpath)[k], v)
    blob = bytearray(Path(path).read_bytes())
    blob[-3] ^= 0xFF
    Path(path).write_bytes(bytes(blob))
    with pytest.raises(SnapshotError, match="digest mismatch"):
        load_table_snapshot(path)
    with pytest.raises(SnapshotError, match="unreadable"):
        load_table_snapshot(str(tmp_path / "missing.snap"))


def test_standby_promotes_on_primary_death(tmp_path):
    reg = monitor.default_registry()
    f0 = reg.get("elastic.failovers").value()
    snap = str(tmp_path / "table.snap")
    primary_table = SparseTable(dim=8, num_shards=2, optimizer="sgd", seed=3)
    primary = PSServer(primary_table).start()
    standby = StandbyServer(
        SparseTable(dim=8, num_shards=2, optimizer="sgd", seed=77),
        snapshot_path=snap, primary_endpoint=primary.endpoint,
        probe_interval_s=0.1, max_missed=2)
    snapshotter = TableSnapshotter(primary_table, snap, every_s=0.2)
    try:
        remote = RemoteSparseTable([primary.endpoint], dim=8)
        ids = np.array([1, 5, 9], np.int64)
        remote.pull(ids)
        remote.apply_delta(ids, np.full((3, 8), 2.0, np.float32))
        expect = remote.pull(ids)
        snapshotter.start()
        snapshotter.stop()
        remote.close()
        standby.start()
        time.sleep(0.4)
        assert not standby.promoted
        primary.stop()
        assert standby.wait_promoted(timeout=10), "standby never promoted"
        failover_remote = RemoteSparseTable([standby.endpoint], dim=8)
        np.testing.assert_array_equal(failover_remote.pull(ids), expect)
        failover_remote.close()
        assert reg.get("elastic.failovers").value() - f0 == 1
        kinds = _kinds()
        assert "ps_probe_missed" in kinds and "failover" in kinds
    finally:
        snapshotter.stop()
        standby.stop()
        primary.stop()


def test_standby_without_snapshot_promotes_empty(tmp_path):
    standby = StandbyServer(
        SparseTable(dim=4, num_shards=1, optimizer="sgd", seed=1),
        snapshot_path=str(tmp_path / "never.snap"),
        primary_endpoint="127.0.0.1:1")
    try:
        standby.promote()
        assert standby.promoted and standby.endpoint
        assert "failover_snapshot_missing" in _kinds()
    finally:
        standby.stop()


def test_replan_for_survivors_waits_for_item_9b():
    with pytest.raises(NotImplementedError, match="9b"):
        failover.replan_for_survivors(None, world=2)


# -- launcher ----------------------------------------------------------------

def _worker_script(tmp_path, body):
    p = tmp_path / "worker.py"
    p.write_text(textwrap.dedent(body))
    return str(p)


def test_launch_max_restarts_respawns_crashed_rank(tmp_path):
    marker = tmp_path / "second_life.txt"
    script = _worker_script(tmp_path, f"""
        import os, sys
        if os.environ["PADDLE_TRAINER_ID"] == "1":
            if os.environ["PDTPU_RESTART_COUNT"] == "0":
                sys.exit(3)
            open({str(marker)!r}, "w").write("restarted")
    """)
    assert launch(script, [], nproc=2, max_restarts=1) == 0
    assert marker.read_text() == "restarted"
    marker.unlink()
    assert launch(script, [], nproc=2, max_restarts=0) == 3
    assert not marker.exists()


def test_launch_prints_flight_dump_path(tmp_path, capfd):
    script = _worker_script(tmp_path, """
        import os, sys
        if os.environ["PADDLE_TRAINER_ID"] == "1":
            sys.exit(5)
    """)
    assert launch(script, [], nproc=2, trace_dir=str(tmp_path / "tr")) == 5
    err = capfd.readouterr().err
    assert "worker rank 1 exited with code 5" in err
    assert "flight.rank1.json" in err


# -- the chaos run ---------------------------------------------------------------

_CHAOS_WORKER = r"""
import json, os, sys, time
sys.path.insert(0, REPO)
sys.modules["jax"] = None                  # the port's workers need no JAX
import numpy as np
import paddle_tpu_torch.static as static
from paddle_tpu_torch.core import device, flags
from paddle_tpu_torch.elastic import checkpoint as eckpt
from paddle_tpu_torch.elastic.membership import ElasticMember
from paddle_tpu_torch.static import layers as L
from paddle_tpu_torch.utils import trace as trace_mod

device.set_device("cpu")
rank = int(os.environ["PADDLE_TRAINER_ID"])
world = int(os.environ["PADDLE_TRAINERS_NUM"])
ckpt_dir, out_dir, init_dir = sys.argv[1], sys.argv[2], sys.argv[3]
STEPS = int(sys.argv[4])
flags.set_flags({"metrics": True})

main, startup = static.Program(), static.Program()
main.random_seed = 7
startup.random_seed = 7
with static.program_guard(main, startup):
    x = L.data("x", [8])
    y = L.data("y", [1])
    pred = L.fc(L.fc(x, 16, act="relu"), 1)
    loss = L.mean(L.square(L.elementwise_sub(pred, y)))
    static.optimizer.SGD(learning_rate=0.05).minimize(loss)

rng = np.random.default_rng(3)
feed = {"x": rng.normal(size=(12, 8)).astype(np.float32),
        "y": rng.normal(size=(12, 1)).astype(np.float32)}

member = ElasticMember.from_env(world_size=world, interval_s=0.1,
                                dead_after_s=1.0).start()
exe = static.Executor()
scope = static.Scope()
with static.scope_guard(scope):
    exe.run(startup)
# every worker starts from the JAX package's initial state
init, _ = eckpt.read_state(init_dir)
assert sorted(init) == sorted(eckpt.scope_state(main, scope)), sorted(init)
eckpt.restore_scope_state(init, scope)
losses = {}
step = 0
while step < STEPS:
    with static.scope_guard(scope):
        out = exe.run(main, feed=feed, fetch_list=[loss])[0]
    losses[step] = float(np.asarray(out))
    member.set_step(step)
    if rank == 0:   # the leader checkpoints every step (and is never killed)
        eckpt.save_checkpoint(ckpt_dir, eckpt.scope_state(main, scope),
                              step, keep_last=6)
    newly = member.detect_and_evict()
    if newly:
        # detect -> record -> evict done: restore the leader's latest
        # checkpoint no later than this rank's own step (the leader may
        # be ahead; world 1 each: no plan) and resume after it
        new_world = member.world_size()
        state = meta = None
        for _ in range(40):   # ride out save/GC races with the leader
            latest = eckpt.latest_step(ckpt_dir)
            try:
                state, meta = eckpt.restore_checkpoint(
                    ckpt_dir, None if latest is None else min(latest, step))
                break
            except eckpt.CheckpointError:
                time.sleep(0.1)
        assert state is not None, "no restorable checkpoint after eviction"
        scope = static.Scope()
        with static.scope_guard(scope):
            exe.run(startup)
        eckpt.restore_scope_state(state, scope)
        member.record_resume(meta["step"], new_world)
        step = meta["step"] + 1
        continue
    step += 1
    time.sleep(0.12)
member.stop()
trace_mod.flight_recorder().dump(
    os.path.join(out_dir, f"flight.rank{rank}.json"))
with open(os.path.join(out_dir, f"losses.rank{rank}.json"), "w") as f:
    json.dump(losses, f)
"""


def _jax_program():
    """The chaos program in the JAX package, under the names a fresh
    process gives it (the workers' names: their checkpoints are keyed by
    them), whatever programs this process built before."""
    import paddle_tpu.static as static
    from paddle_tpu.static import framework as jframework
    from paddle_tpu.static import layers as L

    counters = jframework._unique.counters
    jframework._unique.counters = {}
    try:
        main, startup = static.Program(), static.Program()
        main.random_seed = 7
        startup.random_seed = 7
        with static.program_guard(main, startup):
            x = L.data("x", [8])
            y = L.data("y", [1])
            pred = L.fc(L.fc(x, 16, act="relu"), 1)
            loss = L.mean(L.square(L.elementwise_sub(pred, y)))
            static.optimizer.SGD(learning_rate=0.05).minimize(loss)
    finally:
        jframework._unique.counters = counters
    return static, main, startup, loss


def _reference_losses(steps: int, init_dir: str):
    """The JAX package's single-process trajectory of the chaos program,
    its initial state written to ``init_dir`` for the port's workers."""
    static, main, startup, loss = _jax_program()
    rng = np.random.default_rng(3)
    feed = {"x": rng.normal(size=(12, 8)).astype(np.float32),
            "y": rng.normal(size=(12, 1)).astype(np.float32)}
    scope = static.Scope()
    with static.scope_guard(scope):
        exe = static.Executor()
        exe.run(startup)
        jeckpt.write_state(init_dir, jeckpt.scope_state(main, scope))
        return [float(np.asarray(exe.run(main, feed=feed,
                                         fetch_list=[loss])[0]))
                for _ in range(steps)]


def test_chaos_kill_worker_midrun_survivors_recover(tmp_path):
    steps = 18
    script = tmp_path / "worker.py"
    script.write_text(f"REPO = {str(_REPO)!r}\n" + _CHAOS_WORKER)
    edir, ckpt, out = (tmp_path / n for n in ("membership", "ckpt", "out"))
    for d in (edir, out):
        d.mkdir()
    ref = _reference_losses(steps, str(tmp_path / "init"))
    env_base = dict(os.environ, PDTPU_ELASTIC_DIR=str(edir),
                    PADDLE_TRAINERS_NUM="3", OMP_NUM_THREADS="1",
                    PYTHONPATH=str(_REPO) + os.pathsep
                    + os.environ.get("PYTHONPATH", ""))
    procs = {}
    try:
        for rank in range(3):
            procs[rank] = subprocess.Popen(
                [sys.executable, str(script), str(ckpt), str(out),
                 str(tmp_path / "init"), str(steps)],
                cwd=_REPO, env=dict(env_base, PADDLE_TRAINER_ID=str(rank)),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                start_new_session=True)
        victim_hb = edir / "hb.1.json"
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            assert procs[1].poll() is None, \
                "victim exited before the chaos:\n" + procs[1].stdout.read()
            try:
                if json.loads(victim_hb.read_text())["step"] >= 4:
                    break
            except (OSError, ValueError, KeyError):
                pass
            time.sleep(0.1)
        else:
            pytest.fail("victim never reached step 4")
        procs[1].send_signal(signal.SIGKILL)
        procs[1].wait(timeout=30)
        for rank in (0, 2):
            rc = procs[rank].wait(timeout=120)
            assert rc == 0, (f"survivor {rank} died:\n"
                             + procs[rank].stdout.read())
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()

    dumps = {}
    for rank in (0, 2):
        losses = json.loads((out / f"losses.rank{rank}.json").read_text())
        assert sorted(int(s) for s in losses) == list(range(steps)), rank
        curve = [losses[str(s)] for s in range(steps)]
        assert curve == pytest.approx(ref, rel=2e-3), rank
        dumps[rank] = json.loads(
            (out / f"flight.rank{rank}.json").read_text())["events"]

    evict_winners = saw_dead = 0
    for rank, events in dumps.items():
        kinds = [e["kind"] for e in events]
        assert "elastic_resume" in kinds and "elastic_restore" in kinds, rank
        assert kinds.index("elastic_restore") < kinds.index("elastic_resume")
        resume = next(e for e in events if e["kind"] == "elastic_resume")
        assert resume["world"] == 2
        if "worker_dead" in kinds:
            saw_dead += 1
            dead_ev = next(e for e in events if e["kind"] == "worker_dead")
            assert dead_ev["worker"] == 1
            assert kinds.index("worker_dead") < kinds.index("elastic_resume")
        if "worker_evicted" in kinds:
            evict_winners += 1
            assert "worker_dead" in kinds, rank
            assert kinds.index("worker_evicted") \
                < kinds.index("elastic_restore")
    assert saw_dead >= 1
    assert evict_winners == 1
    assert (edir / "evicted.1").exists()
    assert "elastic_checkpoint" in [e["kind"] for e in dumps[0]]
