"""The port's launcher (``python -m paddle_tpu_torch.distributed.launch``)
against the JAX package's: the children's environment for the same
arguments, a failing rank stopping the job with its exit code, and
``max_restarts`` relaunching a dead rank.  Every job runs in its own
process group under a hard timeout (torch_parallel_job.run_launcher)."""
import json
import textwrap

import pytest

import torch_parallel_job as J

DUMP = """
import json, os, sys
keys = {k: v for k, v in os.environ.items()
        if k.startswith(("PADDLE_", "PDTPU_", "MASTER_")) or k == "EXTRA_K"}
rank = os.environ["PADDLE_TRAINER_ID"]
with open(os.path.join(sys.argv[1], f"env.{sys.argv[2]}.rank{rank}.json"),
          "w") as f:
    json.dump(keys, f)
"""


def _script(tmp_path, name, body):
    path = tmp_path / name
    path.write_text(textwrap.dedent(body))
    return str(path)


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch_env")
    script = _script(tmp, "dump.py", DUMP)
    port = 29400 + 7
    out = {}
    for package in ("paddle_tpu", "paddle_tpu_torch"):
        d = tmp / package
        args = ["--nproc_per_node", "2", "--started_port", str(port),
                "--trace_dir", str(tmp / "trace"), "--elastic_dir",
                str(tmp / "elastic"), "--telemetry_port", "31000",
                "--ledger_dir", str(tmp / "ledger"), "--history_dir",
                str(tmp / "history"), "--backend_env", "EXTRA_K=v1",
                script, str(tmp), package]
        rc, _, log = J.run_launcher(package, d, args)
        assert rc == 0, log[-3000:]
        out[package] = [json.loads((tmp / f"env.{package}.rank{r}.json")
                                   .read_text()) for r in (0, 1)]
    return out


def test_children_get_the_jax_launchers_environment(envs):
    """Every variable the JAX launcher exports, with the same value, except
    the job's random trace id (one 32-hex id shared by the ranks); the port
    adds MASTER_ADDR / MASTER_PORT (the coordinator's address)."""
    for r in (0, 1):
        jax_env, port_env = envs["paddle_tpu"][r], envs["paddle_tpu_torch"][r]
        extra = set(port_env) - set(jax_env)
        assert extra == {"MASTER_ADDR", "MASTER_PORT"}
        assert set(jax_env) <= set(port_env)
        for k, v in jax_env.items():
            if k != "PDTPU_TRACE_ID":
                assert port_env[k] == v, k
        assert port_env["PADDLE_COORDINATOR"] == \
            f"{port_env['MASTER_ADDR']}:{port_env['MASTER_PORT']}"
        assert port_env["PDTPU_TELEMETRY_PORT"] == str(31000 + r)
        assert port_env["PADDLE_TRAINER_ID"] == str(r)
        assert port_env["EXTRA_K"] == "v1"
    ids = {e["PDTPU_TRACE_ID"] for e in envs["paddle_tpu_torch"]}
    assert len(ids) == 1 and len(ids.pop()) == 32


FAIL = """
import os, sys, time
if os.environ["PADDLE_TRAINER_ID"] == "1":
    time.sleep(0.5)
    sys.exit(3)
time.sleep(60)
"""

RESTART = """
import os, sys
rank, count = os.environ["PADDLE_TRAINER_ID"], os.environ["PDTPU_RESTART_COUNT"]
open(os.path.join(sys.argv[1], f"ran.{rank}.{count}"), "w").close()
if rank == "1" and count == "0":
    sys.exit(5)
"""


def test_a_failing_rank_stops_the_job_with_its_exit_code(tmp_path):
    script = _script(tmp_path, "fail.py", FAIL)
    rc, secs, log = J.run_launcher("paddle_tpu_torch", tmp_path,
                                   ["--nproc", "2", script])
    assert rc == 3, log[-2000:]
    assert secs < 30, secs        # rank 0 was stopped, not waited for
    assert "worker rank 1 exited with code 3" in log


@pytest.mark.parametrize("restarts,want_rc", [(1, 0), (0, 5)])
def test_max_restarts_relaunches_a_dead_rank(tmp_path, restarts, want_rc):
    script = _script(tmp_path, "restart.py", RESTART)
    rc, _, log = J.run_launcher(
        "paddle_tpu_torch", tmp_path,
        ["--nproc", "2", "--max_restarts", str(restarts), script,
         str(tmp_path)])
    assert rc == want_rc, log[-2000:]
    ran = sorted(p.name for p in tmp_path.glob("ran.*"))
    want = ["ran.0.0", "ran.1.0"] + (["ran.1.1"] if restarts else [])
    assert ran == want
    if restarts:
        assert "restarting rank 1 (restart 1, 0 left)" in log
