"""Distributed launcher -- ``python -m paddle_tpu_torch.distributed.launch``
(counterpart of paddle_tpu/distributed/launch.py).

Reference parity: python/paddle/distributed/launch.py (:188
``launch_collective`` -- spawns one process per device with
``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINER_ENDPOINTS`` /
``PADDLE_CURRENT_ENDPOINT`` env, watches children and aborts all on
failure, launch_utils.py TrainerProc) and the ``fleetrun`` CLI.

Here a process is one **device**, as in the reference and unlike the JAX
package, whose process is one host (in-process SPMD over the host's
devices).  The launcher

  * exports the trainer-env contract: PADDLE_TRAINER_ID /
    PADDLE_TRAINERS_NUM / PADDLE_TRAINER_ENDPOINTS /
    PADDLE_CURRENT_ENDPOINT / PADDLE_COORDINATOR, PDTPU_TRACE_ID,
    PDTPU_RESTART_COUNT and the PDTPU_*_DIR / telemetry settings as plain
    pass-through, plus MASTER_ADDR / MASTER_PORT for torch.distributed's
    rendezvous (read by ``parallel.mesh.init_parallel_env``, which gives
    rank r card ``r % device_count``: NCCL, or gloo for a process that
    asked for the CPU);
  * spawns and babysits the children: the first failure kills the rest,
    exit codes propagate, and ``max_restarts`` relaunches a dead rank.

All ranks run on this host (127.0.0.1).
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
import uuid
from typing import List, Optional

__all__ = ["launch", "main"]


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(training_script: str, script_args: List[str],
           nproc: int = 1, started_port: Optional[int] = None,
           log_dir: Optional[str] = None, backend_env: str = "",
           trace_dir: Optional[str] = None, max_restarts: int = 0,
           elastic_dir: Optional[str] = None,
           telemetry_port: Optional[int] = None,
           ledger_dir: Optional[str] = None,
           history_dir: Optional[str] = None) -> int:
    """Spawn `nproc` worker processes with the trainer-env contract.
    Returns the first nonzero exit code, or 0.

    Every job mints one trace_id (PDTPU_TRACE_ID) that all ranks share, so
    spans across workers and PS RPCs correlate into a single distributed
    trace (utils/trace.py).  With `trace_dir`, workers additionally get
    PDTPU_TRACE_DIR: each rank atexit-dumps a chrome trace
    (trace.rank<r>.json) and arms a flight-recorder post-mortem
    (flight.rank<r>.json) on crash/SIGTERM once it calls
    ``utils.trace.arm_from_env()`` -- a dead rank leaves more than an exit
    code; the launcher prints that dump's path when a rank dies.

    Elastic relaunch: with ``max_restarts > 0`` a crashed rank is respawned
    in place (same rank env, PDTPU_RESTART_COUNT incremented) up to
    ``max_restarts`` total restarts across the job before the default
    abort-everyone behavior kicks in -- the ref fleet elastic relaunch loop.

    ``elastic_dir`` (PDTPU_ELASTIC_DIR), ``telemetry_port``
    (PDTPU_TELEMETRY_PORT = telemetry_port + rank), ``ledger_dir``
    (PDTPU_LEDGER_DIR) and ``history_dir`` (PDTPU_HISTORY_DIR) pass through
    to the workers as the JAX package's launcher exports them; the elastic
    membership reads PDTPU_ELASTIC_DIR (``elastic.ElasticMember.
    from_env``); the telemetry plane, the ledger and the SLO sampler that
    read the rest are ROADMAP.md Queue 1 item 10."""
    base_port = started_port or _free_port()
    endpoints = ",".join(f"127.0.0.1:{base_port + i}" for i in range(nproc))
    job_trace_id = uuid.uuid4().hex
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
    if elastic_dir:
        os.makedirs(elastic_dir, exist_ok=True)
    if ledger_dir:
        os.makedirs(ledger_dir, exist_ok=True)
    if history_dir:
        os.makedirs(history_dir, exist_ok=True)
    procs: List[subprocess.Popen] = []
    logs = []
    exit_code = 0
    restart_counts = {rank: 0 for rank in range(nproc)}

    def _spawn(rank: int) -> subprocess.Popen:
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(nproc),
            "PADDLE_TRAINER_ENDPOINTS": endpoints,
            "PADDLE_CURRENT_ENDPOINT": f"127.0.0.1:{base_port + rank}",
            "PADDLE_COORDINATOR": f"127.0.0.1:{base_port}",
            # torch.distributed's rendezvous (rank 0's store listens here)
            "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(base_port),
            "PDTPU_TRACE_ID": job_trace_id,
            "PDTPU_RESTART_COUNT": str(restart_counts[rank]),
        })
        if trace_dir:
            env["PDTPU_TRACE_DIR"] = trace_dir
        if elastic_dir:
            env["PDTPU_ELASTIC_DIR"] = elastic_dir
        if telemetry_port:
            env["PDTPU_TELEMETRY_PORT"] = str(int(telemetry_port) + rank)
        if ledger_dir:
            env["PDTPU_LEDGER_DIR"] = ledger_dir
        if history_dir:
            env["PDTPU_HISTORY_DIR"] = history_dir
        for kv in backend_env.split(","):
            if "=" in kv:
                k, v = kv.split("=", 1)
                env[k] = v
        cmd = [sys.executable, "-u", training_script] + list(script_args)
        if log_dir:
            # append so a restarted rank's output lands after its crash log
            out = open(os.path.join(log_dir, f"worker.{rank}.log"), "a")
            logs.append(out)
            p = subprocess.Popen(cmd, env=env, stdout=out,
                                 stderr=subprocess.STDOUT)
        else:
            p = subprocess.Popen(cmd, env=env)
        procs.append(p)
        return p

    def _report_death(rank: int, rc: int) -> None:
        msg = f"[launch] worker rank {rank} exited with code {rc}"
        if trace_dir:
            msg += (" -- flight dump: "
                    + os.path.join(trace_dir, f"flight.rank{rank}.json"))
        print(msg, file=sys.stderr)

    # spawn AND watch under one try/finally: a failure while spawning rank k
    # must not orphan ranks 0..k-1 or leak log handles
    try:
        watching = {rank: _spawn(rank) for rank in range(nproc)}
        restarts_left = max(0, int(max_restarts))

        # watch loop (ref launch_utils.py: abort everyone on first failure;
        # with a restart budget, respawn the dead rank in place first)
        while watching:
            failed = None
            for rank, p in list(watching.items()):
                rc = p.poll()
                if rc is None:
                    continue
                if rc == 0:
                    del watching[rank]
                    continue
                _report_death(rank, rc)
                if restarts_left > 0:
                    restarts_left -= 1
                    restart_counts[rank] += 1
                    print(f"[launch] restarting rank {rank} "
                          f"(restart {restart_counts[rank]}, "
                          f"{restarts_left} left)", file=sys.stderr)
                    watching[rank] = _spawn(rank)
                else:
                    failed = rc
                    break
            if failed is not None:
                exit_code = failed
                alive = [q for q in watching.values() if q.poll() is None]
                for q in alive:
                    q.send_signal(signal.SIGTERM)
                for q in alive:
                    try:  # escalate to SIGKILL if SIGTERM is ignored
                        q.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        q.kill()
                        q.wait()
                watching = {}
            if watching:
                time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    return exit_code


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="Launch one training process per device "
                    "(ref: paddle.distributed.launch / fleetrun)")
    parser.add_argument("--nproc_per_node", "--nprocs", "--nproc", type=int,
                        default=1, dest="nproc",
                        help="worker processes to spawn, one a device")
    parser.add_argument("--started_port", type=int, default=None)
    parser.add_argument("--log_dir", type=str, default=None)
    parser.add_argument("--backend_env", type=str, default="",
                        help="extra env as k=v,k=v passed to workers")
    parser.add_argument("--trace_dir", type=str, default=None,
                        help="directory for per-rank chrome traces + "
                        "flight-recorder post-mortems, exported to "
                        "workers as PDTPU_TRACE_DIR")
    parser.add_argument("--max-restarts", "--max_restarts", type=int,
                        default=0, dest="max_restarts",
                        help="elastic relaunch budget: respawn a crashed "
                        "rank in place up to this many times before "
                        "aborting the job (default 0 = classic "
                        "fail-fast)")
    parser.add_argument("--elastic_dir", type=str, default=None,
                        help="shared membership/heartbeat directory "
                        "exported to workers as PDTPU_ELASTIC_DIR")
    parser.add_argument("--telemetry_port", type=int, default=None,
                        help="base port for the per-rank HTTP telemetry "
                        "plane, exported to rank r as PDTPU_TELEMETRY_PORT "
                        "= telemetry_port + r")
    parser.add_argument("--ledger_dir", type=str, default=None,
                        help="shared directory for per-rank calibration "
                        "ledger JSONL sinks, exported to workers as "
                        "PDTPU_LEDGER_DIR")
    parser.add_argument("--history_dir", type=str, default=None,
                        help="shared directory for per-rank metrics-history "
                        "JSONL mirrors, exported to workers as "
                        "PDTPU_HISTORY_DIR")
    parser.add_argument("training_script")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    return launch(args.training_script, args.script_args, args.nproc,
                  args.started_port, args.log_dir, args.backend_env,
                  args.trace_dir, args.max_restarts, args.elastic_dir,
                  args.telemetry_port, args.ledger_dir,
                  args.history_dir)


if __name__ == "__main__":
    sys.exit(main())
