"""Multi-rank jobs for the port's parallel tests: one job runs the port's
launcher (``python -m paddle_tpu_torch.distributed.launch --nproc N``)
over ``torch_parallel_worker.py`` on gloo on the CPU; every rank runs a
list of named cases and writes each one's arrays to
``<out>/<case>.rank<r>.npz``, which the parametrised tests read.

The children get their own environment (the pytest process's
``os.environ`` is not touched and no process group is created in it),
rendezvous on a free port the launcher picks, and run under a hard
timeout that kills the whole process group, so a hang fails the tests of
one job instead of running out the suite's clock.

The inputs are made from numpy seeds by functions here, which the worker
and the tests both call.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
JOB_TIMEOUT_S = 100


def run_job(out_dir, nproc, cases, timeout=JOB_TIMEOUT_S):
    """Run ``cases`` on ``nproc`` ranks; returns (exit code, seconds, the
    job's log).  Exit code -9 means the timeout killed the job."""
    return run_launcher(
        "paddle_tpu_torch", out_dir,
        ["--nproc", str(nproc), str(WORKER), str(out_dir)] + list(cases),
        timeout)


def run_launcher(package, out_dir, args, timeout=JOB_TIMEOUT_S):
    """``python -m <package>.distributed.launch <args>`` in its own process
    group with its own environment; (exit code, seconds, log)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    log_path = out_dir / f"{package}.job.log"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", f"{package}.distributed.launch"] + list(args)
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=str(ROOT), env=env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = -9
    return rc, time.perf_counter() - t0, log_path.read_text()


def result(out_dir, case, rank):
    path = Path(out_dir) / f"{case}.rank{rank}.npz"
    if not path.exists():
        raise AssertionError(f"case {case} wrote no result for rank {rank}; "
                             f"the job's log:\n"
                             + (Path(out_dir) / "paddle_tpu_torch.job.log")
                             .read_text()[-4000:])
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# -- inputs, made from numpy seeds --------------------------------------------

def rank_array(rank, shape, seed=0, dtype=np.float32):
    rng = np.random.default_rng(1000 * seed + rank)
    return rng.normal(0, 1, shape).astype(dtype)


def compress_input(rank, n=2000, seed=7):
    """A gradient-like vector with a zero block and large outliers."""
    x = rank_array(rank, (n,), seed)
    x[256:512] = 0.0
    x[5] = 40.0 * (rank + 1)
    return x


ERNIE = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
ERNIE_BATCH, ERNIE_SEQ, ERNIE_MASK, ERNIE_STEPS = 4, 16, 3, 3
ERNIE_LR = 1e-3
ERNIE_BUFFER_MB = 0.1      # several buckets for the small model
BN_SHAPE = (4, 3, 5, 5)    # a rank's batch; the full batch is 2 ranks'


def ernie_batch(step):
    """The full pretraining batch of ``step``: every masked label counts
    (no -1), so each rank's half holds the same number of tokens and the
    mean of the ranks' losses is the full batch's loss."""
    rng = np.random.default_rng(100 + step)
    b, s, v = ERNIE_BATCH, ERNIE_SEQ, ERNIE["vocab_size"]
    ids = rng.integers(1, v, (b, s)).astype(np.int64)
    ids[-1, 12:] = 0                                   # a padded row
    tt = np.zeros_like(ids)
    tt[:, 8:] = 1
    pos = np.stack([rng.choice(12, ERNIE_MASK, replace=False)
                    for _ in range(b)]).astype(np.int64)
    return {"input_ids": ids, "token_type_ids": tt, "masked_positions": pos,
            "mlm_labels": rng.integers(0, v, (b, ERNIE_MASK)).astype(np.int64),
            "nsp_labels": rng.integers(0, 2, (b,)).astype(np.int64)}


def metric_inputs(rank):
    rng = np.random.default_rng(50 + rank)
    preds = rng.random(100)
    labels = (preds + rng.normal(0, 0.3, 100) > 0.5).astype(np.int64)
    return dict(correct=float(rank + 3), total=10.0 + rank,
                abserr=float(1.5 * (rank + 1)), sqrerr=float(2.0 + rank),
                value=np.array([rank + 1.0, -2.0 * rank, 0.5]),
                preds=preds, labels=labels)
