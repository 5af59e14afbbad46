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

Each rank ends with ``shutdown_parallel_env()`` (a barrier, then its
process groups destroyed and collected): a group left for interpreter
exit aborted a rank after its last case now and then.  The check, the
pair job 20 times beside six busy processes::

    python -m pytest tests/test_torch_parallel_teardown.py -m slow

The inputs are made from numpy seeds by functions here, which the worker
and the tests both call.
"""
from __future__ import annotations

import fcntl
import os
import signal
import subprocess
import sys
import tempfile
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


def shared_job(name, nproc, cases, timeout=JOB_TIMEOUT_S):
    """Run ``cases`` on ``nproc`` ranks once per test session, whichever
    test file asks first (files on other xdist workers wait on a lock and
    read the same results); returns (the job's directory, its exit code,
    its log)."""
    run_id = os.environ.get("PYTEST_XDIST_TESTRUNUID") or f"pid{os.getpid()}"
    out = Path(tempfile.gettempdir()) / f"torch_parallel_{run_id}" / name
    out.mkdir(parents=True, exist_ok=True)
    with open(out / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = out / "job.rc"
        if not done.exists():
            rc, _, _ = run_job(out, nproc, cases, timeout)
            done.write_text(str(rc))
        rc = int(done.read_text())
    log = out / "paddle_tpu_torch.job.log"
    return out, rc, log.read_text() if log.exists() else ""


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


# -- model-parallel inputs (tests/test_torch_{ring_attention,pipeline,moe,
# pretrainer}.py) ---------------------------------------------------------

# the 2-rank job that tests/test_torch_{ring_attention,pipeline,moe}.py
# share (shared_job): one launch for the three files
PAIR_CASES = ("coll_grads", "seq_attention", "pipeline", "moe_ep2")


def pair_job():
    return shared_job("pairs", 2, PAIR_CASES)


COLL_SHAPE = (4, 6)
COLL_PERMS = {"ppermute_swap": ((0, 1), (1, 0)), "ppermute_edge": ((0, 1),)}


def coll_ops():
    """(name, input shared by the ranks?, cotangent shared?) of each
    differentiable collective the 2-rank job runs: the sum's backward is
    the identity, so its cotangent is the same on both ranks (the sum is
    consumed the same everywhere); copy_to_group's input is."""
    return (("all_reduce", False, True), ("copy_to_group", True, False),
            ("all_gather", False, False), ("reduce_scatter", False, False),
            ("all_to_all", False, False), ("ppermute_swap", False, False),
            ("ppermute_edge", False, False))


ATTN = dict(b=2, h=4, s=16, d=8)


def attn_inputs(seed=30):
    """Whole q, k, v [b, h, s, d] and a cotangent of the output."""
    rng = np.random.default_rng(seed)
    shape = (ATTN["b"], ATTN["h"], ATTN["s"], ATTN["d"])
    return tuple(rng.normal(0, 1, shape).astype(np.float32)
                 for _ in range(4))


PIPE = dict(blocks=4, d=8, num_micro=4, mb=2, out=3)


def pipe_inputs(seed=40):
    """Stacked blocks {"w": [L, d, d], "b": [L, d]}, a head {"w_out"},
    inputs [num_micro * mb, d] and regression targets."""
    rng = np.random.default_rng(seed)
    L, d = PIPE["blocks"], PIPE["d"]
    n = PIPE["num_micro"] * PIPE["mb"]
    blocks = {"w": rng.normal(0, 0.5, (L, d, d)).astype(np.float32),
              "b": rng.normal(0, 0.1, (L, d)).astype(np.float32)}
    head = {"w_out": rng.normal(0, 0.5, (d, PIPE["out"])).astype(np.float32)}
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    tgt = rng.normal(0, 1, (n, PIPE["out"])).astype(np.float32)
    return blocks, head, x, tgt


MOE = dict(d=8, f=16, experts=4, capacity_factor=2.0, batch=4, seq=8)


def moe_inputs(seed=50):
    """MoEFFN weights {gate_weight, wi, wo}, an input [batch, seq, d] and
    a cotangent of the output."""
    rng = np.random.default_rng(seed)
    d, f, e = MOE["d"], MOE["f"], MOE["experts"]
    w = {"gate_weight": rng.normal(0, 1, (d, e)).astype(np.float32),
         "wi": rng.normal(0, 0.3, (e, d, f)).astype(np.float32),
         "wo": rng.normal(0, 0.3, (e, f, d)).astype(np.float32)}
    shape = (MOE["batch"], MOE["seq"], d)
    return (w, rng.normal(0, 1, shape).astype(np.float32),
            rng.normal(0, 1, shape).astype(np.float32))


HYBRID = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=128,
              max_position_embeddings=64, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
HYBRID_BATCH, HYBRID_SEQ, HYBRID_MASK = 8, 16, 4
# name: (mesh degrees, num_micro, pipeline schedule, moe experts, ZeRO-1)
HYBRID_MESHES = {
    "pp2tp2_gpipe": (dict(pp=2, tp=2), 2, "gpipe", 0, False),
    "pp2tp2_1f1b": (dict(pp=2, tp=2), 4, "1f1b", 0, False),
    "dp2sp2_zero": (dict(dp=2, sp=2), 1, "gpipe", 0, True),
    "tp4": (dict(tp=4), 1, "gpipe", 0, False),
    "ep2sp2_moe": (dict(ep=2, sp=2), 1, "gpipe", 4, False),
}


def hybrid_batch(seed=60):
    """The whole batch (the dryrun's: every masked label counts)."""
    rng = np.random.default_rng(seed)
    b, s, m, v = (HYBRID_BATCH, HYBRID_SEQ, HYBRID_MASK,
                  HYBRID["vocab_size"])
    return {"input_ids": rng.integers(1, v, (b, s)).astype(np.int64),
            "token_type_ids": np.concatenate(
                [np.zeros((b, s // 2)), np.ones((b, s // 2))], 1
            ).astype(np.int64),
            "masked_positions": np.stack([rng.choice(s, m, replace=False)
                                          for _ in range(b)]).astype(np.int64),
            "mlm_labels": rng.integers(0, v, (b, m)).astype(np.int64),
            "nsp_labels": rng.integers(0, 2, (b,)).astype(np.int64)}


def seq_batch():
    """A feed for shard_batch(seq_axis=): tokens whose second dim sp
    divides, one it does not, labels, a batch-1 leaf and a scalar."""
    return {"ids": np.arange(48).reshape(4, 12), "odd": np.ones((4, 5)),
            "labels": np.arange(4), "one": np.ones((1, 12)),
            "s": np.float32(2.0)}


def flat_params(nested):
    return {f"{g}/{k}": v for g, leaves in nested.items()
            for k, v in leaves.items()}


def nested_params(flat):
    out = {}
    for key, v in flat.items():
        g, k = key.split("/", 1)
        out.setdefault(g, {})[k] = v
    return out


# -- elastic checkpoints (tests/test_torch_elastic_checkpoint.py) ------------

# the optimizer slots of elastic_state(): ZeRO-1 splits them over dp
ELASTIC_SLOTS = ("opt/w.m", "opt/b.m")


def elastic_state(seed=90):
    """A flat state: parameters, their moments, a scalar and an int leaf
    that 4 ranks do not divide."""
    rng = np.random.default_rng(seed)
    return {"param/w": rng.normal(size=(64, 16)).astype(np.float32),
            "param/b": rng.normal(size=(16,)).astype(np.float32),
            "opt/w.m": rng.normal(size=(64, 16)).astype(np.float32),
            "opt/b.m": rng.normal(size=(16,)).astype(np.float32),
            "scalar": np.float32(3.5),
            "count": np.arange(6, dtype=np.int32)}
