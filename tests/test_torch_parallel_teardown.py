"""The shared 2-rank job's teardown under load (marked slow: about three
minutes; run it with ``python -m pytest
tests/test_torch_parallel_teardown.py -m slow``).

A rank that ended with a process group still referenced (the port's mesh
holds the DeviceMesh and its groups) had the group destroyed at
interpreter exit, where gloo's threads could still be joinable: the rank
aborted ("terminate called without an active exception", exit -6) after
writing every result, in about one job of six under a 6-worker test load.
``parallel.mesh.shutdown_parallel_env`` (a barrier, then the groups
released, destroyed and collected while the interpreter is whole) ends
the worker; here the pair job's four cases run 20 times beside six busy
processes and every job must exit 0.
"""
import multiprocessing as mp
import time

import pytest

import torch_parallel_job as J


def _spin(seconds):
    end = time.monotonic() + seconds
    x = 0
    while time.monotonic() < end:
        x += 1


@pytest.mark.slow
def test_pair_job_exits_zero_twenty_times_under_load(tmp_path):
    load = [mp.Process(target=_spin, args=(600,), daemon=True)
            for _ in range(6)]
    for p in load:
        p.start()
    rcs = []
    try:
        for i in range(20):
            rc, _, log = J.run_job(tmp_path / f"run{i}", 2, J.PAIR_CASES)
            rcs.append(rc)
            assert rc == 0, (i, log[-3000:])
    finally:
        for p in load:
            p.terminate()
            p.join()
    assert rcs == [0] * 20
