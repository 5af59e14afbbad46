"""Does ``chip_smoke.prefetch_under_load`` catch a broken hand-out?
(PERF.md, section 6.)  Not part of the port: the port imports nothing
here.

``io/prefetch.py``'s ``_handoff`` makes the consumer's stream wait on the
event recorded after a batch's copies and ``record_stream``-s the staged
tensors.  This script runs phase 23's staging check on 48 random
b32 x 256 batches with ``_handoff`` intact, without its ``wait_event``,
without its ``record_stream``, and intact again (the broken versions are
put in at run time; no file changes), and prints one line each: PASSED,
or FAILED with the check's message.  Each broken version should fail.

Run from the root of a checkout on a machine with one H100:

    python3 paddle_tpu_torch/ops/kernels/experiments/prefetch_mutations.py
"""
import os
import sys

import numpy as np
import torch


def no_wait(staged):
    for t, dev in staged.tensors:
        t.record_stream(torch.cuda.current_stream(dev))
    return staged.batch


def no_record(staged):
    for dev, event in staged.events.items():
        torch.cuda.current_stream(dev).wait_event(event)
    return staged.batch


def main():
    if not torch.cuda.is_available():
        print("prefetch_mutations: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from paddle_tpu_torch.io import prefetch

    rng = np.random.default_rng(0)
    batches = [(rng.integers(1, 18000, (32, 256)).astype(np.int32),
                rng.integers(0, 2, 32).astype(np.int64)) for _ in range(48)]
    intact = prefetch._handoff
    for name, handoff in (("intact", intact), ("no wait_event", no_wait),
                          ("no record_stream", no_record),
                          ("intact again", intact)):
        prefetch._handoff = handoff
        try:
            cs.prefetch_under_load(batches, 0)
            print("MUT", name, "PASSED", flush=True)
        except AssertionError as e:
            print("MUT", name, "FAILED:", e, flush=True)
    prefetch._handoff = intact
    return 0


if __name__ == "__main__":
    sys.exit(main())
