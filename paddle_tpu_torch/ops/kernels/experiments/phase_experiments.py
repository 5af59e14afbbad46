"""Step times of ``chip_smoke.py``'s dygraph phases run on their own, to
tell a change of a phase's code from the state an earlier phase leaves
behind (PERF.md, section 6).  Not part of the port: the port imports
nothing here.

Run from the root of a checkout on a machine with one H100:

    python3 paddle_tpu_torch/ops/kernels/experiments/phase_experiments.py \\
        --phases 18
    python3 paddle_tpu_torch/ops/kernels/experiments/phase_experiments.py \\
        --phases 17,18,19 --lac-vocab 20000

It imports ``chip_smoke`` and ``paddle_tpu_torch`` from the current
directory, so an older commit unpacked elsewhere (``git archive``) is
measured by running this file by its path from that tree's root.  As
``chip_smoke.main`` does, it turns TF32 off, builds every kernel and
takes row 11's profile, then runs the named phases in the order given:
17 (ops), 18 (ERNIE fine-tuning), 19 (ERNIE + CRF tagging), 20 (LAC
BiGRU-CRF; ``--lac-vocab`` sets its vocabulary), 21 (ResNet-50), 22
(YOLOv3-DarkNet53), 23 (ERNIE-base IMDB through DataLoader and
hapi.Model), 24 (data-parallel ERNIE-base through the launcher, fleet
and DataParallel), 24probe (each of the port's collectives on CUDA
tensors under gloo on two ranks, ``chip_smoke.dp_probe``: its JSON line
holds each outcome) and 25 (hybrid-parallel ERNIE-base: one NCCL rank,
then four gloo ranks over five meshes, ``chip_smoke.hybrid_phase``).  Each phase keeps its
own checks.  The card's name and power limit are printed first, then one
JSON line a phase: its seconds, step ms, profiled device busy ms and
the objects Python's collector tracks after it.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="18")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lac-vocab", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("phase_experiments: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    cs.stats_profile()
    if args.lac_vocab is not None:
        cs.LAC["vocab"] = args.lac_vocab
    run = {"17": cs.ops_phase, "18": lambda s: cs.finetune_phase(s)[1],
           "19": lambda s: cs.tagging_phase(s)[1],
           "20": lambda s: cs.lac_phase(s),
           "21": cs.resnet_phase, "22": cs.yolo_phase,
           "23": lambda s: cs.hapi_phase(s)[1],
           "24": lambda s: cs.dp_phase(s)[1],
           "25": lambda s: cs.hybrid_phase(s)[2]["world1"],
           "24probe": lambda s: {"gloo_cuda_collectives": cs.dp_probe(
               tempfile.mkdtemp(prefix="dp_probe_"), s)}}
    for phase in args.phases.split(","):
        t0 = time.perf_counter()
        out = run[phase](args.seed)
        torch.cuda.empty_cache()
        line = {"phase": phase, "tree": os.getcwd(),
                "seconds": time.perf_counter() - t0,
                "gc_objects": len(gc.get_objects())}
        if isinstance(out, dict) and "step_ms" in out:
            line.update(step_ms=out["step_ms"],
                        busy_ms=out.get("profile", {}).get("busy_ms"),
                        peak_gib=out.get("peak_gib"),
                        losses=out.get("losses"))
        if phase == "20":
            line["vocab"] = cs.LAC["vocab"]
        if phase == "24probe":
            line.update(out)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
