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
holds each outcome), 25 (hybrid-parallel ERNIE-base: one NCCL rank,
then four gloo ranks over five meshes, ``chip_smoke.hybrid_phase``), 26
(resumable fine-tuning through Model.fit's elastic checkpoints, then a
ZeRO-1 checkpoint of four gloo ranks restored on two,
``chip_smoke.elastic_phase``) and 27 (ERNIE-base with its word
embeddings in a host parameter-server table, and the standby's
failover, ``chip_smoke.heter_ps_phase``) and 28 (a saved-and-reloaded
VGG-16 in fp32 and PTQ int8, the label-semantic-roles db_lstm trained and
its decode reloaded, and the greedy decode on ``while_loop`` and a ``cond``
program, ``chip_smoke.static_book_phase``) and 29 (Faster R-CNN R50-FPN's
proposal and target stage, the static op tail card against CPU and the
three static checkers, ``chip_smoke.static_tail_phase``).  ``paged_split`` profiles
the paged slice's runs (``chip_smoke.slice_device_time``) over its first
32 and its first 16 requests, for each KV type, and prints row 9's
prefill / decode split of each: what ``PAGED_SERVE["profile_requests"]``
trades.  ``paged_read`` profiles one run of the first 32 requests and
reads row 9's split from it twice, from the raw events
(``chip_smoke.raw_events``, as the script does) and from the profiler's
``events()`` / ``key_averages()``, with the seconds each read takes.  ``memcheck_cost`` times phase 28's
host-bound static paths with the Executor's ``check_memory`` hook on and
off, and memcheck's own walk on each program.  ``conv_paths`` times the
port's vision forwards outside autograd (ResNet-50, YOLOv3, the static
VGG-16 at b128 and b8192) with and without the workspace-read chunking of
``conv_workspace.install_chunking``, and lists the signatures it chunked.
Each phase keeps its own checks.  The card's name and power limit are printed first, then one
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

import numpy as np
import torch


def paged_split(cs, seed, counts=(32, 16)):
    """Row 9's device time over the paged slice's first ``n`` requests,
    split into prefill chunks and decode steps, for each ``n`` and KV
    type: totals, ms a launch and the prefill share."""
    import numpy as np

    from paddle_tpu_torch.serving import make_paged_toy_lm

    cfg = cs.PAGED_SERVE
    model = make_paged_toy_lm(vocab=cfg["vocab"], hidden=cfg["hidden"],
                              max_positions=cfg["max_positions"], seed=seed,
                              device=cs.DEV)
    prompts, _ = cs.serve_traffic(np.random.default_rng(seed), cfg)
    cs.serve_once(model, [prompts[0][:40], prompts[1][:300]], cfg)
    out = {}
    for n in counts:
        sub = prompts[:n]
        for kv in ("float32", "int8"):
            tokens = cs.serve_once(model, sub, cfg, kv_dtype=kv)["tokens"]
            r = cs.slice_device_time(model, sub, cfg, kv, tokens)
            out[f"{kv}_{n}"] = dict(
                requests=n, row9_ms=r["row9_ms"], prefill_ms=r["prefill_ms"],
                decode_ms=r["decode_ms"], prefill_chunks=r["prefill_chunks"],
                decode_steps=r["decode_steps"],
                prefill_ms_a_chunk=r["prefill_ms"] / r["prefill_chunks"],
                decode_ms_a_step=r["decode_ms"] / r["decode_steps"],
                prefill_share=r["prefill_ms"] / r["row9_ms"],
                busy_ms=r["busy_ms"])
    return out


def paged_read(cs, seed, n=32):
    """Row 9's split and the busy time of one profiled run, read from the
    raw events and from the profiler's FunctionEvents, each timed."""
    import bisect

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving import PagedKVCache, make_paged_toy_lm

    cfg = cs.PAGED_SERVE
    model = make_paged_toy_lm(vocab=cfg["vocab"], hidden=cfg["hidden"],
                              max_positions=cfg["max_positions"], seed=seed,
                              device=cs.DEV)
    prompts, _ = cs.serve_traffic(np.random.default_rng(seed), cfg)
    cs.serve_once(model, [prompts[0][:40], prompts[1][:300]], cfg)
    cache = PagedKVCache(model, cfg["num_blocks"], cfg["block_size"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cs.serve_once(model, prompts[:n], cfg, ranges=True, cache=cache)
    stop_s = time.perf_counter() - t0
    rng = cs.SLICE_RANGES

    def split(events, ranges):
        starts = sorted(start for start, _ in ranges)
        names = dict(ranges)
        by = dict.fromkeys(rng, 0.0)
        for start, ms in events:
            i = bisect.bisect_right(starts, start) - 1
            if i >= 0:
                by[names[starts[i]]] += ms
        return by

    t0 = time.perf_counter()
    raw = cs.raw_events(prof)
    dev = [(name, start, ns / 1e6) for d, name, start, ns in raw
           if d and name not in rng]
    new = split([(st, ms) for name, st, ms in dev if cs.ROW9.search(name)],
                [(st, name) for d, name, st, _ in raw
                 if not d and name in rng])
    new["busy_ms"] = sum(ms for _, _, ms in dev)
    new["read_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cuda, cpu = (torch.autograd.DeviceType.CUDA,
                 torch.autograd.DeviceType.CPU)
    evs = prof.events()
    old = split([(e.time_range.start, e.time_range.elapsed_us() / 1e3)
                 for e in evs if e.device_type == cuda
                 and cs.ROW9.search(e.name)],
                [(e.time_range.start, e.name) for e in evs
                 if e.name in rng and e.device_type == cpu])
    old["busy_ms"] = sum(e.self_device_time_total
                         for e in prof.key_averages()
                         if e.device_type == cuda and e.key not in rng) / 1e3
    old["read_s"] = time.perf_counter() - t0
    return dict(requests=n, events=len(raw), run_and_stop_s=stop_s,
                raw=new, function_events=old)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def memcheck_cost(cs, seed):
    """Phase 28's host-bound static paths with the Executor's
    ``check_memory`` hook on and off (a fresh Executor each time, so its
    first step pays memcheck's walk): the db_lstm's 4 steps at its fixed
    batch and at 4 batch sizes (a new feed signature each step), its
    crf_decoding program, and the greedy decode at b2 / b64; beside them
    ``memcheck.check_memory``'s own host ms on each program."""
    import paddle_tpu_torch.static as static
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.static import layers as L
    from paddle_tpu_torch.static import memcheck

    ds, batches = cs._srl_batches(seed)
    main, startup, infer, cost, feature, decode = cs._srl_program(
        static, L, len(ds.word_dict), len(ds.predicate_dict), ds.n_labels,
        seed + 280)
    sizes = (7, 8, 9, 10)
    varied = [{k: v[:n] for k, v in b.items()}
              for n, b in zip(sizes, batches)]
    mt = {b: cs._mt_decode_program(static, L, b, seed + 281)
          for b in cs.MT["batches"]}
    rng = np.random.default_rng(seed + 281)
    mt_feed = {}
    for b in cs.MT["batches"]:
        lens = rng.integers(4, cs.MT["src_len"] + 1, b)
        src = rng.integers(2, cs.MT["dict_size"], (b, cs.MT["src_len"]))
        src[np.arange(cs.MT["src_len"])[None, :] >= lens[:, None]] = 0
        mt_feed[b] = {"src_word_id": src.astype(np.int64),
                      "src_len": lens.astype(np.int64)}
    out = {"walk_ms": {}}

    def walk(name, program, feed, fetch):
        shapes = {k: tuple(np.shape(v)) for k, v in feed.items()}
        ms = [_timed(lambda: memcheck.check_memory(
            program, None, shapes, fetch_list=fetch)) for _ in range(3)]
        out["walk_ms"][name] = ms

    walk("db_lstm_step", main, batches[0], [cost.name])
    walk("db_lstm_decode", infer, batches[0], [feature.name, decode.name])
    for b, (prog, _st, ids) in mt.items():
        walk(f"greedy_decode_b{b}", prog, mt_feed[b], [ids.name])
    for rep, on in enumerate((True, False, True, False)):
        flags.set_flags({"check_memory": on})
        tag = f"{'on' if on else 'off'}_{rep}"
        exe, scope = static.Executor(cs.DEV), static.Scope()
        exe.run(startup, scope=scope)
        res = {"fixed_ms": [_timed(lambda f=f: exe.run(
            main, feed=f, fetch_list=[cost], scope=scope))
            for f in batches[:cs.SRL["steps"]]]}
        exe2 = static.Executor(cs.DEV)
        res["varied_ms"] = [_timed(lambda f=f: exe2.run(
            main, feed=f, fetch_list=[cost], scope=scope)) for f in varied]
        exe3 = static.Executor(cs.DEV)
        res["decode_ms"] = [_timed(lambda: exe3.run(
            infer, feed=batches[-1], fetch_list=[feature, decode],
            scope=scope)) for _ in range(3)]
        for b, (prog, st, ids) in mt.items():
            e, sc = static.Executor(cs.DEV), static.Scope()
            e.run(st, scope=sc)
            res[f"greedy_b{b}_ms"] = [_timed(lambda: e.run(
                prog, feed=mt_feed[b], fetch_list=[ids], scope=sc))
                for _ in range(4)]
        out[tag] = res
        del exe, exe2, exe3, scope
    flags.set_flags({"check_memory": True})
    return out


def conv_paths(cs, seed):
    """The port's vision forwards outside autograd with and without
    ``conv_workspace.install_chunking`` (cuDNN over batch chunks where its
    workspace exceeds the output): ms a forward (events, 3 after 3 warm)
    and the signatures chunked.  ResNet-50 b256 224 NHWC and
    YOLOv3-DarkNet53 b64 416 in eval mode (fp32, TF32 off), and phase 28's
    static VGG-16 forward at b128 and at b8192 (phase 29's memcheck
    batch)."""
    import paddle_tpu_torch.static as static
    from paddle_tpu_torch.static import layers as L
    from paddle_tpu_torch.static import nets
    from paddle_tpu_torch.vision import models as M

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import conv_workspace

    gen = torch.Generator(device=cs.DEV).manual_seed(seed)

    def forwards():
        res = {}
        for name, make, shape in (
                ("resnet50_b256", lambda: M.resnet50(
                    num_classes=1000, data_format="NHWC", device=cs.DEV,
                    generator=torch.Generator().manual_seed(seed)),
                 (256, 224, 224, 3)),
                ("yolov3_b64", lambda: M.yolov3_darknet53(
                    num_classes=80, device=cs.DEV,
                    generator=torch.Generator().manual_seed(seed)),
                 (64, 3, 416, 416))):
            model = make()
            model.eval()
            x = torch.randn(shape, device=cs.DEV, generator=gen)
            with torch.no_grad():
                for _ in range(3):
                    model(x)
                res[name] = cs._events_ms(lambda: model(x), 3)
            del model, x
            torch.cuda.empty_cache()
        for b in (128, 8192):
            main, startup, fetches = cs.vgg16_bn_drop(static, L, nets,
                                                      seed + 29)
            test = main.clone(for_test=True)
            scope = cs.bn_state(static, startup, test,
                                np.random.default_rng(seed))
            exe = static.Executor(cs.DEV)
            feed = {"img": torch.randn((b, 3, 32, 32), device=cs.DEV,
                                       generator=gen)}
            for _ in range(3):
                cs.run_static(exe, test, feed, fetches, scope)
            res[f"vgg16_static_b{b}"] = cs._events_ms(
                lambda: cs.run_static(exe, test, feed, fetches, scope), 3)
            del scope, exe, feed
            torch.cuda.empty_cache()
        return res

    out = {}
    for rep, on in enumerate((True, False, True, False)):
        conv_workspace.install_chunking(on)
        res = forwards()
        res["chunked"] = sorted((k[0], k[3], v) for k, v in
                                conv_workspace.install_chunking(False)
                                .items())
        out[f"{'on' if on else 'off'}_{rep}"] = res
    return out


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
           "26": lambda s: cs.elastic_phase(s)[2],
           "27": lambda s: cs.heter_ps_phase(s)[1],
           "28": lambda s: cs.static_book_phase(s)[2],
           "29": lambda s: cs.static_tail_phase(s)[1],
           "24probe": lambda s: {"gloo_cuda_collectives": cs.dp_probe(
               tempfile.mkdtemp(prefix="dp_probe_"), s)},
           "paged_split": lambda s: {"paged_split": paged_split(cs, s)},
           "paged_read": lambda s: {"paged_read": paged_read(cs, s)},
           "memcheck_cost": lambda s: {"memcheck_cost": memcheck_cost(cs, s)},
           "conv_paths": lambda s: {"conv_paths": conv_paths(cs, s)}}
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
        if phase in ("24probe", "paged_split", "paged_read",
                     "memcheck_cost", "conv_paths"):
            line.update(out)
        if phase == "28":
            line["vgg16"] = {k: v for k, v in out["vgg16"].items()
                             if not k.endswith("profile")}
        if phase == "29":
            line.update(out)
        print(json.dumps(line, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
