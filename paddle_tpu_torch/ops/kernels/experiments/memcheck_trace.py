"""Device memory of one static ``Executor.run`` op by op, beside
``static.memcheck``'s per-op timeline, for ``chip_smoke.py`` phase 29's
vgg16_bn_drop (PERF.md, section 6).  Not part of the port: the port
imports nothing here.

Run from the root of a checkout on a machine with one CUDA card:

    python3 paddle_tpu_torch/ops/kernels/experiments/memcheck_trace.py \\
        --batch 8192 [--train] [--passes default]

For each op it prints the bytes allocated after the op and the peak
during it (``torch.cuda.reset_peak_memory_stats`` before each op), both
less what was allocated before the run besides the scope's state and the
feed, next to memcheck's resident bytes at that op; then the run's peak
and memcheck's ``peak_bytes`` with their ratio.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--passes", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("memcheck_trace: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    import paddle_tpu_torch.static as static
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.static import executor as ex
    from paddle_tpu_torch.static import layers as L
    from paddle_tpu_torch.static import memcheck, nets

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flags.set_flags({"opt_passes": args.passes})
    main_p, startup, fetches = cs.vgg16_bn_drop(static, L, nets,
                                                args.seed + 29)
    rng = np.random.default_rng(args.seed + 29)
    if args.train:
        with static.program_guard(main_p, startup):
            label = L.data("label", [1], dtype="int64")
            loss = L.mean(L.cross_entropy(
                main_p.global_block().var(fetches[1]), label))
            static.optimizer.Momentum(learning_rate=0.01,
                                      momentum=0.9).minimize(loss)
        program, fetch = main_p, [loss.name]
        scope = static.Scope()
        static.Executor("cuda").run(startup, scope=scope)
    else:
        program, fetch = main_p.clone(for_test=True), fetches
        scope = cs.bn_state(static, startup, program, rng)
    feed = {"img": torch.from_numpy(rng.standard_normal(
        (args.batch, 3, 32, 32)).astype(np.float32)).cuda()}
    if args.train:
        feed["label"] = torch.from_numpy(
            rng.integers(0, 10, (args.batch, 1))).cuda()
    exe = static.Executor("cuda")
    exe.run(program, feed=feed, fetch_list=fetch, scope=scope,
            return_numpy=False)
    torch.cuda.synchronize()
    state = sum(v.numel() * v.element_size()
                for v in (scope.find_var(k) for k in scope.keys()))
    fed = sum(v.numel() * v.element_size() for v in feed.values())
    other = torch.cuda.memory_allocated() - state - fed
    rows = []
    real = ex._run_one

    def traced(program_, block_idx, idx, op, env, seed, step):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        real(program_, block_idx, idx, op, env, seed, step)
        torch.cuda.synchronize()
        if block_idx == 0:
            rows.append((idx, op.type,
                         torch.cuda.memory_allocated() - other,
                         torch.cuda.max_memory_allocated() - other))

    ex._run_one = traced
    torch.cuda.reset_peak_memory_stats()
    exe.run(program, feed=feed, fetch_list=fetch, scope=scope,
            return_numpy=False)
    torch.cuda.synchronize()
    ex._run_one = real
    peak = max(r[3] for r in rows) if rows else 0
    est = memcheck.estimate_peak(
        program, feeds={k: tuple(v.shape) for k, v in feed.items()},
        fetch_list=fetch)
    tl = {i: b for i, _t, b in est.timeline}
    entry = next(iter(exe._cache.values()))
    released = sum(len(r) for r in entry.release)
    gib = 2 ** 30
    print(f"{torch.cuda.get_device_name(0)}; batch {args.batch}, "
          f"{'train step' if args.train else 'forward'}, opt_passes="
          f"{args.passes!r}; state {state / 2**20:.1f} MiB, feed "
          f"{fed / 2**20:.1f} MiB, other resident {other / gib:.3f} GiB; "
          f"names the walk releases {released}; cudnn.benchmark "
          f"{torch.backends.cudnn.benchmark}", flush=True)
    print(f"{'op':>4} {'type':<24} {'after GiB':>10} {'peak GiB':>10} "
          f"{'memcheck GiB':>13}")
    for idx, t, after, pk in rows:
        print(f"{idx:4d} {t:<24} {after / gib:10.3f} {pk / gib:10.3f} "
              f"{tl.get(idx, 0) / gib:13.3f}")
    top = sorted(rows, key=lambda r: -r[3])[:args.top]
    print(json.dumps({"batch": args.batch, "train": args.train,
                      "passes": args.passes, "measured_peak": peak,
                      "estimate_peak": est.peak_bytes,
                      "ratio": est.peak_bytes / peak if peak else None,
                      "state": state, "feed": fed, "other": other,
                      "released_names": released,
                      "top_ops": [(i, t, pk) for i, t, _a, pk in top]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
