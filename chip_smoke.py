#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (paddle_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--seed N]

Phases (any failed check raises, so the script exits non-zero):

1. build   -- nvcc builds every kernel source under
              paddle_tpu_torch/ops/kernels/csrc/ for sm_90a, all at once.
2. kernels -- each kernel against its plain PyTorch version on the card at
              the ERNIE-base serving shapes (b 8, s 512, h 12, d 64, rows
              4096 of dim 768) in fp32 and bf16, plus ragged, padded, causal
              and head_dim-128 attention cases; each kernel's time beside
              its plain version's, a PyTorch library call's and its bound.
3. slice   -- full-width ERNIE-base (L12 H768 A12 I3072 V18000, random
              weights from --seed) answers token-id requests of mixed
              lengths, batched and padded at s 128 and s 512: the top-1 MLM
              token at each request's [MASK] and the NSP argmax.  Checks:
              12 / 24 / 2 launches of attention / residual-LN / LN per
              forward, fp32 logits against the plain path (flags off),
              bf16 answers against fp32, and each request's answer alone
              and unpadded against its batched answer.  Then the bf16
              forward's tokens/s at b 8, s 512.

Before the last line it prints a ``{"kernels": [...]}`` JSON line and the
card's name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Tolerances.  fp32: the kernel and its plain version do the same
# arithmetic in another summation order.  bf16: relative to the largest
# reference value, against the plain version in fp32 on the same inputs
# (bf16 keeps ~3 significant digits).
TOL_FP32 = {"flash_attention_packed": 1e-4, "layer_norm": 2e-5,
            "residual_layer_norm": 2e-5}
TOL_BF16_REL = 2e-2
TOL_LSE = 1e-4
TOL_SLICE_FP32_REL = 1e-4    # logits, kernel path vs plain path, fp32
TOL_ALONE_FP32_REL = 1e-4    # logits, alone and unpadded vs batched, fp32
MIN_BF16_AGREE = 0.95

MASK_ID, CLS_ID, SEP_ID = 3, 1, 2
DEV = "cuda"
REQUEST_LENGTHS = (37, 64, 120, 200, 311, 500)


def log(*args):
    print(*args, flush=True)


def _events_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def eager_ms(fn, reps=20, warmup=3):
    """Per-call time of back-to-back eager calls: the device time, or the
    host's launch time where that is longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return _events_ms(fn, reps)


def time_ms(fn, reps=20, warmup=3, replays=5):
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed, so host launch overhead is not in the number."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, replays) / reps


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


def rel_err(a, ref):
    return max_abs(a, ref) / max(float(ref.float().abs().max()), 1e-30)


def check(ok, what):
    if not ok:
        raise AssertionError(f"chip_smoke check failed: {what}")
    log(f"  ok: {what}")


def randn(gen, shape, dtype, scale=1.0, shift=0.0):
    x = torch.randn(shape, generator=gen, dtype=torch.float32) * scale + shift
    return x.to(dtype).to(DEV)


# -- phase 2: kernels ---------------------------------------------------------

def padding_bias(lengths, s):
    bias = torch.zeros(len(lengths), s, dtype=torch.float32)
    for i, n in enumerate(lengths):
        bias[i, n:] = -1e4
    return bias.to(DEV)


def attention_case(fap, gen, b, s, h, d, dtype, causal, lengths=None):
    """Kernel A against its plain version; returns the numbers."""
    q, k, v = (randn(gen, (b, s, h * d), dtype) for _ in range(3))
    bias = padding_bias(lengths or [s] * b, s)
    scale = 1.0 / d ** 0.5
    out, lse = fap.flash_attention_packed_fwd(q, k, v, h, bias, scale, causal)
    torch.cuda.synchronize()
    ref, ref_lse = fap.flash_attention_packed_plain(q, k, v, h, bias, scale,
                                                    causal)
    ref32, ref32_lse = fap.flash_attention_packed_plain(
        q.float(), k.float(), v.float(), h, bias, scale, causal)
    tag = (f"attention b{b} s{s} h{h} d{d} {str(dtype)[6:]} "
           f"causal={int(causal)}")
    err = max_abs(out, ref)
    if dtype == torch.float32:
        check(err <= TOL_FP32[fap.KERNEL],
              f"{tag}: max abs err {err:.3g} <= {TOL_FP32[fap.KERNEL]}")
    else:
        r = rel_err(out, ref32)
        check(r <= TOL_BF16_REL, f"{tag}: rel err vs fp32 plain {r:.3g} "
              f"<= {TOL_BF16_REL} (max abs vs bf16 plain {err:.3g})")
    lerr = max_abs(lse, ref_lse)
    check(lerr <= TOL_LSE * max(1.0, float(ref32_lse.abs().max())),
          f"{tag}: lse max abs err {lerr:.3g}")
    return dict(q=q, k=k, v=v, bias=bias, scale=scale, err=err)


def kernel_phase(gen):
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fap
    from paddle_tpu_torch.ops.kernels import layer_norm as ln

    b, s, h, d, dim = 8, 512, 12, 64, 768
    n = b * s
    lengths = [512, 480, 300, 37, 512, 128, 200, 450]
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        log(f"[kernels] {dtype} at b{b} s{s} h{h} d{d}, rows {n} x {dim}")
        elt = torch.tensor([], dtype=dtype).element_size()

        # A: packed flash attention
        a = attention_case(fap, gen, b, s, h, d, dtype, False, lengths)
        run = lambda: fap.flash_attention_packed_fwd(
            a["q"], a["k"], a["v"], h, a["bias"], a["scale"])
        plain = lambda: fap.flash_attention_packed_plain(
            a["q"], a["k"], a["v"], h, a["bias"], a["scale"])
        qh, kh, vh = (t.reshape(b, s, h, d).transpose(1, 2).contiguous()
                      for t in (a["q"], a["k"], a["v"]))
        mask = a["bias"][:, None, None, :].to(dtype)
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask)
        nbytes = 4 * b * s * h * d * elt + b * s * 4 + b * h * s * 4
        flops = 4 * b * h * s * s * d
        results[(fap.KERNEL, dtype)] = dict(
            err=a["err"], ms=time_ms(run), eager_ms=eager_ms(run),
            plain_ms=time_ms(plain),
            library_ms=time_ms(lib), bound=bound(nbytes, flops, dtype))

        # B: LayerNorm; C: residual + LayerNorm
        x = randn(gen, (n, dim), dtype, 2.0, 0.5)
        res = randn(gen, (n, dim), dtype, 1.0, -0.25)
        w = randn(gen, (dim,), dtype, 0.1, 1.0)
        bb = randn(gen, (dim,), dtype, 0.1)
        cases = (
            (ln.LN, lambda: ln.layer_norm_fwd(x, w, bb),
             lambda: ln.layer_norm_plain(x, w, bb),
             lambda: ln.layer_norm_plain(x.float(), w.float(), bb.float()),
             lambda: torch.nn.functional.layer_norm(x, (dim,), w, bb, 1e-5),
             2 * n * dim * elt + 2 * dim * elt + 8 * n, 8 * n * dim),
            (ln.RDLN, lambda: ln.residual_layer_norm_fwd(x, res, w, bb),
             lambda: ln.residual_layer_norm_plain(x, res, w, bb),
             lambda: ln.residual_layer_norm_plain(
                 x.float(), res.float(), w.float(), bb.float()),
             None, 3 * n * dim * elt + 2 * dim * elt + 8 * n, 9 * n * dim),
        )
        for name, run, plain, plain32, lib, nbytes, flops in cases:
            got = run()
            torch.cuda.synchronize()
            ref, ref32 = plain(), plain32()
            tag = f"{name} {n}x{dim} {str(dtype)[6:]}"
            err = max_abs(got[0], ref[0])
            if dtype == torch.float32:
                check(err <= TOL_FP32[name],
                      f"{tag}: max abs err {err:.3g} <= {TOL_FP32[name]}")
            else:
                r = rel_err(got[0], ref32[0])
                check(r <= TOL_BF16_REL, f"{tag}: rel err vs fp32 plain "
                      f"{r:.3g} <= {TOL_BF16_REL} (max abs vs bf16 plain "
                      f"{err:.3g})")
            stats = max(max_abs(got[1], ref[1]),
                        rel_err(got[2], ref[2]))
            check(stats <= 1e-5, f"{tag}: mean/rstd err {stats:.3g}")
            results[(name, dtype)] = dict(
                err=err, ms=time_ms(run), eager_ms=eager_ms(run),
                plain_ms=time_ms(plain),
                library_ms=time_ms(lib) if lib else None,
                bound=bound(nbytes, flops, dtype))

    log("[kernels] edge cases")
    for dtype in (torch.float32, torch.bfloat16):
        attention_case(fap, gen, 2, 200, 12, 64, dtype, False, [200, 77])
        attention_case(fap, gen, 2, 200, 4, 128, dtype, True, [150, 200])
        attention_case(fap, gen, 1, 77, 2, 64, dtype, True)
        attention_case(fap, gen, 3, 128, 12, 64, dtype, False, [1, 128, 64])
    x = randn(gen, (256, 128), torch.float32, 1.0, 1000.0)
    w = randn(gen, (128,), torch.float32, 0.1, 1.0)
    z = torch.zeros(128, device=DEV)
    ref = torch.nn.functional.layer_norm(x.double(), (128,), w.double(),
                                         z.double(), 1e-5)
    err = max_abs(ln.layer_norm_fwd(x, w, z)[0], ref)
    check(err <= 1e-3, f"layer_norm rows of mean 1e3: max abs err vs fp64 "
          f"{err:.3g} <= 1e-3")
    for (name, dtype), r in results.items():
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        log(f"  {name} {str(dtype)[6:]}: {r['ms']:.4f} ms (eager "
            f"{r['eager_ms']:.4f} ms), plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
    return results


# -- phase 3: the ERNIE-base serving slice -------------------------------------

def make_requests(rng, vocab):
    reqs = []
    for length in REQUEST_LENGTHS:
        ids = rng.integers(5, vocab, length)
        ids[0], ids[-1] = CLS_ID, SEP_ID
        pos = int(rng.integers(1, length - 1))
        ids[pos] = MASK_ID
        reqs.append((ids.astype(np.int64), pos))
    return reqs


def batches(reqs, edges=(128, 512)):
    """Group requests by the smallest padded length that holds them."""
    out = []
    for lo, hi in zip((0,) + edges[:-1], edges):
        idx = [i for i, (ids, _) in enumerate(reqs) if lo < len(ids) <= hi]
        if not idx:
            continue
        ids = np.zeros((len(idx), hi), np.int64)   # pad_token_id 0
        pos = np.zeros((len(idx), 1), np.int64)
        for row, i in enumerate(idx):
            ids[row, :len(reqs[i][0])] = reqs[i][0]
            pos[row, 0] = reqs[i][1]
        out.append((idx, torch.from_numpy(ids).to(DEV),
                    torch.from_numpy(pos).to(DEV)))
    return out


def serve(model, reqs):
    """Answer every request: (mlm logits at [MASK] (n, V), nsp (n, 2))."""
    mlm = [None] * len(reqs)
    nsp = [None] * len(reqs)
    with torch.inference_mode():
        for idx, ids, pos in batches(reqs):
            logits, seq_rel = model(ids, masked_positions=pos)
            for row, i in enumerate(idx):
                mlm[i] = logits[row, 0].float()
                nsp[i] = seq_rel[row].float()
    return torch.stack(mlm), torch.stack(nsp)


def agree(ref_logits, got_logits, band):
    """Per request: the got top-1 equals the ref top-1, or the ref scores
    the got top-1 within ``band`` of its own top-1 (a tie at this
    precision)."""
    ref_top = ref_logits.argmax(-1)
    got_top = got_logits.argmax(-1)
    exact = ref_top == got_top
    ref_max = ref_logits.gather(-1, ref_top[:, None])[:, 0]
    ref_at_got = ref_logits.gather(-1, got_top[:, None])[:, 0]
    return exact, exact | (ref_max - ref_at_got <= band)


def slice_phase(seed):
    import copy

    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.text.ernie import ErnieConfig, ErnieForPretraining

    cfg = ErnieConfig()
    log(f"[slice] ERNIE-base L{cfg.num_hidden_layers} H{cfg.hidden_size} "
        f"A{cfg.num_attention_heads} I{cfg.intermediate_size} "
        f"V{cfg.vocab_size}, random weights from seed {seed}")
    gen = torch.Generator().manual_seed(seed)
    model = ErnieForPretraining(cfg, device=DEV, generator=gen).eval()
    # weights representable in bf16, so fp32 and bf16 serve one model
    model.to(torch.bfloat16).to(torch.float32)
    reqs = make_requests(np.random.default_rng(seed), cfg.vocab_size)
    n_fwd = len(batches(reqs))
    log(f"  {len(reqs)} requests, lengths {[len(r[0]) for r in reqs]}, "
        f"{n_fwd} padded batches")
    expect = {"flash_attention_packed": cfg.num_hidden_layers,
              "residual_layer_norm": 2 * cfg.num_hidden_layers,
              "layer_norm": 2}

    def counted(m):
        config.reset_counts()
        out = serve(m, reqs)
        torch.cuda.synchronize()
        counts = config.launch_counts()
        for name, per_fwd in expect.items():
            got = counts.get(name, 0)
            check(got == per_fwd * n_fwd, f"{name}: {got} launches in "
                  f"{n_fwd} forwards ({per_fwd} per forward)")
        return out, counts

    # fp32: kernel path vs plain path on the same card
    (mlm32, nsp32), _ = counted(model)
    flags.set_flags({"use_flash_attention": False,
                     "use_fused_layer_norm": False})
    config.reset_counts()
    mlm_p, nsp_p = serve(model, reqs)
    check(not config.launch_counts(), "plain path launches no kernel")
    flags.set_flags({"use_flash_attention": True,
                     "use_fused_layer_norm": True})
    r = max(rel_err(mlm32, mlm_p), rel_err(nsp32, nsp_p))
    check(r <= TOL_SLICE_FP32_REL, f"fp32 logits vs plain path: rel err "
          f"{r:.3g} <= {TOL_SLICE_FP32_REL}")
    check(bool(torch.isfinite(mlm32).all() and torch.isfinite(nsp32).all()),
          "fp32 logits finite")

    # each request alone and unpadded (ragged s) answers as in its batch
    with torch.inference_mode():
        for i, (ids, pos) in enumerate(reqs):
            t = torch.from_numpy(ids)[None].to(DEV)
            p = torch.tensor([[pos]], device=DEV)
            logits, seq_rel = model(t, masked_positions=p)
            r = max(rel_err(logits[0, 0], mlm32[i]),
                    rel_err(seq_rel[0], nsp32[i]))
            check(r <= TOL_ALONE_FP32_REL, f"request {i} (len {len(ids)}) "
                  f"alone and unpadded vs batched: rel err {r:.3g}")

    # bf16 serving: the main path whose launches the kernels line reports
    model16 = copy.deepcopy(model).to(torch.bfloat16)
    (mlm16, nsp16), counts = counted(model16)
    band = max_abs(mlm16, mlm32)
    exact, tie_ok = agree(mlm32, mlm16, band)
    nsp_ok = nsp16.argmax(-1) == nsp32.argmax(-1)
    ok = (tie_ok & nsp_ok).float().mean().item()
    log(f"  answers fp32: mlm {mlm32.argmax(-1).tolist()} nsp "
        f"{nsp32.argmax(-1).tolist()}; bf16: mlm {mlm16.argmax(-1).tolist()} "
        f"nsp {nsp16.argmax(-1).tolist()}")
    log(f"  bf16 vs fp32: max abs logit diff {band:.4g}; mlm top-1 exact "
        f"{exact.float().mean().item():.3f}; nsp {nsp_ok.float().mean().item():.3f}")
    check(ok >= MIN_BF16_AGREE, f"bf16 answers agree with fp32 on {ok:.3f} "
          f"of requests (mlm top-1 equal or within the bf16 logit band) "
          f">= {MIN_BF16_AGREE}")

    # throughput: bf16 forward at b 8, s 512 (4096 tokens), all positions
    ids = torch.randint(5, cfg.vocab_size, (8, 512), generator=gen).to(DEV)
    tokens = ids.numel()
    with torch.inference_mode():
        fwd = lambda: model16(ids)
        for on in (True, False):
            flags.set_flags({"use_flash_attention": on,
                             "use_fused_layer_norm": on})
            eager, graphed = eager_ms(fwd, reps=10), time_ms(fwd, reps=5)
            log(f"[slice] bf16 forward b8 s512, "
                f"{'kernel' if on else 'plain'} path: eager {eager:.3f} ms "
                f"= {tokens / eager * 1e3:.1f} tokens/s; CUDA graph "
                f"{graphed:.3f} ms = {tokens / graphed * 1e3:.1f} tokens/s; "
                f"host-bound share of eager {1 - graphed / eager:.3f}")
            if on:
                fwd_ms = graphed
    flags.set_flags({"use_flash_attention": True,
                     "use_fused_layer_norm": True})
    return counts, fwd_ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only "
              "on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fap
    from paddle_tpu_torch.ops.kernels import layer_norm as ln

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f} s wall: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for name in secs:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    results = kernel_phase(torch.Generator().manual_seed(args.seed))
    counts, fwd_ms = slice_phase(args.seed)
    per_fwd = {"flash_attention_packed": 12, "residual_layer_norm": 24,
               "layer_norm": 2}
    share = {k: results[(k, torch.bfloat16)]["ms"] * n / fwd_ms
             for k, n in per_fwd.items()}
    log("[slice] share of the bf16 b8 s512 forward's device time: "
        + ", ".join(f"{k} {v:.3f}" for k, v in share.items()))

    kernels = []
    for k in fap.KERNELS + ln.KERNELS:
        r = results[(k.name, torch.bfloat16)]
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": f"paddle_tpu_torch/ops/kernels/csrc/{k.source}.cu",
            "replaces": k.replaces, "launches": counts.get(k.name, 0),
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            "dtype": "bfloat16", "eager_ms": r["eager_ms"],
            "fp32_ms": results[(k.name, torch.float32)]["ms"],
            "fp32_max_abs_err": results[(k.name, torch.float32)]["err"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
