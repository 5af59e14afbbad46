#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (paddle_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--seed N]

Phases (any failed check raises, so the script exits non-zero):

1. build   -- nvcc builds every kernel source under
              paddle_tpu_torch/ops/kernels/csrc/ for sm_90a, all at once.
2. kernels -- each kernel against its plain PyTorch version on the card at
              the ERNIE-base shapes (b 8, s 512, h 12, d 64, rows 4096 of
              dim 768) in fp32 and bf16: the forwards of attention (A),
              LayerNorm (B) and residual + LayerNorm (C) at dropout 0 and
              (A, C) 0.1, and the three backwards (A at dropout 0.1, C at
              0.1), plus ragged, padded, causal and head_dim-128 attention
              cases forward and backward; each kernel's time beside its
              plain version's, a PyTorch library call's and its bound.
              Then all six kernels in bf16 against their plain versions
              at the training step's own shapes (b 64, s 512; 32768 rows),
              with their times and bounds there.
3. slice   -- serving: full-width ERNIE-base (L12 H768 A12 I3072 V18000,
              random weights from --seed) answers token-id requests of
              mixed lengths, batched and padded at s 128 and s 512: the
              top-1 MLM token at each request's [MASK] and the NSP argmax.
              Checks: 12 / 24 / 2 launches of attention / residual-LN / LN
              per forward, fp32 logits against the plain path (flags off),
              bf16 answers against fp32, and each request's answer alone
              and unpadded against its batched answer.  Then the bf16
              forward's tokens/s at b 8, s 512.
4. train   -- the pretraining step of ``paddle_tpu_torch.entry
              .make_train_step`` (MLM + NSP loss, dropout 0.1, Adam lr 1e-4):
              at L2 b8 s512 in fp32, the loss and every gradient of the
              kernel path against the same step with every kernel wrapper
              swapped for its plain version (same seeds, same masks); then
              full-width ERNIE-base at b64 s512, 76 masked positions, bf16
              compute over fp32 masters: 12 / 12 / 24 / 24 / 2 / 2
              launches of A / A-backward / C / C-backward / B / B-backward
              per step, 25 steps on one batch with a finite, falling loss,
              the step's tokens/s, its MFU (bench.py's analytic FLOPs
              against 989 TF/s) and the peak device memory; then two more
              steps run under torch.profiler and their device time is
              split by kernel and by kind (the port's kernels, cuBLAS
              matrix products, the rest).

Before the last line it prints a ``{"kernels": [...]}`` JSON line and the
card's name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
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
# (bf16 keeps ~3 significant digits).  dw/db sum 4096 rows: relative to
# their largest value.
TOL_FP32 = {"flash_attention_packed": 1e-4, "flash_attention_packed_bwd": 1e-4,
            "layer_norm": 2e-5, "residual_layer_norm": 2e-5,
            "layer_norm_bwd": 2e-5, "residual_layer_norm_bwd": 2e-5}
TOL_BF16_REL = 2e-2
TOL_LSE = 1e-4
TOL_SLICE_FP32_REL = 1e-4    # logits, kernel path vs plain path, fp32
TOL_ALONE_FP32_REL = 1e-4    # logits, alone and unpadded vs batched, fp32
MIN_BF16_AGREE = 0.95
TOL_TRAIN_LOSS_REL = 1e-4    # train step, kernel vs plain wrappers, fp32
TOL_TRAIN_GRAD_REL = 1e-3    # each gradient, of its largest value
KEPT_SHARE, KEPT_BAND = 0.9, 0.005
RATE = 0.1
SEED = 20240611
KERNEL_SHAPE = dict(b=8, s=512, h=12, d=64, dim=768)   # main-path shapes
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 64, 512, 25      # bench.py's TPU run

# The port's kernels in a profile, by names no library kernel has (the
# csrc/*.cu __global__ functions).
PORT_KERNEL = re.compile(r"\b(flash_(fwd|bwd)_(fp32|mma)|flash_bwd_delta|"
                         r"ln_(fwd|bwd|partials_reduce))_kernel\b")

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


def compare(tag, name, got, ref, ref32, dtype, relative=False):
    """Kernel output against the plain version: fp32 max abs error (or
    relative to the largest value) within TOL_FP32[name]; bf16 relative to
    the fp32 plain version within TOL_BF16_REL.  Returns the max abs error
    against the plain version in the same type."""
    err = max_abs(got, ref)
    if dtype == torch.float32:
        e = rel_err(got, ref) if relative else err
        check(e <= TOL_FP32[name], f"{tag}: max {'rel' if relative else 'abs'}"
              f" err {e:.3g} <= {TOL_FP32[name]}")
    else:
        r = rel_err(got, ref32)
        check(r <= TOL_BF16_REL, f"{tag}: rel err vs fp32 plain {r:.3g} <= "
              f"{TOL_BF16_REL} (max abs vs bf16 plain {err:.3g})")
    return err


def randn(gen, shape, dtype, scale=1.0, shift=0.0):
    x = torch.randn(shape, generator=gen, dtype=torch.float32) * scale + shift
    return x.to(dtype).to(DEV)


def dtag(dtype):
    return str(dtype)[6:]


# -- phase 2: kernels ---------------------------------------------------------

def padding_bias(lengths, s):
    bias = torch.zeros(len(lengths), s, dtype=torch.float32)
    for i, n in enumerate(lengths):
        bias[i, n:] = -1e4
    return bias.to(DEV)


def attention_case(fap, gen, b, s, h, d, dtype, causal, lengths=None,
                   rate=0.0, backward=False):
    """Kernel A (forward, and backward with ``backward``) against its plain
    version; returns the inputs and errors."""
    q, k, v, do = (randn(gen, (b, s, h * d), dtype) for _ in range(4))
    bias = padding_bias(lengths or [s] * b, s)
    scale = 1.0 / d ** 0.5
    args = (h, bias, scale, causal, rate, SEED)
    out, lse = fap.flash_attention_packed_fwd(q, k, v, *args)
    torch.cuda.synchronize()
    ref, ref_lse = fap.flash_attention_packed_plain(q, k, v, *args)
    f32 = [t.float() for t in (q, k, v, do)]
    ref32, ref32_lse = fap.flash_attention_packed_plain(*f32[:3], *args)
    tag = (f"attention b{b} s{s} h{h} d{d} {dtag(dtype)} "
           f"causal={int(causal)} dropout={rate}")
    err = compare(tag, fap.KERNEL, out, ref, ref32, dtype)
    lerr = max_abs(lse, ref_lse)
    check(lerr <= TOL_LSE * max(1.0, float(ref32_lse.abs().max())),
          f"{tag}: lse max abs err {lerr:.3g}")
    case = dict(q=q, k=k, v=v, do=do, bias=bias, scale=scale, out=out,
                lse=lse, err=err)
    if backward:
        bargs = (h, scale, causal, rate, SEED)
        grads = fap.flash_attention_packed_bwd(q, k, v, bias, out, lse, do,
                                               *bargs)
        torch.cuda.synchronize()
        refs = fap.flash_attention_packed_bwd_plain(q, k, v, bias, ref,
                                                    ref_lse, do, *bargs)
        refs32 = fap.flash_attention_packed_bwd_plain(
            *f32[:3], bias, ref32, ref32_lse, f32[3], *bargs)
        case["bwd_err"] = max(
            compare(f"{tag} d{name}", fap.KERNEL_BWD, g, r, r32, dtype)
            for name, g, r, r32 in zip("qkv", grads, refs, refs32))
    return case


def ln_case(ln, name, run, plain, plain32, dtype, tag):
    """A LayerNorm kernel's outputs against its plain version: the first
    output elementwise, dw/db (the last two of a backward) relative to their
    largest value, mean/rstd of a forward within 1e-5."""
    got = run()
    torch.cuda.synchronize()
    ref, ref32 = plain(), plain32()
    backward = name.endswith("_bwd")
    n_main = len(got) - 2 if backward else 1
    labels = (["dx", "dres"] if len(got) == 4 else ["dx"]) if backward \
        else ["out"]
    err = 0.0
    for i in range(n_main):
        err = max(err, compare(f"{tag} {labels[i]}", name, got[i], ref[i],
                               ref32[i], dtype))
    if backward:
        for i, label in ((-2, "dw"), (-1, "db")):
            compare(f"{tag} {label}", name, got[i], ref[i], ref32[i], dtype,
                    relative=True)
    else:
        stats = max(max_abs(got[1], ref[1]), rel_err(got[2], ref[2]))
        check(stats <= 1e-5, f"{tag}: mean/rstd err {stats:.3g}")
    return got, err


def profiled_ms(fn, reps=20, warmup=3):
    """Device time per call from torch.profiler: the summed durations of the
    kernels and memsets ``fn`` launches (gaps between them excluded), for a
    call that cannot be captured in a CUDA graph."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(us for us, _, _ in device_events(prof))
    check(us > 0, f"the profiler saw {us:.1f} us of device time")
    return us / 1e3 / reps


def device_events(prof):
    """(device us, count, name) of each kernel a profile recorded."""
    out = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out.append((us, e.count, e.key))
    return out


def timings(run, plain, lib, nbytes, flops, dtype, lib_profiled=False):
    return dict(ms=time_ms(run), eager_ms=eager_ms(run),
                plain_ms=time_ms(plain),
                library_ms=(None if lib is None else
                            profiled_ms(lib) if lib_profiled
                            else time_ms(lib)),
                bound=bound(nbytes, flops, dtype))


def attn_cost(backward, b, s, h, d, elt):
    """(bytes, flops) of kernel A: q, k, v read and o written (and dO, o
    read, dq, dk, dv written for the backward), the fp32 bias and LSE; 4
    b h s^2 d flops forward, 10 backward (S recomputed once)."""
    io = (8 if backward else 4) * b * s * h * d * elt
    return io + b * s * 4 + b * h * s * 4, \
        (10 if backward else 4) * b * h * s * s * d


def ln_cost(name, n, dim, elt):
    """(bytes, flops) of a LayerNorm kernel on (n, dim) rows: its (n, dim)
    tensors read or written once, w and b (or dw and db) and w, fp32 mean
    and rstd, and its flops per value."""
    tensors, vectors, flops = {
        "layer_norm": (2, 2, 8), "layer_norm_bwd": (3, 3, 14),
        "residual_layer_norm": (3, 2, 9),
        "residual_layer_norm_bwd": (5, 3, 16)}[name]
    return (tensors * n * dim * elt + vectors * dim * elt + 8 * n,
            flops * n * dim)


def ln_family(ln, gen, n, dim, dtype):
    """Kernels B and C forward and backward against their plain versions on
    one set of (n, dim) inputs: B forward and backward, C forward at dropout
    0 and RATE, C backward at RATE (with its kept share).  Returns
    ``{key: (run, plain, err)}`` keyed by kernel name, C's dropout forward
    under ``(RDLN, RATE)``, and the inputs."""
    x = randn(gen, (n, dim), dtype, 2.0, 0.5)
    res = randn(gen, (n, dim), dtype, 1.0, -0.25)
    w = randn(gen, (dim,), dtype, 0.1, 1.0)
    bb = randn(gen, (dim,), dtype, 0.1)
    dy = randn(gen, (n, dim), dtype)
    f32 = lambda *ts: [t.float() for t in ts]
    tag = f"{n}x{dim} {dtag(dtype)}"
    cases = {}

    def case(key, name, run, plain, plain32, label=""):
        got, err = ln_case(ln, name, run, plain, plain32, dtype,
                           f"{name} {tag}{label}")
        cases[key] = (run, plain, err)
        return got

    _, mean, rstd = case(
        ln.LN, ln.LN, lambda: ln.layer_norm_fwd(x, w, bb),
        lambda: ln.layer_norm_plain(x, w, bb),
        lambda: ln.layer_norm_plain(*f32(x, w, bb)))
    case(ln.LN_BWD, ln.LN_BWD,
         lambda: ln.layer_norm_bwd(x, w, mean, rstd, dy),
         lambda: ln.layer_norm_bwd_plain(x, w, mean, rstd, dy),
         lambda: ln.layer_norm_bwd_plain(*f32(x, w), mean, rstd, dy.float()))
    case(ln.RDLN, ln.RDLN, lambda: ln.residual_layer_norm_fwd(x, res, w, bb),
         lambda: ln.residual_layer_norm_plain(x, res, w, bb),
         lambda: ln.residual_layer_norm_plain(*f32(x, res, w, bb)))
    cargs = (1e-5, RATE, SEED)
    _, mean_c, rstd_c = case(
        (ln.RDLN, RATE), ln.RDLN,
        lambda: ln.residual_layer_norm_fwd(x, res, w, bb, *cargs),
        lambda: ln.residual_layer_norm_plain(x, res, w, bb, *cargs),
        lambda: ln.residual_layer_norm_plain(*f32(x, res, w, bb), *cargs),
        f" dropout={RATE}")
    bargs = (RATE, SEED)
    got = case(
        ln.RDLN_BWD, ln.RDLN_BWD,
        lambda: ln.residual_layer_norm_bwd(x, res, w, mean_c, rstd_c, dy,
                                           *bargs),
        lambda: ln.residual_layer_norm_bwd_plain(x, res, w, mean_c, rstd_c,
                                                 dy, *bargs),
        lambda: ln.residual_layer_norm_bwd_plain(
            *f32(x, res, w), mean_c, rstd_c, dy.float(), *bargs),
        f" dropout={RATE}")
    kept = float((got[0] != 0).float().mean())
    check(abs(kept - KEPT_SHARE) <= KEPT_BAND,
          f"{ln.RDLN_BWD} {tag}: share of x the kernel kept (dx != 0) "
          f"{kept:.4f} = {KEPT_SHARE} +- {KEPT_BAND}")
    return cases, dict(x=x, w=w, bb=bb, dy=dy)


def kernel_phase(gen):
    from paddle_tpu_torch.ops.kernels import dropout
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fap
    from paddle_tpu_torch.ops.kernels import layer_norm as ln

    F = torch.nn.functional
    b, s, h, d, dim = (KERNEL_SHAPE[k] for k in ("b", "s", "h", "d", "dim"))
    n = b * s
    lengths = [512, 480, 300, 37, 512, 128, 200, 450]
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        log(f"[kernels] {dtype} at b{b} s{s} h{h} d{d}, rows {n} x {dim}")
        elt = torch.tensor([], dtype=dtype).element_size()

        # A: packed flash attention, forward at dropout 0 and 0.1, backward
        a = attention_case(fap, gen, b, s, h, d, dtype, False, lengths)
        qkv = (a["q"], a["k"], a["v"])
        fargs = (h, a["bias"], a["scale"])
        run = lambda: fap.flash_attention_packed_fwd(*qkv, *fargs)
        plain = lambda: fap.flash_attention_packed_plain(*qkv, *fargs)
        split = lambda t: t.reshape(b, s, h, d).transpose(1, 2).contiguous()
        leaf = lambda t: split(t).requires_grad_()
        qh, kh, vh = (split(t) for t in qkv)
        mask = a["bias"][:, None, None, :].to(dtype)
        lib = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                     attn_mask=mask)
        r = timings(run, plain, lib, *attn_cost(False, b, s, h, d, elt),
                    dtype)
        results[(fap.KERNEL, dtype)] = dict(r, err=a["err"])

        ad = attention_case(fap, gen, b, s, h, d, dtype, False, lengths,
                            rate=RATE, backward=True)
        qkv = (ad["q"], ad["k"], ad["v"])
        dargs = (h, ad["bias"], ad["scale"], False, RATE, SEED)
        run = lambda: fap.flash_attention_packed_fwd(*qkv, *dargs)
        results[(fap.KERNEL, dtype)].update(
            dropout_ms=time_ms(run), dropout_err=ad["err"],
            dropout_plain_ms=time_ms(
                lambda: fap.flash_attention_packed_plain(*qkv, *dargs)))
        bargs = (ad["bias"], ad["out"], ad["lse"], ad["do"], h, ad["scale"],
                 False, RATE, SEED)
        run = lambda: fap.flash_attention_packed_bwd(*qkv, *bargs)
        plain = lambda: fap.flash_attention_packed_bwd_plain(*qkv, *bargs)
        qh, kh, vh = (leaf(t) for t in qkv)
        doh = split(ad["do"])
        lib_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                 dropout_p=RATE)
        # an autograd call cannot be graph-captured alone: the profiler
        # gives its device time
        lib = lambda: torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                          retain_graph=True)
        r = timings(run, plain, lib, *attn_cost(True, b, s, h, d, elt),
                    dtype, lib_profiled=True)
        results[(fap.KERNEL_BWD, dtype)] = dict(r, err=ad["bwd_err"],
                                                library_eager_ms=eager_ms(lib))
        del lib_out, lib

        # B: LayerNorm; C: residual + dropout + LayerNorm; and backwards
        cases, t = ln_family(ln, gen, n, dim, dtype)
        x, w, bb, dy = t["x"], t["w"], t["bb"], t["dy"]
        _, mean_l, rstd_l = torch.ops.aten.native_layer_norm(x, [dim], w, bb,
                                                             1e-5)
        libs = {ln.LN: lambda: F.layer_norm(x, (dim,), w, bb, 1e-5),
                ln.LN_BWD: lambda: torch.ops.aten.native_layer_norm_backward(
                    dy, x, [dim], mean_l, rstd_l, w, bb, [True, True, True])}
        for name in (ln.LN, ln.LN_BWD, ln.RDLN, ln.RDLN_BWD):
            run, plain, err = cases[name]
            results[(name, dtype)] = dict(
                timings(run, plain, libs.get(name), *ln_cost(name, n, dim,
                                                             elt), dtype),
                err=err)
        run, plain, err = cases[(ln.RDLN, RATE)]
        results[(ln.RDLN, dtype)].update(
            dropout_ms=time_ms(run), dropout_err=err,
            dropout_plain_ms=time_ms(plain))

    pos = torch.arange(s, device=DEV)
    keep = dropout.keep_mask(SEED, torch.arange(b * h, device=DEV)[:, None,
                                                                  None],
                             pos[:, None], pos[None, :], RATE)
    kept = float(keep.float().mean())
    check(abs(kept - KEPT_SHARE) <= KEPT_BAND,
          f"attention keep mask at b{b} h{h} s{s}: kept share {kept:.4f} = "
          f"{KEPT_SHARE} +- {KEPT_BAND}")

    log("[kernels] edge cases")
    for dtype in (torch.float32, torch.bfloat16):
        for rate, bwd in ((0.0, False), (RATE, True)):
            attention_case(fap, gen, 2, 200, 12, 64, dtype, False, [200, 77],
                           rate, bwd)
            attention_case(fap, gen, 2, 200, 4, 128, dtype, True, [150, 200],
                           rate, bwd)
            attention_case(fap, gen, 1, 77, 2, 64, dtype, True, None, rate,
                           bwd)
            # a row of one key has dS = P (dP - delta) = 0 up to rounding,
            # which bf16 cannot hold to 2e-2: the backward takes 5 keys
            attention_case(fap, gen, 3, 128, 12, 64, dtype, False,
                           [5 if bwd else 1, 128, 64], rate, bwd)
        attention_case(fap, gen, 2, 512, 2, 128, dtype, False, [512, 300],
                       RATE, True)
    x = randn(gen, (256, 128), torch.float32, 1.0, 1000.0)
    w = randn(gen, (128,), torch.float32, 0.1, 1.0)
    z = torch.zeros(128, device=DEV)
    ref = torch.nn.functional.layer_norm(x.double(), (128,), w.double(),
                                         z.double(), 1e-5)
    out, mean, rstd = ln.layer_norm_fwd(x, w, z)
    err = max_abs(out, ref)
    check(err <= 1e-3, f"layer_norm rows of mean 1e3: max abs err vs fp64 "
          f"{err:.3g} <= 1e-3")
    dy = randn(gen, (256, 128), torch.float32)
    got = ln.layer_norm_bwd(x, w, mean, rstd, dy)
    refs = ln.layer_norm_bwd_plain(x, w, mean, rstd, dy)
    err = max(rel_err(g, r) for g, r in zip(got, refs))
    check(err <= 1e-3, f"layer_norm_bwd rows of mean 1e3: rel err vs plain "
          f"{err:.3g} <= 1e-3")
    for (name, dtype), r in results.items():
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        if "library_eager_ms" in r:
            lib += (f" (profiler device time; eager "
                    f"{r['library_eager_ms']:.4f} ms)")
        extra = (f"; dropout {RATE}: {r['dropout_ms']:.4f} ms (plain "
                 f"{r['dropout_plain_ms']:.4f} ms)" if "dropout_ms" in r
                 else "")
        log(f"  {name} {dtag(dtype)}: {r['ms']:.4f} ms (eager "
            f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, library "
            f"{lib}, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}){extra}")
    return results


def train_shape_phase(gen):
    """The six kernels against their plain versions at the bf16 training
    step's own shapes (b TRAIN_BATCH, s TRAIN_SEQ; TRAIN_BATCH * TRAIN_SEQ
    rows), where the wrappers launch other grids than at KERNEL_SHAPE (the
    LayerNorm backwards walk 16 rows a warp, not 2), with the same seeds
    and tolerances; then each kernel's device time and bound there."""
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fap
    from paddle_tpu_torch.ops.kernels import layer_norm as ln

    b, s = TRAIN_BATCH, TRAIN_SEQ
    h, d, dim = (KERNEL_SHAPE[k] for k in ("h", "d", "dim"))
    n, dtype = b * s, torch.bfloat16
    elt = torch.tensor([], dtype=dtype).element_size()
    log(f"[kernels] training shapes, bf16: b{b} s{s} h{h} d{d}, rows {n} x "
        f"{dim}, dropout {RATE}")
    a = attention_case(fap, gen, b, s, h, d, dtype, False,
                       [s] * (b - 2) + [300, 37], rate=RATE, backward=True)
    qkv = (a["q"], a["k"], a["v"])
    fargs = (h, a["bias"], a["scale"], False, RATE, SEED)
    bargs = (a["bias"], a["out"], a["lse"], a["do"], h, a["scale"], False,
             RATE, SEED)
    runs = {fap.KERNEL: (lambda: fap.flash_attention_packed_fwd(*qkv, *fargs),
                         attn_cost(False, b, s, h, d, elt), a["err"]),
            fap.KERNEL_BWD: (
                lambda: fap.flash_attention_packed_bwd(*qkv, *bargs),
                attn_cost(True, b, s, h, d, elt), a["bwd_err"])}
    cases, _ = ln_family(ln, gen, n, dim, dtype)
    cases[ln.RDLN] = cases.pop((ln.RDLN, RATE))
    for name in (ln.LN, ln.LN_BWD, ln.RDLN, ln.RDLN_BWD):
        runs[name] = (cases[name][0], ln_cost(name, n, dim, elt),
                      cases[name][2])
    out = {}
    for name, (run, cost, err) in runs.items():
        out[name] = dict(ms=time_ms(run), bound=bound(*cost, dtype), err=err)
        log(f"  {name} bf16 at the training shapes: {out[name]['ms']:.4f} ms,"
            f" bound {out[name]['bound'][0]:.4f} ms ({out[name]['bound'][1]})"
            f"; max abs err vs bf16 plain {err:.3g}")
    del a, qkv, runs, cases
    torch.cuda.empty_cache()
    return out


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


# -- phase 4: the ERNIE-base pretraining step ---------------------------------

class _GradCapture:
    """An optimizer whose update hands back the gradients, so a train step
    returns them in place of the new parameters."""

    def update(self, grads, state, params, lr=None):
        return grads, state


@contextlib.contextmanager
def plain_wrappers():
    """Every kernel wrapper swapped for its plain version (same arguments),
    as module attributes, so the autograd Functions call the plain
    arithmetic on CUDA tensors."""
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fap
    from paddle_tpu_torch.ops.kernels import layer_norm as ln

    saved = []
    for mod in (fap, ln):
        for k in mod.KERNELS:
            saved.append((mod, k.wrapper.__name__, k.wrapper))
            setattr(mod, k.wrapper.__name__, k.plain)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def pretrain_batch(rng, b, s, vocab, n_mask, pad_rows=0):
    """bench.py's batch: random ids, n_mask masked positions per row with
    random labels, random NSP labels; ``pad_rows`` rows padded from 3/4."""
    ids = rng.integers(5, vocab, (b, s))
    for row in range(pad_rows):
        ids[b - 1 - row, 3 * s // 4:] = 0
    limit = 3 * s // 4 if pad_rows else s
    pos = np.stack([rng.choice(limit, n_mask, replace=False)
                    for _ in range(b)])
    batch = {"input_ids": ids, "token_type_ids": np.zeros((b, s), np.int64),
             "masked_positions": pos,
             "mlm_labels": rng.integers(0, vocab, (b, n_mask)),
             "nsp_labels": rng.integers(0, 2, (b,))}
    return {k: torch.from_numpy(np.asarray(v, np.int64)).to(DEV)
            for k, v in batch.items()}


def profile_steps(step, params, state, batch, gen, steps=2):
    """Device time of ``steps`` train steps by kernel, from torch.profiler:
    the top kernels, the split into the port's kernels / matrix products /
    the rest, and the device's busy share of the wall time (the profiler's
    own host cost is in the wall time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            params, state, _ = step(params, state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((us / 1e3 / steps, count // steps, name)
                      for us, count, name in device_events(prof)),
                     reverse=True)
    kinds = {"port kernels": 0.0, "matrix products": 0.0, "rest": 0.0}
    ours = {}
    for ms, _, name in kernels:
        own = PORT_KERNEL.search(name)
        if own:
            kinds["port kernels"] += ms
            ours[own.group(0)] = ours.get(own.group(0), 0.0) + ms
        elif any(g in name for g in ("gemm", "xmma", "cutlass", "nvjet")):
            kinds["matrix products"] += ms
        else:
            kinds["rest"] += ms
    busy = sum(kinds.values())
    step_ms = wall_ms / steps
    log(f"[profile] per step: device busy {busy:.2f} ms of {step_ms:.2f} ms "
        f"wall (busy share {busy / step_ms:.3f}); "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in kinds.items()))
    log("  port kernels: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in sorted(ours.items(),
                                             key=lambda kv: -kv[1])))
    for ms, count, name in kernels[:20]:
        log(f"  {ms:8.3f} ms  x{count:<4d} {name[:100]}")
    return params, state


def train_phase(seed):
    from paddle_tpu_torch import convert, entry
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.text.ernie import (
        ErnieConfig,
        ErnieForPretraining,
        ErniePretrainingCriterion,
    )

    cfg = ErnieConfig()
    seq = TRAIN_SEQ
    n_mask = max(1, int(seq * 0.15))
    crit = ErniePretrainingCriterion(cfg.vocab_size)
    rng = np.random.default_rng(seed)

    # fp32, L2 b8: kernel wrappers against their plain versions
    small = ErnieConfig(num_hidden_layers=2)
    log(f"[train] fp32 L2 H768 b8 s{seq}, dropout {cfg.hidden_dropout_prob}"
        f"/{cfg.attention_probs_dropout_prob}: kernel path vs plain wrappers")
    model = ErnieForPretraining(small, device=DEV,
                                generator=torch.Generator().manual_seed(seed))
    step = entry.make_train_step(model, crit, _GradCapture())
    batch = pretrain_batch(rng, 8, seq, cfg.vocab_size, n_mask, pad_rows=2)
    params = convert.parameters_dict(model)
    config.reset_counts()
    grads_k, _, loss_k = step(params, None, batch,
                              torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    launched = config.launch_counts()
    check(len(launched) == 6 and min(launched.values()) >= 2,
          f"kernel path launches all six kernels: {launched}")
    config.reset_counts()
    with plain_wrappers():
        grads_p, _, loss_p = step(params, None, batch,
                                  torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    check(not config.launch_counts(), "plain wrappers launch no kernel")
    r = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    check(r <= TOL_TRAIN_LOSS_REL, f"loss {loss_k.item():.6f} vs plain "
          f"{loss_p.item():.6f}: rel err {r:.3g} <= {TOL_TRAIN_LOSS_REL}")
    floor = 1e-4 * max(float(g.abs().max()) for g in grads_p.values())
    worst = max((max_abs(grads_k[k], g) / max(float(g.abs().max()), floor), k)
                for k, g in grads_p.items())
    check(worst[0] <= TOL_TRAIN_GRAD_REL, f"{len(grads_p)} gradients vs "
          f"plain: worst err {worst[0]:.3g} of the gradient's max "
          f"({worst[1]}) <= {TOL_TRAIN_GRAD_REL}")
    del model, step, grads_k, grads_p, params

    # bf16 over fp32 masters, full width, b64: the main path
    b = TRAIN_BATCH
    log(f"[train] bf16 ERNIE-base L{cfg.num_hidden_layers} H"
        f"{cfg.hidden_size} b{b} s{seq}, {n_mask} masked positions, Adam "
        f"lr 1e-4, fp32 masters")
    model = ErnieForPretraining(cfg, device=DEV,
                                generator=torch.Generator().manual_seed(seed))
    params = convert.parameters_dict(model)
    opt = Adam(learning_rate=1e-4)
    state = opt.init(params)
    step = entry.make_train_step(model, crit, opt, torch.bfloat16)
    batch = pretrain_batch(rng, b, seq, cfg.vocab_size, n_mask)
    gen = torch.Generator().manual_seed(seed)
    L = cfg.num_hidden_layers
    expect = {"flash_attention_packed": L, "flash_attention_packed_bwd": L,
              "residual_layer_norm": 2 * L,
              "residual_layer_norm_bwd": 2 * L, "layer_norm": 2,
              "layer_norm_bwd": 2}
    config.reset_counts()
    params, state, loss = step(params, state, batch, gen)
    torch.cuda.synchronize()
    counts = config.launch_counts()
    for name, want in expect.items():
        check(counts.get(name, 0) == want,
              f"{name}: {counts.get(name, 0)} launches in one step ({want})")
    losses = [loss]
    n_steps, warm = TRAIN_STEPS, 5
    for i in range(1, n_steps):
        if i == warm:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
        params, state, loss = step(params, state, batch, gen)
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / (n_steps - warm) * 1e3
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).tolist()
    log(f"  losses: {[round(x, 4) for x in losses]}")
    check(all(np.isfinite(losses)), "losses finite")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    check(last < first and losses[-1] < losses[0],
          f"loss falls: mean of the first 5 steps {first:.4f} -> last 5 "
          f"{last:.4f}")
    tokens = b * seq
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    fwd_per_tok = (L * (8 * H * H + 4 * H * I + 4 * seq * H)
                   + n_mask / seq * (2 * H * H + 2 * H * V)
                   + (2 * H * H + 4 * H) / seq)
    toks = tokens / step_ms * 1e3
    mfu = toks * 3 * fwd_per_tok / PEAK_FLOPS[torch.bfloat16]
    params, state = profile_steps(step, params, state, batch, gen)
    log(f"[train] bf16 step b{b} s{seq} (eager, mean of steps {warm}-"
        f"{n_steps - 1}): {step_ms:.2f} ms = {toks:.1f} tokens/s; MFU "
        f"{mfu:.4f} of 989 TF/s (bench.py's analytic FLOPs, "
        f"{3 * fwd_per_tok / 1e6:.1f} MFLOP/token); peak device memory "
        f"{peak / 2 ** 30:.2f} GiB")
    return counts, dict(step_ms=step_ms, tokens_per_s=toks, mfu=mfu,
                        peak_gib=peak / 2 ** 30, losses=losses)


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

    gen = torch.Generator().manual_seed(args.seed)
    results = kernel_phase(gen)
    at_train = train_shape_phase(gen)
    serve_counts, fwd_ms = slice_phase(args.seed)
    per_fwd = {"flash_attention_packed": 12, "residual_layer_norm": 24,
               "layer_norm": 2}
    share = {k: results[(k, torch.bfloat16)]["ms"] * n / fwd_ms
             for k, n in per_fwd.items()}
    log("[slice] share of the bf16 b8 s512 forward's device time: "
        + ", ".join(f"{k} {v:.3f}" for k, v in share.items()))
    counts, train = train_phase(args.seed)

    kernels = []
    for k in fap.KERNELS + ln.KERNELS:
        r = results[(k.name, torch.bfloat16)]
        r32 = results[(k.name, torch.float32)]
        entry = {
            "name": k.name, "route": "cuda",
            "source": f"paddle_tpu_torch/ops/kernels/csrc/{k.source}.cu",
            "replaces": k.replaces, "launches": counts.get(k.name, 0),
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            "dtype": "bfloat16", "eager_ms": r["eager_ms"],
            "fp32_ms": r32["ms"], "fp32_max_abs_err": r32["err"],
            "launches_per": "train step",
            "train_shape_ms": at_train[k.name]["ms"],
            "train_shape_bound_ms": at_train[k.name]["bound"][0],
            "train_shape_max_abs_err": at_train[k.name]["err"]}
        if "library_eager_ms" in r:
            entry.update(library_timing="torch.profiler device time",
                         library_eager_ms=r["library_eager_ms"])
        if k.name in serve_counts:
            entry["serving_launches"] = serve_counts[k.name]
        if "dropout_ms" in r:
            entry.update(dropout=RATE, dropout_ms=r["dropout_ms"],
                         dropout_plain_ms=r["dropout_plain_ms"],
                         dropout_max_abs_err=r["dropout_err"])
        if k.name.endswith("_bwd"):
            entry["dropout"] = RATE if k.name != ln.LN_BWD else 0.0
        kernels.append(entry)
    print(json.dumps({"train": train}), flush=True)
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
