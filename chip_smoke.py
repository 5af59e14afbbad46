#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (paddle_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--seed N]

Phases (any failed check raises, so the script exits non-zero):

1. build   -- nvcc builds every kernel source under
              paddle_tpu_torch/ops/kernels/csrc/ for sm_90a, all at once;
              ptxas's register and spill lines are printed, and the count of
              HGMMA (wgmma) instructions cuobjdump finds in each attention
              library and the fused conv's, which must be nonzero (and the
              conv's HMMA, mma.sync, count zero).
2. kernels -- each kernel against its plain PyTorch version on the card at
              the ERNIE-base shapes (b 8, s 512, h 12, d 64, rows 4096 of
              dim 768) in fp32 and bf16: the forwards of attention (A),
              LayerNorm (B) and residual + LayerNorm (C) at dropout 0 and
              (A, C) 0.1, and the three backwards (A at dropout 0.1, C at
              0.1), plus ragged, padded, causal and head_dim-128 attention
              cases forward and backward; each kernel's time beside its
              plain version's, a PyTorch library call's and its bound;
              the LayerNorm backwards' dw and db repeat bit for bit.
              Then all six kernels in bf16 against their plain versions
              at the training step's own shapes (b 64, s 512; 32768 rows),
              the four LayerNorm kernels in fp32 too, and the (b, h, s, d)
              kernels of phase 5 there, on the split-head route's views
              (dropout 0.1, ragged keys), with their times and bounds
              there and aten's LayerNorm backward beside row 6.
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
5. bhsd    -- the (batch, heads, seq, head_dim) flash-attention kernels
              (rows 3-4; the packed kernel's sources with other strides):
              (a) forward and backward against their plain versions in
              fp32 and bf16 at ERNIE-base's attention (b8 h12 s512 d64,
              ragged keys, dropout 0 and 0.1), GPT-2 XL's (b2 h25 s1024
              d64, causal), LLaMA-2-7B's (b1 h32 s4096 d128, causal),
              Gemma-7B's (b1 h16 s2048 d256), d192 (b2 h3 s256) and the
              wide heads d320 and d512 (b2 h2 s256, d512 causal; ragged
              keys, dropout 0 and 0.1), each backward run twice and held bit
              for bit; (b) the ERNIE-base fp32 case at dropout 0.1
              against kernel A on the same inputs in packed layout (out,
              lse, dq, dk, dv within 1e-4: one mask key); (c) each case's
              times beside the plain version, SDPA (backend named) and the
              bound; (d) full-width ERNIE-base through MultiHeadAttention's
              split-head route (the packed layout gate swapped for one that
              refuses every layout): the bf16 b8 s512 forward (12 / 0
              launches of the (b, h, s, d) / packed forward, logits against
              the packed route), the fp32 L2 b8 step at dropout 0.1 against
              the packed route (loss and every gradient), and 5 bf16 b64
              s512 steps (12 / 12 launches, falling loss, tokens/s beside
              the packed route's).
6. paged   -- (a) the paged-attention kernel against its plain version at
              256 rows x 128 blocks of 16 tokens, d 128, ragged lengths
              1..2048 from --seed (and rows of 0, 3, 16, 2048) over a
              32768-block pool, in fp32, bf16 and int8, plus d 32 / block
              8; its times beside its bound and SDPA on pre-gathered K/V.
              (b) the slice: ``PagedDecoder`` serving the paged toy LM at
              vocab 32000, hidden 128, 4096 positions (random weights from
              --seed) from a 16384-block pool, 64 rows, 64-token prefill
              chunks: 96 requests of 16-2048 prompt tokens, 32 of them
              behind one 512-token system prompt, 64 new tokens each.
              Checks: launches = prefill chunks + live decode steps;
              tokens of the kernel path against the plain path and against
              ``dense_reference_decode`` (near-ties excepted); prefix hits,
              and hit requests equal to the same prompts decoded cold;
              int8 KV blocks: kernel path equal to the plain path, and a
              token match rate against fp32 >= 0.9 over the first 8 new
              tokens of each request (the JAX package's gate; the rate over
              all 64 is printed).  Then decode and
              prefill tokens/s, TTFT p50/p99, and the kernel's share of the
              device time over 20 decode steps of 64 rows.

7. vision kernels -- rows 10 and 13 against their plain versions in fp32
              (cuDNN's TF32 off) and bf16: the fused conv + BN + act at
              VGG-16's fused shapes at b128 (128->128 16x16, 256->256 8x8,
              512->512 4x4 and 2x2, 128->256 8x8, 256->512 4x4), a 3x3 s2
              p1, a 1x1 s2 and a 7x7 s2 p3 conv, and every epilogue act at
              a small shape (fp32 within 1e-4 of the largest value, bf16
              2e-2 of the fp32 plain version; every output, split K or
              not, repeats bit for bit on a second call); NHWC pooling at VGG-16's four 2x2/2 max pools,
              a 3x3/2 p1 max, a 2x2/2 and a 3x3/1 p1 non-exclusive avg
              (max bit for bit, avg within 1e-6); each case's CUDA-graph
              and eager times beside the plain version's, the library
              call's (cuDNN on the folded weights; PyTorch's pooling, both
              channels-last) and the bound.
8. static  -- static-graph inference in fp32 through the port's Program,
              layers, Executor and DEFAULT_PIPELINE: bench_vision.py's
              conv tower (ch 128, 32 x 32, b64) and the Paddle book's
              vgg16_bn_drop (b128), startup from --seed, random BN
              statistics, clone(for_test=True).  Checks: 1 / 2 (tower) and
              10 / 4 (VGG) conv / pool kernel launches per forward, zero
              pipeline rollbacks, golden parity of the rewrite against the
              unrewritten program (cuDNN and torch ops; within 1e-4 of
              each fetch's largest value), the kernels against their plain
              versions in the rewritten program, no launches with the
              pipeline off.  Then a profile of one forward with the
              pipeline on and off, and images/s of Executor.run in
              alternating blocks of runs with the pipeline on and off
              (medians and quartile spread).

9. vision train -- the forward of the main (train-mode) programs under
              DEFAULT_PIPELINE in fp32: vgg16_bn_drop (b128, its dropouts
              on) and the conv tower with train-mode BNs (b64, no
              dropout).  Checks: 11 / 2 launches of each of rows 11 and 12
              (train-mode BN statistics; scale + act) per forward, the
              fetches and every running statistic against the same run
              with their plain versions (same seed, same dropout masks)
              within 1e-4 of the largest value, and the tower's golden
              parity against the unfused program.
10. int8 kernels -- rows 11 and 12 against their plain versions in fp32
              and bf16 at VGG-16's train-mode BN shapes at b128 (32768 x
              128, 8192 x 256, 2048 x 512, 512 x 512) and ResNet-50's stage
              1 at b64 (200704 x 256, beyond L2): the sums within 1e-5 of
              the largest, two runs of row 11 bit for bit, row 12 bit for
              bit; times beside the plain versions', torch.var_mean /
              addcmul + relu and the bounds.  Rows 14 and 15 against their
              plain versions (exact sums in float64) with fp32 and bf16
              out: the int8 matmul at
              VGG-16's 512 x 512 fc (b128) and an ERNIE-base FFN shape
              (4096 x 768 -> 3072), the int8 conv at VGG-16's int8 convs
              (b128), the tower's (b64), a 3x3 s2 p1 and a 7x7 s2 p3 conv;
              every epilogue act at a small shape (piecewise-linear acts bit
              for bit); times beside the plain versions', torch._int_mm
              (row 14) or cuDNN on the dequantized operands (row 15,
              context only) and the bounds.
11. int8     -- post-training quantization (one calibration batch) and
              QUANT_INFER_PIPELINE on the conv tower (b64) and vgg16_bn_drop
              (b128) test programs: 1 / 0 and 10 / 2 launches of rows 15 /
              14 per forward, the program against its plain versions and
              against the simulate route (use_pallas_int8 off), the int8
              error against the float program, images/s of the int8
              program against the fp32 program under DEFAULT_PIPELINE in
              alternating blocks, and a profile of one int8 forward.

Before the last line it prints ``{"train": ...}``, ``{"bhsd": ...}``,
``{"paged": ...}``, ``{"static": ...}``, ``{"vision_train": ...}``,
``{"int8": ...}`` and ``{"kernels": [...]}`` JSON lines (one kernel entry
for each of the 15 TPU kernels) and the card's name and power limit; the
last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}

# Tolerances.  fp32: the kernel and its plain version do the same
# arithmetic in another summation order.  bf16: relative to the largest
# reference value, against the plain version in fp32 on the same inputs
# (bf16 keeps ~3 significant digits).  dw/db sum 4096 rows: relative to
# their largest value.
TOL_FP32 = {"flash_attention_packed": 1e-4, "flash_attention_packed_bwd": 1e-4,
            "flash_attention": 1e-4, "flash_attention_bwd": 1e-4,
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
PORT_KERNEL = re.compile(r"\b(flash_(fwd|bwd)(_dkdv|_dq)?_(fp32|wgmma)|flash_bwd_delta|"
                         r"ln_(fwd|bwd|partials_reduce)|paged_attn|"
                         r"conv2d_bn_act(_fp32|_wgmma|_split_sum)?|pool2d_nhwc|"
                         r"bn_stats_(partial|"
                         r"reduce)|bn_scale_act|int8_(matmul|conv))_kernel\b")

# Paged attention (phase 5).  Tolerances: fp32 and int8 against the plain
# version on the same blocks with rtol = atol = 2e-5 (tests/test_paged.py's
# kernel check); bf16 relative to the fp32 plain version on the same values.
# Token checks: a differing greedy token must be a near-tie, the top-2
# logit gap of the context below NEAR_TIE_REL of the top logit.
PAGED_KERNEL_SHAPE = dict(num_seqs=256, max_blocks=128, block_size=16,
                          d=128, max_len=2048)
PAGED_SERVE = dict(vocab=32000, hidden=128, max_positions=4096,
                   num_blocks=16384, block_size=16, max_seqs=64,
                   max_blocks_per_seq=256, prefill_chunk=64, requests=96,
                   shared=32, system_len=512, prompt_lo=16, prompt_hi=2048,
                   max_new=64, oracle=4, cold=4, int8_probe=12,
                   profile_prompt=1024, profile_steps=20)
TOL_PAGED_FP32 = 2e-5
TOL_PAGED_BF16_REL = 2e-2
NEAR_TIE_REL = 1e-4
PAGED_MAX_DIFFERING = 1      # requests, kernel path vs plain path
# int8 KV against fp32: the JAX package's gate (tests/test_paged.py:343-356)
# is a token match rate >= 0.9 over 8 new tokens a request.  Greedy decode
# diverges for good after the first flip, so over 64 tokens the rate also
# measures how long the streams run; the gate is taken over the first 8
# and the whole-stream rate is printed beside it.
MIN_INT8_MATCH = 0.9
INT8_GATE_TOKENS = 8
# Each int8 stream's first flip away from fp32 must be at a near-tie of the
# fp32 logits: the top-2 gap below this share of the top logit (the H100
# readings at seed 0 reach 1.25e-2).  The int8 pool itself is checked value
# by value in int8_kv_check, so a store or scale fault fails there.
INT8_FLIP_GAP_REL = 2e-2

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
        again = run()
        check(all(torch.equal(g, a) for g, a in zip(got[-2:], again[-2:])),
              f"{tag}: dw and db repeat bit for bit on a second call")
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


def attn_cost(backward, b, s, h, d, elt, causal=False):
    """(bytes, flops) of attention in either layout: q, k, v read and o
    written (and dO, o read, dq, dk, dv written for the backward), the fp32
    bias and LSE; 4 b h s^2 d flops forward, 10 backward (S recomputed
    once), over the s (s + 1) / 2 scores a causal mask leaves."""
    io = (8 if backward else 4) * b * s * h * d * elt
    scores = s * (s + 1) // 2 if causal else s * s
    return io + b * s * 4 + b * h * s * 4, \
        (10 if backward else 4) * b * h * scores * d


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
    """The main path's kernels against their plain versions at the bf16
    training step's own shapes (b TRAIN_BATCH, s TRAIN_SEQ; TRAIN_BATCH *
    TRAIN_SEQ rows), where the wrappers launch other grids than at
    KERNEL_SHAPE (the LayerNorm backwards' warps walk ~8 rows each, not 1-2;
    the attention backwards' delta pre-pass covers b * h * s rows), with
    the same seeds and tolerances: kernel A and A-backward, the (b, h, s,
    d) kernels on the split-head route's views, and the four LayerNorm
    kernels in bf16 and fp32 (dw/db bit for bit across two calls); then
    each kernel's device time and bound there, and aten's LayerNorm
    backward beside row 6."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fap
    from paddle_tpu_torch.ops.kernels import layer_norm as ln

    b, s = TRAIN_BATCH, TRAIN_SEQ
    h, d, dim = (KERNEL_SHAPE[k] for k in ("h", "d", "dim"))
    n, dtype = b * s, torch.bfloat16
    elt = torch.tensor([], dtype=dtype).element_size()
    log(f"[kernels] training shapes, bf16: b{b} s{s} h{h} d{d}, rows {n} x "
        f"{dim}, dropout {RATE}")
    lengths = [s] * (b - 2) + [300, 37]
    a = attention_case(fap, gen, b, s, h, d, dtype, False, lengths,
                       rate=RATE, backward=True)
    qkv = (a["q"], a["k"], a["v"])
    fargs = (h, a["bias"], a["scale"], False, RATE, SEED)
    bargs = (a["bias"], a["out"], a["lse"], a["do"], h, a["scale"], False,
             RATE, SEED)
    runs = {fap.KERNEL: (lambda: fap.flash_attention_packed_fwd(*qkv, *fargs),
                         attn_cost(False, b, s, h, d, elt), a["err"]),
            fap.KERNEL_BWD: (
                lambda: fap.flash_attention_packed_bwd(*qkv, *bargs),
                attn_cost(True, b, s, h, d, elt), a["bwd_err"])}
    c = bhsd_case(fa, gen, b, h, s, d, dtype, False, lengths, RATE,
                  f"(b, h, s, d) attention on split-head views b{b} h{h} "
                  f"s{s} d{d} bf16 dropout={RATE}", split=True)
    runs[fa.KERNEL] = (
        lambda: fa.flash_attention_fwd(c["q"], c["k"], c["v"], *c["fargs"]),
        attn_cost(False, b, s, h, d, elt), c["err"])
    runs[fa.KERNEL_BWD] = (
        lambda: fa.flash_attention_bwd(c["q"], c["k"], c["v"], c["bias"],
                                       c["out"], c["lse"], c["do"],
                                       *c["bargs"]),
        attn_cost(True, b, s, h, d, elt), c["bwd_err"])
    out = {}
    for name, (run, cost, err) in runs.items():
        out[name] = dict(ms=time_ms(run), bound=bound(*cost, dtype), err=err)
        log(f"  {name} bf16 at the training shapes: {out[name]['ms']:.4f} ms,"
            f" bound {out[name]['bound'][0]:.4f} ms ({out[name]['bound'][1]})"
            f"; max abs err vs bf16 plain {err:.3g}")
    del a, c, qkv, runs
    torch.cuda.empty_cache()
    # The LayerNorms in bf16 (the step's type) and fp32, with aten's
    # LayerNorm backward beside row 6.  The fp32 inputs come from a
    # generator of their own, so the later phases draw what they drew
    # before this case was added.
    for ln_dtype, ln_gen in ((torch.bfloat16, gen),
                             (torch.float32,
                              torch.Generator().manual_seed(SEED))):
        ln_elt = torch.tensor([], dtype=ln_dtype).element_size()
        cases, t = ln_family(ln, ln_gen, n, dim, ln_dtype)
        cases[ln.RDLN] = cases.pop((ln.RDLN, RATE))
        _, mean_l, rstd_l = torch.ops.aten.native_layer_norm(
            t["x"], [dim], t["w"], t["bb"], 1e-5)
        lib = lambda: torch.ops.aten.native_layer_norm_backward(
            t["dy"], t["x"], [dim], mean_l, rstd_l, t["w"], t["bb"],
            [True, True, True])
        for name in (ln.LN, ln.LN_BWD, ln.RDLN, ln.RDLN_BWD):
            run, _, err = cases[name]
            r = dict(ms=time_ms(run),
                     bound=bound(*ln_cost(name, n, dim, ln_elt), ln_dtype),
                     err=err)
            if name == ln.LN_BWD:
                r["library_ms"] = time_ms(lib)
            key = name if ln_dtype == torch.bfloat16 else (name, ln_dtype)
            out[key] = r
            extra = (f", library (aten native_layer_norm_backward) "
                     f"{r['library_ms']:.4f} ms" if "library_ms" in r else "")
            log(f"  {name} {dtag(ln_dtype)} at the training shapes: "
                f"{r['ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
                f"({r['bound'][1]}){extra}; max abs err vs plain {err:.3g}")
        del cases, t, lib
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
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fap
    from paddle_tpu_torch.ops.kernels import layer_norm as ln

    saved = []
    for mod in (fa, fap, ln):
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


def steps_agree(loss, grads, loss_ref, grads_ref, ref_name):
    """One fp32 train step's loss and every gradient against another run of
    the step: the loss within TOL_TRAIN_LOSS_REL, each gradient within
    TOL_TRAIN_GRAD_REL of its largest value (floored at 1e-4 of the largest
    gradient of all: the key-projection bias's is rounding noise)."""
    r = abs(loss.item() - loss_ref.item()) / abs(loss_ref.item())
    check(r <= TOL_TRAIN_LOSS_REL, f"loss {loss.item():.6f} vs {ref_name} "
          f"{loss_ref.item():.6f}: rel err {r:.3g} <= {TOL_TRAIN_LOSS_REL}")
    floor = 1e-4 * max(float(g.abs().max()) for g in grads_ref.values())
    worst = max((max_abs(grads[k], g) / max(float(g.abs().max()), floor), k)
                for k, g in grads_ref.items())
    check(worst[0] <= TOL_TRAIN_GRAD_REL, f"{len(grads_ref)} gradients vs "
          f"{ref_name}: worst err {worst[0]:.3g} of the gradient's max "
          f"({worst[1]}) <= {TOL_TRAIN_GRAD_REL}")


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
    steps_agree(loss_k, grads_k, loss_p, grads_p, "plain")
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


# -- phase 5: (b, h, s, d) flash attention and the split-head route ---------

# (label, b, h, s, d, causal, key lengths (None: all s), dropout rates): the
# (b, h, s, d) kernels at ERNIE-base's attention, GPT-2 XL's 25 heads of 64
# (causal), LLaMA-2-7B's 32 heads of 128 at 4096 (causal), Gemma-7B's 16
# heads of 256, and heads of 192, 320 and 512 (the column-split route above
# 256) at a small size.
BHSD_CASES = (
    ("ERNIE-base", 8, 12, 512, 64, False,
     (512, 480, 300, 37, 512, 128, 200, 450), (0.0, RATE)),
    ("GPT-2 XL", 2, 25, 1024, 64, True, None, (0.0,)),
    ("LLaMA-2-7B", 1, 32, 4096, 128, True, None, (0.0,)),
    ("Gemma-7B", 1, 16, 2048, 256, False, None, (0.0,)),
    ("d192", 2, 3, 256, 192, False, (256, 100), (0.0, RATE)),
    ("d320", 2, 2, 256, 320, False, (256, 100), (0.0, RATE)),
    ("d512", 2, 2, 256, 512, True, (256, 180), (0.0, RATE)),
)
TOL_KERNEL_A = 1e-4   # fp32: (b, h, s, d) kernels vs kernel A, same inputs
BHSD_TRAIN_STEPS = 5


def bhsd_case(fa, gen, b, h, s, d, dtype, causal, lengths, rate, tag,
              split=False):
    """The (b, h, s, d) forward and backward kernels against their plain
    versions (fp32 max abs, bf16 relative to the fp32 plain version, LSE);
    returns the inputs, outputs and errors.  With ``split``, q, k, v and dO
    are what the split-head route gives the kernels: (b, h, s, d) views of
    (b, s, h*d) tensors; else contiguous (b, h, s, d) tensors."""
    if split:
        q, k, v, do = (randn(gen, (b, s, h, d), dtype).transpose(1, 2)
                       for _ in range(4))
    else:
        q, k, v, do = (randn(gen, (b, h, s, d), dtype) for _ in range(4))
    bias = padding_bias(lengths or [s] * b, s)
    scale = d ** -0.5
    fargs = (bias, scale, causal, rate, SEED)
    out, lse = fa.flash_attention_fwd(q, k, v, *fargs)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_fwd_plain(q, k, v, *fargs)
    f32 = [t.float() for t in (q, k, v, do)]
    ref32, ref32_lse = fa.flash_attention_fwd_plain(*f32[:3], *fargs)
    err = compare(tag, fa.KERNEL, out, ref, ref32, dtype)
    lerr = max_abs(lse, ref_lse)
    check(lerr <= TOL_LSE * max(1.0, float(ref32_lse.abs().max())),
          f"{tag}: lse max abs err {lerr:.3g}")
    bargs = (scale, causal, rate, SEED)
    grads = fa.flash_attention_bwd(q, k, v, bias, out, lse, do, *bargs)
    torch.cuda.synchronize()
    refs = fa.flash_attention_bwd_plain(q, k, v, bias, ref, ref_lse, do,
                                        *bargs)
    refs32 = fa.flash_attention_bwd_plain(*f32[:3], bias, ref32, ref32_lse,
                                          f32[3], *bargs)
    bwd_err = max(compare(f"{tag} d{name}", fa.KERNEL_BWD, g, r, r32, dtype)
                  for name, g, r, r32 in zip("qkv", grads, refs, refs32))
    again = fa.flash_attention_bwd(q, k, v, bias, out, lse, do, *bargs)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(grads, again)),
          f"{tag}: a second backward on the same inputs gives the same dq, "
          f"dk, dv bit for bit")
    return dict(q=q, k=k, v=v, do=do, bias=bias, fargs=fargs, bargs=bargs,
                out=out, lse=lse, grads=grads, err=err, bwd_err=bwd_err)


def sdpa_mask(c, causal, dtype):
    """SDPA's arguments for case ``c``'s masking: is_causal, or the key
    bias as a (b, 1, 1, s) float mask."""
    if causal:
        return dict(is_causal=True)
    return dict(attn_mask=c["bias"][:, None, None, :].to(dtype))


def sdpa_backend(q, k, v, mask, rate):
    """The backend SDPA's dispatcher picks for these arguments."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(
        q, k, v, mask.get("attn_mask"), rate,
        mask.get("is_causal", False))).name


def bhsd_fwd_timings(fa, c, b, h, s, d, dtype, causal):
    """The forward kernel's device time on case ``c`` beside its plain
    version's, SDPA's on the same (b, h, s, d) tensors and the bound."""
    q, k, v = c["q"], c["k"], c["v"]
    elt = torch.tensor([], dtype=dtype).element_size()
    mask = sdpa_mask(c, causal, dtype)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, **mask)
    r = timings(lambda: fa.flash_attention_fwd(q, k, v, *c["fargs"]),
                lambda: fa.flash_attention_fwd_plain(q, k, v, *c["fargs"]),
                lib, *attn_cost(False, b, s, h, d, elt, causal), dtype)
    return dict(r, err=c["err"],
                library_backend=sdpa_backend(q, k, v, mask, 0.0))


def bhsd_bwd_timings(fa, c, b, h, s, d, dtype, causal, rate):
    """The backward kernels' device time on case ``c`` beside their plain
    version's, SDPA's backward at the same dropout rate (an autograd call:
    profiler device time) and the bound."""
    q, k, v = c["q"], c["k"], c["v"]
    elt = torch.tensor([], dtype=dtype).element_size()
    bargs = (c["bias"], c["out"], c["lse"], c["do"], *c["bargs"])
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    mask = sdpa_mask(c, causal, dtype)
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, dropout_p=rate, **mask)
    lib = lambda: torch.autograd.grad(lib_out, leaves, c["do"],
                                      retain_graph=True)
    r = timings(lambda: fa.flash_attention_bwd(q, k, v, *bargs),
                lambda: fa.flash_attention_bwd_plain(q, k, v, *bargs),
                lib, *attn_cost(True, b, s, h, d, elt, causal), dtype,
                lib_profiled=True)
    return dict(r, err=c["bwd_err"], dropout=rate,
                library_eager_ms=eager_ms(lib),
                library_backend=sdpa_backend(*leaves, mask, rate))


def kernel_a_cross_check(fa, fap, c, b, h, s, d, rate):
    """The (b, h, s, d) kernels and kernel A on the same fp32 inputs (kernel
    A's in packed layout) with the same seed: out, lse, dq, dk and dv agree
    within TOL_KERNEL_A (both key the dropout mask by batch * heads +
    head)."""
    packed = lambda t: t.transpose(1, 2).reshape(b, s, h * d).contiguous()
    q, k, v, do = (packed(c[n]) for n in ("q", "k", "v", "do"))
    bias, scale, causal, _, _ = c["fargs"]
    out, lse = fap.flash_attention_packed_fwd(q, k, v, h, bias, scale, causal,
                                              rate, SEED)
    grads = fap.flash_attention_packed_bwd(q, k, v, bias, out, lse, do, h,
                                           scale, causal, rate, SEED)
    torch.cuda.synchronize()
    errs = {"out": max_abs(out, packed(c["out"])),
            "lse": max_abs(lse, c["lse"])}
    errs.update({f"d{n}": max_abs(g, packed(mine))
                 for n, g, mine in zip("qkv", grads, c["grads"])})
    for name, e in errs.items():
        check(e <= TOL_KERNEL_A, f"ERNIE-base fp32 dropout {rate}: {name} of "
              f"the (b, h, s, d) kernels vs kernel A: max abs {e:.3g} <= "
              f"{TOL_KERNEL_A}")
    return errs


def bhsd_kernel_phase(gen):
    """(a) each case against the plain versions in fp32 and bf16, forward
    and backward; (b) the ERNIE-base case against kernel A; (c) bf16 times
    (fp32 for ERNIE-base) beside plain, SDPA and the bound."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fap

    results, cross = {}, {}
    for label, b, h, s, d, causal, lengths, rates in BHSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            timed = dtype == torch.bfloat16 or label == "ERNIE-base"
            for rate in rates:
                tag = (f"(b, h, s, d) attention {label} b{b} h{h} s{s} d{d} "
                       f"{dtag(dtype)} causal={int(causal)} dropout={rate}")
                c = bhsd_case(fa, gen, b, h, s, d, dtype, causal, lengths,
                              rate, tag)
                if label == "ERNIE-base" and dtype == torch.float32 \
                        and rate > 0:
                    cross = kernel_a_cross_check(fa, fap, c, b, h, s, d,
                                                 rate)
                fkey, bkey = (label, dtype, "fwd"), (label, dtype, "bwd")
                if timed and rate == 0.0:
                    results[fkey] = bhsd_fwd_timings(fa, c, b, h, s, d,
                                                     dtype, causal)
                elif timed:
                    results[fkey].update(dropout=rate, dropout_ms=time_ms(
                        lambda: fa.flash_attention_fwd(
                            c["q"], c["k"], c["v"], *c["fargs"])))
                if timed and rate == rates[-1]:
                    results[bkey] = bhsd_bwd_timings(fa, c, b, h, s, d,
                                                     dtype, causal, rate)
                del c
            torch.cuda.empty_cache()
    for (label, dtype, kind), r in results.items():
        log(f"  (b, h, s, d) {kind} {label} {dtag(dtype)}: {r['ms']:.4f} ms "
            f"(eager {r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
            f"SDPA {r['library_ms']:.4f} ms ({r['library_backend']}), "
            f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    return results, cross


@contextlib.contextmanager
def split_route():
    """``MultiHeadAttention``'s split-head route for every head layout: the
    packed dispatch's layout gate swapped, as a module attribute, for one
    that refuses every layout (as ``plain_wrappers`` swaps the wrappers)."""
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fap

    saved = fap.head_layout_ok
    fap.head_layout_ok = lambda num_heads, head_dim: False
    try:
        yield
    finally:
        fap.head_layout_ok = saved


def bhsd_model_phase(seed, packed_tokens_per_s):
    """(d) full-width ERNIE-base through the split-head route: the bf16
    serving forward at b8 s512 (launches, logits against the packed route,
    times), the fp32 L2 b8 train step against the packed route (loss and
    every gradient), and the bf16 b64 s512 step (launches, falling loss,
    tokens/s beside the packed route's from phase 4)."""
    from paddle_tpu_torch import convert, entry
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.text.ernie import (
        ErnieConfig,
        ErnieForPretraining,
        ErniePretrainingCriterion,
    )

    cfg = ErnieConfig()
    L, seq = cfg.num_hidden_layers, TRAIN_SEQ
    n_mask = max(1, int(seq * 0.15))
    crit = ErniePretrainingCriterion(cfg.vocab_size)
    rng = np.random.default_rng(seed + 1)
    gen = torch.Generator().manual_seed(seed)
    out = {}

    log(f"[bhsd] ERNIE-base serving forward through the split-head route, "
        f"bf16 b8 s{seq}")
    model = ErnieForPretraining(cfg, device=DEV, generator=gen).eval().to(
        torch.bfloat16)
    ids = torch.randint(5, cfg.vocab_size, (8, seq), generator=gen)
    ids[-2:, 3 * seq // 4:] = 0
    ids = ids.to(DEV)
    fwd = lambda: model(ids)
    with torch.inference_mode():
        ref = fwd()
        graphed = {"packed": time_ms(fwd, reps=5)}
        with split_route():
            config.reset_counts()
            got = fwd()
            torch.cuda.synchronize()
            counts = config.launch_counts()
            graphed["split"] = time_ms(fwd, reps=5)
    check(counts.get("flash_attention", 0) == L
          and counts.get("flash_attention_packed", 0) == 0,
          f"split-head forward: {counts.get('flash_attention', 0)} (b, h, s, "
          f"d) and {counts.get('flash_attention_packed', 0)} packed "
          f"attention launches ({L} and 0)")
    r = max(rel_err(g, p) for g, p in zip(got, ref))
    check(r <= TOL_BF16_REL, f"split-head bf16 logits vs the packed route: "
          f"rel err {r:.3g} <= {TOL_BF16_REL} (bitwise equal: "
          f"{all(torch.equal(g, p) for g, p in zip(got, ref))})")
    tokens = ids.numel()
    for route, ms in graphed.items():
        log(f"  bf16 forward b8 s{seq}, {route} route: CUDA graph {ms:.3f} ms "
            f"= {tokens / ms * 1e3:.1f} tokens/s")
    out["serving"] = dict(launches=counts, graph_ms=graphed,
                          logits_rel_err_vs_packed=r)
    del model, ref, got

    log(f"[bhsd] fp32 L2 b8 s{seq} train step, dropout "
        f"{cfg.attention_probs_dropout_prob}: split-head vs packed route")
    model = ErnieForPretraining(ErnieConfig(num_hidden_layers=2), device=DEV,
                                generator=torch.Generator().manual_seed(seed))
    step = entry.make_train_step(model, crit, _GradCapture())
    batch = pretrain_batch(rng, 8, seq, cfg.vocab_size, n_mask, pad_rows=2)
    params = convert.parameters_dict(model)
    grads_p, _, loss_p = step(params, None, batch,
                              torch.Generator().manual_seed(seed))
    with split_route():
        config.reset_counts()
        grads_s, _, loss_s = step(params, None, batch,
                                  torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        counts = config.launch_counts()
    check(counts.get("flash_attention", 0) == 2
          and counts.get("flash_attention_bwd", 0) == 2
          and not counts.get("flash_attention_packed", 0)
          and not counts.get("flash_attention_packed_bwd", 0),
          f"split-head L2 step launches 2 / 2 (b, h, s, d) kernels, no "
          f"packed one: {counts}")
    steps_agree(loss_s, grads_s, loss_p, grads_p, "the packed route")
    del model, step, grads_p, grads_s, params

    b = TRAIN_BATCH
    log(f"[bhsd] bf16 ERNIE-base b{b} s{seq} train steps through the "
        f"split-head route")
    model = ErnieForPretraining(cfg, device=DEV,
                                generator=torch.Generator().manual_seed(seed))
    params = convert.parameters_dict(model)
    opt = Adam(learning_rate=1e-4)
    state = opt.init(params)
    step = entry.make_train_step(model, crit, opt, torch.bfloat16)
    batch = pretrain_batch(rng, b, seq, cfg.vocab_size, n_mask)
    gen = torch.Generator().manual_seed(seed)
    with split_route():
        config.reset_counts()
        params, state, loss = step(params, state, batch, gen)
        torch.cuda.synchronize()
        counts = config.launch_counts()
        losses = [loss]
        t0 = time.perf_counter()
        for _ in range(1, BHSD_TRAIN_STEPS):
            params, state, loss = step(params, state, batch, gen)
            losses.append(loss)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / (BHSD_TRAIN_STEPS - 1) * 1e3
        log("[bhsd] split-head route, profiled:")
        profile_steps(step, params, state, batch, gen)
    want = {"flash_attention": L, "flash_attention_bwd": L,
            "flash_attention_packed": 0, "flash_attention_packed_bwd": 0}
    for name, n in want.items():
        check(counts.get(name, 0) == n, f"split-head b{b} step: "
              f"{counts.get(name, 0)} launches of {name} ({n})")
    losses = torch.stack(losses).tolist()
    log(f"  losses: {[round(x, 4) for x in losses]}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"split-head loss finite and falling over {BHSD_TRAIN_STEPS} steps: "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    toks = b * seq / step_ms * 1e3
    log(f"[bhsd] bf16 step b{b} s{seq}, split-head route (eager, mean of "
        f"steps 1-{BHSD_TRAIN_STEPS - 1}): {step_ms:.2f} ms = {toks:.1f} "
        f"tokens/s; packed route (phase 4): {packed_tokens_per_s:.1f} "
        f"tokens/s; split / packed {toks / packed_tokens_per_s:.3f}")
    out["train"] = dict(launches=counts, step_ms=step_ms, tokens_per_s=toks,
                        packed_tokens_per_s=packed_tokens_per_s,
                        share_of_packed=toks / packed_tokens_per_s,
                        losses=losses)
    return counts, out


# -- phase 6: paged attention and the paged decode slice ----------------------

def paged_cost(lens, block_size, d, kv_elt, q_elt, quantized):
    """(bytes, flops) that one paged-attention call needs for these
    lengths: K and V of the live tokens at the storage type, the live table
    entries (and int8 scale pairs), q, out and the lengths; ~4 d + 5 flops a
    token."""
    lens = lens.long()
    tokens = int(lens.sum())
    blocks = int(((lens + block_size - 1) // block_size).sum())
    n = lens.numel()
    nbytes = (2 * tokens * d * kv_elt + blocks * 4 + n * 4
              + 2 * n * d * q_elt + (blocks * 8 if quantized else 0))
    return nbytes, tokens * (4 * d + 5)


def paged_inputs(gen, rng, num_seqs, max_blocks, block_size, d, max_len,
                 lens=None):
    """fp32 q and caches over a pool of num_seqs * max_blocks blocks plus
    the null block, tables a random permutation, int8 blocks with random
    per-block scales, and ragged lengths 1..max_len from ``rng`` with rows
    of 0, 3, one block and the full table (unless ``lens`` is given)."""
    nb = num_seqs * max_blocks + 1
    q = torch.randn((num_seqs, d), generator=gen).to(DEV)
    k = torch.randn((nb, block_size, d), generator=gen).to(DEV)
    v = torch.randn((nb, block_size, d), generator=gen).to(DEV)
    k8, v8 = (torch.randint(-127, 128, (nb, block_size, d), generator=gen,
                            dtype=torch.int8).to(DEV) for _ in range(2))
    scales = (torch.rand((nb, 2), generator=gen) * 0.09 + 0.01).to(DEV)
    tables = (torch.from_numpy(rng.permutation(nb - 1)[:num_seqs * max_blocks]
                               + 1).int().reshape(num_seqs, max_blocks)
              .to(DEV))
    if lens is None:
        lens = rng.integers(1, max_len + 1, num_seqs)
        lens[:4] = [0, 3, block_size, max_blocks * block_size]
    lens = torch.from_numpy(np.asarray(lens, np.int32)).to(DEV)
    return dict(q=q, k=k, v=v, k8=k8, v8=v8, scales=scales, tables=tables,
                lens=lens)


def paged_kernel_case(pa, t, dtype, tag):
    """The kernel against its plain version on ``t`` in ``dtype`` (float32,
    bfloat16: q and caches rounded to bf16; int8: the int8 blocks, fp32 q).
    Returns (run, plain, library, cost, max abs err)."""
    F = torch.nn.functional
    q, tb, lens = t["q"], t["tables"], t["lens"]
    kw = {}
    if dtype == torch.int8:
        k, v, kw = t["k8"], t["v8"], {"kv_scales": t["scales"]}
    elif dtype == torch.bfloat16:
        q, k, v = (x.to(dtype) for x in (q, t["k"], t["v"]))
    else:
        k, v = t["k"], t["v"]
    run = lambda: pa.paged_attention(q, k, v, tb, lens, **kw)
    plain = lambda: pa.paged_attention_plain(q, k, v, tb, lens, **kw)
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    err = max_abs(out, ref)
    label = " ".join(x for x in ("paged_attention", tag, dtag(dtype)) if x)
    if dtype == torch.bfloat16:
        ref32 = pa.paged_attention_plain(q.float(), k.float(), v.float(), tb,
                                         lens)
        r = rel_err(out, ref32)
        check(r <= TOL_PAGED_BF16_REL, f"{label}: rel err vs fp32 plain "
              f"{r:.3g} <= {TOL_PAGED_BF16_REL} (max abs vs bf16 plain "
              f"{err:.3g})")
    else:
        excess = float(((out - ref).abs() - TOL_PAGED_FP32
                        * (1 + ref.abs())).max())
        check(excess <= 0, f"{label}: |err| <= 2e-5 + 2e-5 |plain| "
              f"(max abs err {err:.3g})")
    zero = lens == 0
    check(bool((out[zero] == 0).all()), f"{label}: {int(zero.sum())} rows "
          f"of length 0 are exactly 0")
    # library yardstick: SDPA over K/V gathered beforehand (gather excluded)
    n, d = q.shape
    span = tb.shape[1] * k.shape[1]
    kg, vg = k[tb.long()], v[tb.long()]
    if dtype == torch.int8:
        s = t["scales"][tb.long()]
        kg = kg.float() * s[..., 0, None, None]
        vg = vg.float() * s[..., 1, None, None]
    kg, vg = (x.reshape(n, 1, span, d) for x in (kg, vg))
    qg = q.reshape(n, 1, 1, d).to(kg.dtype)
    mask = (torch.arange(span, device=DEV)[None, :] < lens.long()[:, None]
            ).reshape(n, 1, 1, span)
    lib = lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    cost = paged_cost(lens, k.shape[1], d, k.element_size(),
                      q.element_size(), dtype == torch.int8)
    return run, plain, lib, cost, err


def paged_kernel_phase(gen, seed):
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    S, MB, bs, d, max_len = (PAGED_KERNEL_SHAPE[k] for k in (
        "num_seqs", "max_blocks", "block_size", "d", "max_len"))
    rng = np.random.default_rng(seed)
    t = paged_inputs(gen, rng, S, MB, bs, d, max_len)
    cache_mb = {dt: 2 * t["k"].numel() * e / 1e6 for dt, e in (
        (torch.float32, 4), (torch.bfloat16, 2), (torch.int8, 1))}
    log(f"[paged] kernel: {S} rows x {MB} blocks of {bs}, d {d}, pool "
        f"{S * MB} blocks + null; lengths 1..{max_len} (mean "
        f"{float(t['lens'].float().mean()):.1f}, rows of 0/3/{bs}/{MB * bs}); "
        f"K+V {', '.join(f'{dtag(k)} {v:.0f} MB' for k, v in cache_mb.items())}")
    results = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        run, plain, lib, cost, err = paged_kernel_case(pa, t, dtype, "")
        b = bound(*cost, torch.float32)   # the kernel computes in fp32
        full = pa.paged_attention_cost(S, MB, bs, d,
                                       1 if dtype == torch.int8 else
                                       (2 if dtype == torch.bfloat16 else 4))
        results[dtype] = dict(ms=time_ms(run), eager_ms=eager_ms(run),
                              plain_ms=time_ms(plain), library_ms=time_ms(lib),
                              bound=b, bytes=cost[0], full_table_bytes=full[1],
                              err=err)
        del run, plain, lib
        torch.cuda.empty_cache()
    small = paged_inputs(gen, rng, 4, 3, 8, 32, 24, lens=[0, 3, 8, 24])
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        paged_kernel_case(pa, small, dtype, "4 rows x 3 blocks of 8, d 32")
    # a prefill chunk's layout: its rows share one table (row stride 0),
    # lengths start+1..start+rows
    rows, width = (PAGED_SERVE[k] for k in ("prefill_chunk",
                                            "max_blocks_per_seq"))
    start = int(rng.integers(0, width * bs - rows + 1))
    chunk = paged_inputs(gen, rng, 1, width, bs, d, 0, lens=[0])
    chunk.update(q=torch.randn((rows, d), generator=gen).to(DEV),
                 tables=chunk["tables"].expand(rows, width),
                 lens=torch.arange(start + 1, start + rows + 1,
                                   dtype=torch.int32, device=DEV))
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        paged_kernel_case(pa, chunk, dtype, f"{rows} rows sharing one table "
                          f"of {width} (stride 0), lengths {start + 1}.."
                          f"{start + rows}")
    for dtype, r in results.items():
        log(f"  paged_attention {dtag(dtype)}: {r['ms']:.4f} ms (eager "
            f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms (F.scaled_dot_product_attention on "
            f"K/V gathered beforehand, gather excluded), bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}, {r['bytes'] / 1e6:.1f}"
            f" MB of live context; full-table cost model "
            f"{r['full_table_bytes'] / 1e6:.1f} MB); max abs err vs plain "
            f"{r['err']:.3g}")
    del t, small, chunk
    torch.cuda.empty_cache()
    return results


def serve_traffic(rng, cfg):
    """``requests`` prompts of prompt_lo..prompt_hi tokens; ``shared`` of
    them, at random places, begin with one system prompt of system_len
    tokens (and are longer than it, so its full blocks can be shared)."""
    vocab = cfg["vocab"]
    system = rng.integers(1, vocab, cfg["system_len"]).tolist()
    shared = set(rng.choice(cfg["requests"], cfg["shared"],
                            replace=False).tolist())
    prompts = []
    for i in range(cfg["requests"]):
        if i in shared:
            n = int(rng.integers(cfg["system_len"] + 1, cfg["prompt_hi"] + 1))
            prompts.append(system + rng.integers(
                1, vocab, n - cfg["system_len"]).tolist())
        else:
            n = int(rng.integers(cfg["prompt_lo"], cfg["prompt_hi"] + 1))
            prompts.append(rng.integers(1, vocab, n).tolist())
    return prompts, sorted(shared)


def serve_once(model, prompts, cfg, kv_dtype="float32", kernel=True,
               num_blocks=None):
    """Decode ``prompts`` through a fresh cache and decoder; returns the
    tokens and what the run counted and timed."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.serving import PagedDecoder, PagedKVCache
    from paddle_tpu_torch.serving import paged as P
    from paddle_tpu_torch.utils import monitor

    cache = PagedKVCache(model, num_blocks or cfg["num_blocks"],
                         cfg["block_size"], kv_dtype=kv_dtype)
    dec = PagedDecoder(model, cache, max_seqs=cfg["max_seqs"],
                       max_blocks_per_seq=cfg["max_blocks_per_seq"],
                       prefill_chunk=cfg["prefill_chunk"])
    steps, hits = [0], []
    joined, waiting, first = [], [], {}
    decode_step, try_join, step = dec._decode_step, dec.try_join, dec.step

    def counted_decode_step(width):
        steps[0] += 1
        return decode_step(width)

    def counted_try_join(prompt, max_new_tokens):
        before = P.KV_PREFIX_HITS.value()
        h = try_join(prompt, max_new_tokens)
        if h is not None:       # decode() joins in prompt order
            hits.append(int(P.KV_PREFIX_HITS.value() - before))
            waiting.append((len(joined), h))
            joined.append(time.perf_counter())
        return h

    def timed_step():
        n = step()
        now = time.perf_counter()
        for i, h in [w for w in waiting if w[1].tokens]:
            first[i] = now
            waiting.remove((i, h))
        return n

    # count live decode steps and each request's prefix hits; time each
    # request's first token (a step returns once its tokens are on the host)
    dec._decode_step, dec.try_join = counted_decode_step, counted_try_join
    dec.step = timed_step
    flags.set_flags({"use_paged_attention": kernel})
    monitor.default_registry().reset()
    torch.cuda.synchronize()
    config.reset_counts()
    t0 = time.perf_counter()
    try:
        tokens = dec.decode(prompts, cfg["max_new"])
    finally:
        flags.set_flags({"use_paged_attention": True})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = config.launch_counts().get("paged_attention", 0)
    if len(first) != len(prompts):
        raise AssertionError(f"chip_smoke check failed: {len(first)} of "
                             f"{len(prompts)} first tokens timed")
    from_join = [(first[i] - joined[i]) * 1e3 for i in range(len(prompts))]
    from_call = [(first[i] - t0) * 1e3 for i in range(len(prompts))]
    ttft = {}
    for q in (50, 99):
        hist = P.TTFT_MS.percentile(q)
        lo = max((b for b in P.TTFT_MS.buckets if b < hist), default=0.0)
        hi = min((b for b in P.TTFT_MS.buckets if b >= hist),
                 default=float("inf"))
        ttft.update({f"ttft_p{q}_ms": float(np.percentile(from_join, q)),
                     f"ttft_call_p{q}_ms": float(np.percentile(from_call, q)),
                     f"ttft_hist_p{q}_ms": hist,
                     f"ttft_hist_p{q}_bucket_ms": [lo, hi]})
    return dict(tokens=tokens, wall_s=wall, launches=launches,
                decode_steps=steps[0], hits=hits,
                chunks=int(P.KV_PREFILL_CHUNKS.value()),
                prefix_hits=int(P.KV_PREFIX_HITS.value()),
                cache_bytes=cache.bytes, **ttft)


def dense_logits(model, context):
    """The next-token logits after ``context`` (dense, fp32)."""
    dev = model.device
    with torch.no_grad():
        q, k, v = model.qkv(torch.tensor(context, device=dev),
                            torch.arange(len(context), device=dev))
        p = torch.softmax((q[-1:] @ k.T) / model.hidden ** 0.5, dim=-1)
        return ((p @ v) @ model.wo)[0]


def near_tie(model, prompt, ref, got, label):
    """None if ``got == ref``; else the first differing step, which must be
    a near-tie of ``ref``'s context (top-2 logit gap below NEAR_TIE_REL of
    the top logit)."""
    if got == ref:
        return None
    i = next(j for j, (a, b) in enumerate(zip(ref, got)) if a != b)
    top2 = torch.topk(dense_logits(model, prompt + ref[:i]), 2).values
    gap = float(top2[0] - top2[1])
    rel = gap / max(abs(float(top2[0])), 1e-30)
    check(rel < NEAR_TIE_REL, f"{label}: first differs at step {i}, top-2 "
          f"logit gap {gap:.3g} = {rel:.3g} of the top logit < {NEAR_TIE_REL}")
    return i


def int8_kv_check(model, prompts, cfg):
    """The int8 pool a decoder wrote on the card against the fp32 K/V of the
    same contexts: each dequantised value within half its block's scale
    (plus tol for the recomputed K/V), and the int8 kernel's attention of
    each context's last query within the bound those scales imply of fp32
    attention.  A score moves by at most D = sm * |q|_1 * (ks/2 + tol), so
    each softmax weight by a factor within exp(+-2D), and a value by at
    most vs/2 + tol: |out8 - out| <= vs/2 + expm1(2D) max|v| + 2 tol."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.serving import PagedDecoder, PagedKVCache

    cache = PagedKVCache(model, cfg["num_blocks"], cfg["block_size"],
                         kv_dtype="int8")
    dec = PagedDecoder(model, cache, max_seqs=cfg["max_seqs"],
                       max_blocks_per_seq=cfg["max_blocks_per_seq"],
                       prefill_chunk=cfg["prefill_chunk"])
    # streams long enough that none retires before the last one's prefill
    handles = [dec.join(p, cfg["max_positions"] - len(p)) for p in prompts]
    while any(len(h.tokens) < 2 for h in handles):   # prefill + a decode
        dec.step()
    dev, bs, tol = model.device, cache.block_size, TOL_PAGED_FP32
    sm = 1.0 / model.hidden ** 0.5
    excess, held, qs, lens, tables, refs, bounds = (float("-inf"), [], [], [],
                                                    [], [], [])
    with torch.no_grad():
        for h in handles:
            seq = dec._slots[h.slot]
            ctx = h.prompt + h.tokens[:-1]      # what the pool holds
            n = len(ctx)
            held.append(seq.context_len == n)
            q, k, v = model.qkv(torch.tensor(ctx, device=dev),
                                torch.arange(n, device=dev))
            bids = torch.tensor(seq.block_ids, device=dev)
            s = cache.scales[bids].repeat_interleave(bs, dim=0)[:n]
            for pool, ref, sc in ((cache.k, k, s[:, :1]),
                                  (cache.v, v, s[:, 1:])):
                deq = pool[bids].reshape(-1, model.hidden)[:n].float() * sc
                excess = max(excess, float(((deq - ref).abs() - sc / 2
                                            - tol).max()))
            refs.append(torch.softmax((q[-1] @ k.T) * sm, dim=-1) @ v)
            dscore = sm * float(q[-1].abs().sum()) * (
                float(s[:, 0].max()) / 2 + tol)
            bounds.append(float(s[:, 1].max()) / 2 + 2 * tol
                          + math.expm1(2 * dscore) * float(v.abs().max()))
            qs.append(q[-1])
            lens.append(n)
            tables.append(seq.block_ids)
        width = max(map(len, tables))
        tb = torch.tensor([t + [0] * (width - len(t)) for t in tables],
                          dtype=torch.int32, device=dev)
        out = pa.paged_attention(
            torch.stack(qs), cache.k, cache.v, tb,
            torch.tensor(lens, dtype=torch.int32, device=dev), sm_scale=sm,
            kv_scales=cache.scales)
    err = (out - torch.stack(refs)).abs().amax(dim=1).tolist()
    share = max(e / b for e, b in zip(err, bounds))
    for h in handles:
        dec.evict(h)
    check(all(held), f"int8 KV: each pool holds its prompt and all but the "
          f"last generated token")
    check(excess <= 0, f"int8 KV: {len(handles)} contexts ({sum(lens)} "
          f"tokens) stored by the decoder read back within half their "
          f"scale of the fp32 K/V (largest excess over that {excess:.3g})")
    check(share <= 1, f"int8 KV: the kernel's attention over them is "
          f"within the bound the scales imply of fp32 attention (max err "
          f"{max(err):.3g}, at most {share:.3g} of its bound; bounds "
          f"{min(bounds):.3g}-{max(bounds):.3g})")
    return dict(contexts=len(handles), tokens=sum(lens),
                max_attn_err=max(err), max_err_over_bound=share,
                bound_min=min(bounds), bound_max=max(bounds),
                k_scale=cache.k_scale, v_scale=cache.v_scale)


def paged_slice_phase(seed):
    from paddle_tpu_torch.serving import (PagedDecoder, PagedKVCache,
                                          dense_reference_decode,
                                          kv_pool_bytes, make_paged_toy_lm)

    cfg = PAGED_SERVE
    log(f"[paged] slice: paged toy LM vocab {cfg['vocab']} hidden "
        f"{cfg['hidden']} positions {cfg['max_positions']}, random weights "
        f"from seed {seed}; pool {cfg['num_blocks']} blocks of "
        f"{cfg['block_size']} ({kv_pool_bytes(cfg['num_blocks'], cfg['block_size'], cfg['hidden']) / 1e6:.0f} MB fp32), "
        f"{cfg['max_seqs']} rows, tables of {cfg['max_blocks_per_seq']}, "
        f"prefill chunk {cfg['prefill_chunk']}")
    model = make_paged_toy_lm(vocab=cfg["vocab"], hidden=cfg["hidden"],
                              max_positions=cfg["max_positions"], seed=seed,
                              device=DEV)
    rng = np.random.default_rng(seed)
    prompts, shared = serve_traffic(rng, cfg)
    n_prompt = sum(len(p) for p in prompts)
    log(f"  {len(prompts)} requests, {n_prompt} prompt tokens (lengths "
        f"{min(map(len, prompts))}-{max(map(len, prompts))}), {len(shared)} "
        f"behind a {cfg['system_len']}-token system prompt, "
        f"{cfg['max_new']} new tokens each")
    serve_once(model, [prompts[0][:40], prompts[1][:300]], cfg)   # warm-up

    runs = {"kernel": serve_once(model, prompts, cfg)}
    r = runs["kernel"]
    check(r["launches"] > 0 and r["launches"] == r["chunks"]
          + r["decode_steps"], f"paged_attention: {r['launches']} launches "
          f"= {r['chunks']} prefill chunks + {r['decode_steps']} live decode "
          f"steps")
    check(r["prefix_hits"] > 0, f"prefix cache: {r['prefix_hits']} block "
          f"hits")
    n_new = sum(len(t) for t in r["tokens"])
    check(n_new == len(prompts) * cfg["max_new"], f"{n_new} tokens generated")
    runs["plain"] = serve_once(model, prompts, cfg, kernel=False)
    check(runs["plain"]["launches"] == 0, "plain path launches no kernel")
    same = 0
    for i, (p, a, b) in enumerate(zip(prompts, runs["plain"]["tokens"],
                                      r["tokens"])):
        same += near_tie(model, p, a, b, f"request {i} kernel vs plain "
                         f"path") is None
    want = len(prompts) - PAGED_MAX_DIFFERING
    check(same >= want, f"kernel path tokens equal the plain path's for "
          f"{same} of {len(prompts)} requests (>= {want}; the rest "
          f"near-ties)")

    # the oracle: dense_reference_decode on the card, one request with hits
    with_hits = [i for i, n in enumerate(r["hits"]) if n > 0]
    check(len(with_hits) > cfg["cold"], f"{len(with_hits)} requests took "
          f"prefix hits ({sum(r['hits'])} blocks)")
    hit = with_hits[0]
    picks = [hit] + [i for i in range(len(prompts)) if i != hit][
        :cfg["oracle"] - 1]
    for i in picks:
        ref = dense_reference_decode(model, prompts[i], cfg["max_new"])
        step = near_tie(model, prompts[i], ref, r["tokens"][i],
                        f"request {i} vs dense_reference_decode")
        log(f"  request {i} (len {len(prompts[i])}"
            f"{', prefix hits' if i == hit else ''}) vs "
            f"dense_reference_decode: "
            f"{'equal' if step is None else f'near-tie at step {step}'}")

    # prefix-hit requests against the same prompts decoded cold
    for i in with_hits[:cfg["cold"]]:
        cold = serve_once(model, [prompts[i]], cfg, num_blocks=1024)
        check(cold["prefix_hits"] == 0 and cold["tokens"][0] ==
              r["tokens"][i], f"request {i} ({r['hits'][i]} prefix hits in "
              f"the batch): tokens equal the prompt decoded cold")

    runs["int8"] = serve_once(model, prompts, cfg, kv_dtype="int8")
    r8 = runs["int8"]
    runs["int8_plain"] = serve_once(model, prompts, cfg, kv_dtype="int8",
                                    kernel=False)
    same8 = sum(a == b for a, b in zip(runs["int8_plain"]["tokens"],
                                       r8["tokens"]))
    want = len(prompts) - PAGED_MAX_DIFFERING
    check(same8 >= want, f"int8 KV: kernel path tokens equal the plain "
          f"path's for {same8} of {len(prompts)} requests (>= {want})")
    rate = sum(a == b for ta, tb in zip(r8["tokens"], r["tokens"])
               for a, b in zip(ta, tb)) / n_new
    flips, gaps = [], []
    for p, ta, tb in zip(prompts, r8["tokens"], r["tokens"]):
        if ta != tb:
            i = next(j for j, (a, b) in enumerate(zip(ta, tb)) if a != b)
            top2 = torch.topk(dense_logits(model, p + tb[:i]), 2).values
            flips.append(i)
            gaps.append(float((top2[0] - top2[1]) / top2[0].abs()))
    h = INT8_GATE_TOKENS
    head = sum(a == b for ta, tb in zip(r8["tokens"], r["tokens"])
               for a, b in zip(ta[:h], tb[:h])) / (h * len(prompts))
    log(f"  int8 vs fp32: {len(flips)} of {len(prompts)} requests differ; "
        f"first differing step {sorted(flips)}; fp32 top-2 gap there, of "
        f"the top logit: median {np.median(gaps) if gaps else 0:.3g}, max "
        f"{max(gaps, default=0):.3g}; token match over all "
        f"{cfg['max_new']} new tokens {rate:.4f}")
    check(head >= MIN_INT8_MATCH, f"int8 KV tokens match the fp32 kernel "
          f"run at {head:.4f} >= {MIN_INT8_MATCH} over the first {h} new "
          f"tokens of each request")
    check(max(gaps, default=0.0) < INT8_FLIP_GAP_REL, f"int8 KV: every "
          f"first flip is at an fp32 top-2 gap below {INT8_FLIP_GAP_REL} of "
          f"the top logit (max {max(gaps, default=0.0):.3g})")
    want = kv_pool_bytes(cfg["num_blocks"], cfg["block_size"], cfg["hidden"],
                         "int8")
    check(r8["cache_bytes"] == want, f"int8 cache holds {want} bytes "
          f"(kv_pool_bytes)")
    kv8 = int8_kv_check(model, [prompts[i] for i in sorted(
        set(range(cfg["int8_probe"])) | set(shared[:4]))], cfg)

    speed = {}
    for name, run in runs.items():
        speed[name] = dict(
            wall_s=run["wall_s"], decode_tokens_per_s=n_new / run["wall_s"],
            prompt_tokens_per_s=n_prompt / run["wall_s"],
            launches=run["launches"], prefill_chunks=run["chunks"],
            decode_steps=run["decode_steps"], prefix_hits=run["prefix_hits"],
            **{k: v for k, v in run.items() if k.startswith("ttft_")})
        s = speed[name]
        hist = ", ".join(
            f"p{q} in the {b[0]:g}-{b[1]:g} ms bucket"
            for q in (50, 99) for b in [s[f"ttft_hist_p{q}_bucket_ms"]])
        log(f"[paged] {name}: {run['wall_s']:.3f} s wall, "
            f"{s['decode_tokens_per_s']:.1f} generated tokens/s, "
            f"{s['prompt_tokens_per_s']:.1f} prompt tokens/s; TTFT over "
            f"{len(prompts)} requests from join p50 {s['ttft_p50_ms']:.1f} "
            f"ms p99 {s['ttft_p99_ms']:.1f} ms, from the decode() call p50 "
            f"{s['ttft_call_p50_ms']:.1f} ms p99 {s['ttft_call_p99_ms']:.1f}"
            f" ms (serve.ttft_ms histogram: {hist}); {run['chunks']} chunks "
            f"+ {run['decode_steps']} decode steps, {run['prefix_hits']} "
            f"prefix hits")

    # 20 decode steps of 64 rows at ~1024 tokens of context, profiled
    prof = profile_decode(model, cfg, rng, PagedDecoder, PagedKVCache)
    out = dict(runs=speed, int8_token_match_first8=head,
               int8_token_match=rate, int8_first_flip_steps=sorted(flips),
               int8_flip_gap_max=max(gaps, default=0.0), int8_kv=kv8,
               int8_same_as_plain=same8, same_as_plain=same,
               requests=len(prompts), prompt_tokens=n_prompt,
               generated_tokens=n_new, profile=prof)
    return r["launches"], out


def profile_decode(model, cfg, rng, PagedDecoder, PagedKVCache):
    from torch.profiler import ProfilerActivity, profile

    n = cfg["max_seqs"]
    cache = PagedKVCache(model, cfg["num_blocks"], cfg["block_size"])
    dec = PagedDecoder(model, cache, max_seqs=n,
                       max_blocks_per_seq=cfg["max_blocks_per_seq"],
                       prefill_chunk=cfg["prefill_chunk"])
    plen = cfg["profile_prompt"]
    max_new = cfg["max_positions"] - plen
    handles = [dec.join(rng.integers(1, cfg["vocab"], plen).tolist(),
                        max_new) for _ in range(n)]
    while any(len(h.tokens) == 0 for h in handles):
        dec.step()
    torch.cuda.synchronize()
    steps = cfg["profile_steps"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        for _ in range(steps):
            dec.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = device_events(p)
    busy = sum(us for us, _, _ in events) / 1e3 / steps
    kernel = sum(us for us, _, name in events
                 if "paged_attn_kernel" in name) / 1e3 / steps
    ctx = float(np.mean([len(h.prompt) + len(h.tokens) for h in handles]))
    for h in handles:
        dec.evict(h)
    top = sorted(events, reverse=True)[:8]
    log(f"[profile] paged decode step, {n} rows, mean context {ctx:.0f}: "
        f"{wall_ms:.3f} ms wall (under the profiler), device busy "
        f"{busy:.4f} ms (busy share {busy / wall_ms:.3f}), paged_attention "
        f"{kernel:.4f} ms = {kernel / busy:.3f} of device time, "
        f"{kernel / wall_ms:.3f} of wall")
    for us, count, name in top:
        log(f"  {us / 1e3 / steps:8.4f} ms  x{count // steps:<3d} {name[:90]}")
    return dict(step_wall_ms=wall_ms, device_busy_ms=busy,
                kernel_ms=kernel, kernel_share_of_device=kernel / busy,
                kernel_share_of_wall=kernel / wall_ms, mean_context=ctx,
                rows=n)


# -- phase 7: vision kernels (rows 10 and 13) ---------------------------------

# Row 10 at its main-path shapes: VGG-16's fused convs at b128 (3x3 s1 p1;
# the four in-group shapes, then the first convs of groups 3 and 4, so the
# cases cover all 10 launches of a VGG forward), a 3x3 s2 p1, a 1x1 s2 and
# a 7x7 s2 p3 conv, as (n, h, w, c, o, k, s, p).
CONV_CASES = (
    ("vgg 128->128 16x16", (128, 16, 16, 128, 128, 3, 1, 1)),
    ("vgg 256->256 8x8", (128, 8, 8, 256, 256, 3, 1, 1)),
    ("vgg 512->512 4x4", (128, 4, 4, 512, 512, 3, 1, 1)),
    ("vgg 512->512 2x2", (128, 2, 2, 512, 512, 3, 1, 1)),
    ("vgg 128->256 8x8", (128, 8, 8, 128, 256, 3, 1, 1)),
    ("vgg 256->512 4x4", (128, 4, 4, 256, 512, 3, 1, 1)),
    ("3x3 s2 p1 128->256 16x16", (128, 16, 16, 128, 256, 3, 2, 1)),
    ("1x1 s2 256->512 8x8", (128, 8, 8, 256, 512, 1, 2, 0)),
    ("7x7 s2 p3 128->128 32x32", (32, 32, 32, 128, 128, 7, 2, 3)),
)
CONV_ACT_SHAPE = (2, 8, 8, 128, 128, 3, 1, 1)
# Row 13: VGG-16's four kernel-gated 2x2/2 max pools at b128 (the inputs of
# groups 2-5), then 3x3/2 p1 max, 2x2/2 avg and 3x3/1 p1 non-exclusive avg,
# as (mode, n, h, w, c, k, s, p).
POOL_CASES = (
    ("vgg max 16x16 c128", ("max", 128, 16, 16, 128, 2, 2, 0)),
    ("vgg max 8x8 c256", ("max", 128, 8, 8, 256, 2, 2, 0)),
    ("vgg max 4x4 c512", ("max", 128, 4, 4, 512, 2, 2, 0)),
    ("vgg max 2x2 c512", ("max", 128, 2, 2, 512, 2, 2, 0)),
    ("max 3x3/2 p1 32x32 c128", ("max", 32, 32, 32, 128, 3, 2, 1)),
    ("avg 2x2/2 16x16 c256", ("avg", 128, 16, 16, 256, 2, 2, 0)),
    ("avg 3x3/1 p1 16x16 c128", ("avg", 64, 16, 16, 128, 3, 1, 1)),
)
TOL_CONV_FP32_REL = 1e-4     # of the largest value: same fp32 sums, reordered
TOL_AVG_POOL = 1e-6          # same fp32 sum in the same tap order
# The static phase's VGG kernel launches per forward, pinned on the CPU by
# tests/test_torch_static.py (the JAX dispatch at full width): 10 fused
# convs (group 2's second, groups 3-5) and the 4 pools of groups 2-5; the
# tower's 1 / 2.
STATIC_LAUNCHES = {"vgg16_bn_drop": {"conv2d_bn_act": 10, "max_pool2d": 4},
                   "conv_tower": {"conv2d_bn_act": 1, "max_pool2d": 2}}
STATIC_BATCH = {"vgg16_bn_drop": 128, "conv_tower": 64}
STATIC_REPS = 10       # runs a timed block
STATIC_BLOCKS = 8      # blocks, alternating pipeline on / off / off / on
TOL_STATIC_REL = 1e-4        # of each fetch's largest value


def conv_case(cf, gen, dims, dtype, act, timed=True):
    """Row 10 against its plain version (fp32 relative to the largest value,
    bf16 against the fp32 plain version); with ``timed`` its times beside
    the plain version's, cuDNN's on the folded weights (channels-last, plus
    the act) and the bound."""
    n, h, w, c, o, k, s, p = dims
    x = randn(gen, (n, h, w, c), dtype)
    wt = randn(gen, (o, c, k, k), dtype, 1.0 / math.sqrt(c * k * k))
    a = randn(gen, (o,), torch.float32, 0.2, 1.0)
    b = randn(gen, (o,), torch.float32, 0.5)
    args = ((s, s), (p, p), act)
    with torch.no_grad():
        run = lambda: cf.conv2d_bn_act(x, wt, a, b, *args)
        plain = lambda: cf.conv2d_bn_act_plain(x, wt, a, b, *args)
        got = run()
        torch.cuda.synchronize()
        ref32 = cf.conv2d_bn_act_plain(x.float(), wt.float(), a, b, *args)
        err = max_abs(got, plain())
        splits = cf.conv_plan(n, h, w, c, o, k, k, s, s, p, p, dtype).splits
        tag = f"conv2d_bn_act n{n} {h}x{w} {c}->{o} k{k} s{s} p{p} " \
              f"{dtag(dtype)} act={act or 'none'} (K splits {splits})"
        check(torch.equal(run(), got), f"{tag}: a second call repeats the "
              f"output bit for bit")
        r = rel_err(got, ref32)
        if dtype == torch.float32:
            check(r <= TOL_CONV_FP32_REL, f"{tag}: rel err {r:.3g} <= "
                  f"{TOL_CONV_FP32_REL}")
        else:
            check(r <= TOL_BF16_REL, f"{tag}: rel err vs fp32 plain {r:.3g}"
                  f" <= {TOL_BF16_REL} (max abs vs bf16 plain {err:.3g})")
        if not timed:
            return dict(err=err, splits=splits)
        wf = (wt * a.to(dtype).reshape(-1, 1, 1, 1)).contiguous(
            memory_format=torch.channels_last)
        bf = b.to(dtype)
        xc = x.permute(0, 3, 1, 2)
        lib = lambda: cf.apply_act(torch.nn.functional.conv2d(
            xc, wf, bf, s, p), act)
        elt = x.element_size()
        oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        flops, nbytes = cf.conv_cost(n, oh, ow, c, o, k, k, elt, h, w)
        return dict(timings(run, plain, lib, nbytes, flops, dtype), err=err,
                    flops=flops, splits=splits)


def pool_case(pl, gen, dims, dtype):
    """Row 13 against its plain version (max bit for bit, avg within
    TOL_AVG_POOL), its times beside the plain version's, PyTorch's pooling
    on a channels-last view and the bound."""
    mode, n, h, w, c, k, s, p = dims
    x = randn(gen, (n, h, w, c), dtype)
    args = ((k, k), (s, s), (p, p))
    fn = pl.max_pool2d_nhwc if mode == "max" else pl.avg_pool2d_nhwc
    plain_fn = (pl.max_pool2d_nhwc_plain if mode == "max"
                else pl.avg_pool2d_nhwc_plain)
    run = lambda: fn(x, *args)
    plain = lambda: plain_fn(x, *args)
    got = run()
    torch.cuda.synchronize()
    ref = plain()
    err = max_abs(got, ref)
    tag = f"{mode}_pool2d n{n} {h}x{w} c{c} k{k} s{s} p{p} {dtag(dtype)}"
    if mode == "max":
        check(torch.equal(got, ref), f"{tag}: bit for bit the plain version")
    else:
        check(err <= TOL_AVG_POOL, f"{tag}: max abs err {err:.3g} <= "
              f"{TOL_AVG_POOL}")
    xc = x.permute(0, 3, 1, 2)
    F = torch.nn.functional
    lib = ((lambda: F.max_pool2d(xc, k, s, p)) if mode == "max" else
           (lambda: F.avg_pool2d(xc, k, s, p, count_include_pad=True)))
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    flops, nbytes = pl.pool_cost(n, oh, ow, c, k, k, x.element_size(), h, w)
    return dict(timings(run, plain, lib, nbytes, flops, dtype), err=err,
                mode=mode)


def vision_kernel_phase(gen):
    """Rows 10 and 13 against their plain versions at their main-path
    shapes in fp32 (cuDNN's TF32 off) and bf16, with their times."""
    from paddle_tpu_torch.ops.kernels import conv_fused as cf
    from paddle_tpu_torch.ops.kernels import pooling as pl

    log("[vision kernels] rows 10 and 13 against their plain versions "
        "(fp32 without TF32: torch.backends.cudnn.allow_tf32 = False)")
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, dims in CONV_CASES:
            results[("conv", label, dtype)] = conv_case(cf, gen, dims, dtype,
                                                        "relu")
        for act in cf.EPILOGUE_ACTS:
            conv_case(cf, gen, CONV_ACT_SHAPE, dtype, act, timed=False)
        for label, dims in POOL_CASES:
            results[("pool", label, dtype)] = pool_case(pl, gen, dims, dtype)
    for (kind, label, dtype), r in results.items():
        name = "conv2d_bn_act" if kind == "conv" else f"{r['mode']}_pool2d"
        extra = (f", K splits {r['splits']}, factor against the library "
                 f"{r['ms'] / r['library_ms']:.2f}" if kind == "conv" else "")
        log(f"  {name} {label} {dtag(dtype)}: {r['ms']:.4f} ms (eager "
            f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}){extra}")
    return results


# -- phase 8: static-graph vision inference -----------------------------------

def conv_tower(static, L, nets, seed):
    """bench_vision.py's conv tower at its TPU settings (ch 128, 32 x 32):
    conv/BN(relu)/max-pool twice, then fc 10."""
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = seed
    with static.program_guard(main, startup):
        img = L.data("img", [3, 32, 32])
        h = L.conv2d(img, 128, 3, padding=1)
        h = L.batch_norm(h, act="relu", is_test=True)
        h = L.pool2d(h, 2, "max", 2)
        h = L.conv2d(h, 128, 3, padding=1)
        h = L.batch_norm(h, act="relu", is_test=True)
        h = L.pool2d(h, 2, "max", 2)
        out = L.fc(L.flatten(h), 10)
    return main, startup, [out.name]


def vgg16_bn_drop(static, L, nets, seed):
    """The Paddle book's CIFAR-10 VGG (chapter 03,
    test_image_classification.py): five img_conv_group blocks of 64 x 2,
    128 x 2, 256 x 3, 512 x 3, 512 x 3 filters (3 x 3, BN + ReLU, conv
    dropouts), 2 x 2 max pools, dropout 0.5, fc 512, BN + ReLU, dropout
    0.5, fc 512, fc 10 + softmax.  Fetches the logits and the softmax."""
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = seed

    def block(x, filters, groups, drops):
        return nets.img_conv_group(
            x, conv_num_filter=[filters] * groups, pool_size=2,
            pool_stride=2, conv_filter_size=3, conv_act="relu",
            conv_with_batchnorm=True, conv_batchnorm_drop_rate=drops)

    with static.program_guard(main, startup):
        img = L.data("img", [3, 32, 32])
        h = block(img, 64, 2, [0.3, 0])
        h = block(h, 128, 2, [0.4, 0])
        h = block(h, 256, 3, [0.4, 0.4, 0])
        h = block(h, 512, 3, [0.4, 0.4, 0])
        h = block(h, 512, 3, [0.4, 0.4, 0])
        h = L.dropout(h, dropout_prob=0.5)
        h = L.fc(h, 512, act=None)
        h = L.batch_norm(h, act="relu")
        h = L.dropout(h, dropout_prob=0.5)
        h = L.fc(h, 512, act=None)
        out = L.fc(h, 10, act="softmax")
    logits = main.global_block().ops[-1].inputs["X"][0]
    return main, startup, [logits, out.name]


def bn_state(static, startup, test, rng):
    """The startup program's parameters, with random BN statistics and
    affine parameters (positive variances), in a fresh scope."""
    scope = static.Scope()
    static.Executor(DEV).run(startup, scope=scope)
    for op in test.global_block().ops:
        if op.type != "batch_norm":
            continue
        for slot, lo, hi in (("Mean", -0.5, 0.5), ("Variance", 0.5, 2.0),
                             ("Scale", 0.5, 1.5), ("Bias", -0.5, 0.5)):
            name = op.inputs[slot][0]
            v = scope.find_var(name)
            scope.set(name, torch.from_numpy(
                rng.uniform(lo, hi, tuple(v.shape)).astype(np.float32))
                .to(v.device))
    return scope


def run_static(exe, program, feed, fetches, scope):
    return exe.run(program, feed=feed, fetch_list=fetches, scope=scope,
                   return_numpy=False)


def interleaved_timings(exe, runs, feed, fetches, batch):
    """Executor.run of two (program, scope, opt_passes) runs in alternating
    blocks (a, b, b, a, ...: host noise on a shared machine drifts), each
    block STATIC_REPS runs after one warm run.  Per run: the median wall
    ms of a run (the numpy feed's copy to the card and the fetches' copies
    back included) as images/s, the quartile spread, and the median span
    between CUDA events around a run."""
    a, b = runs
    walls = {k: [] for k in runs}
    spans = {k: [] for k in runs}
    for mode in (a, b, b, a) * (STATIC_BLOCKS // 4):
        program, scope, passes = runs[mode]
        with opt_passes(passes):
            exe.run(program, feed=feed, fetch_list=fetches, scope=scope)
            torch.cuda.synchronize()
            for _ in range(STATIC_REPS):
                t0 = time.perf_counter()
                exe.run(program, feed=feed, fetch_list=fetches, scope=scope)
                walls[mode].append((time.perf_counter() - t0) * 1e3)
            spans[mode].append(_events_ms(
                lambda: run_static(exe, program, feed, fetches, scope),
                STATIC_REPS))
    out = {}
    for mode in walls:
        q1, med, q3 = np.percentile(walls[mode], [25, 50, 75])
        out[mode] = dict(images_per_s=batch / med * 1e3, wall_ms=med,
                         wall_iqr_ms=q3 - q1,
                         device_span_ms=float(np.median(spans[mode])))
    return out


def static_timings(exe, program, feed, fetches, scope, batch):
    """The pipeline on and off (``interleaved_timings``)."""
    return interleaved_timings(exe, {"on": (program, scope, "default"),
                                     "off": (program, scope, "")},
                               feed, fetches, batch)


def profile_forward(exe, program, feed, fetches, scope, reps=3):
    """Device time of one Executor.run (under the current ``opt_passes``)
    by kind (the port's kernels, cuDNN convolutions, copies, the rest)
    from torch.profiler, and the busy share of the run's wall time
    (profiler overhead included)."""
    from torch.profiler import ProfilerActivity, profile

    run_static(exe, program, feed, fetches, scope)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run_static(exe, program, feed, fetches, scope)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kinds = {"port kernels": 0.0, "cudnn": 0.0, "copies": 0.0, "rest": 0.0}
    ours, top = {}, []
    for us, count, name in device_events(prof):
        ms = us / 1e3 / reps
        top.append((ms, count // reps, name))
        own = PORT_KERNEL.search(name)
        if own:
            kinds["port kernels"] += ms
            ours[own.group(0)] = ours.get(own.group(0), 0.0) + ms
        elif re.search(r"cudnn|xmma|conv|implicit|winograd|fft|nchw|nhwc",
                       name, re.I) and "copy" not in name.lower():
            kinds["cudnn"] += ms
        elif "copy" in name.lower():
            kinds["copies"] += ms
        else:
            kinds["rest"] += ms
    busy = sum(kinds.values())
    from paddle_tpu_torch.core import flags

    log(f"[profile] one forward (opt_passes="
        f"{flags.get_flag('opt_passes')!r}): device busy {busy:.3f} ms of "
        f"{wall_ms:.3f} "
        f"ms wall (busy share {busy / wall_ms:.3f}); "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in kinds.items()))
    log("  port kernels: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in sorted(ours.items(),
                                             key=lambda kv: -kv[1])))
    for ms, count, name in sorted(top, reverse=True)[:12]:
        log(f"  {ms:8.4f} ms  x{count:<3d} {name[:100]}")
    return dict(wall_ms=wall_ms, busy_ms=busy, busy_share=busy / wall_ms,
                kinds=kinds, port_kernels=ours)


@contextlib.contextmanager
def opt_passes(value):
    from paddle_tpu_torch.core import flags

    saved = flags.get_flag("opt_passes")
    flags.set_flags({"opt_passes": value})
    try:
        yield
    finally:
        flags.set_flags({"opt_passes": saved})


@contextlib.contextmanager
def vision_plain():
    """The vision kernels' wrappers swapped, as module attributes, for
    their plain versions (as ``plain_wrappers`` swaps the others)."""
    from paddle_tpu_torch.ops.kernels import conv_fused as cf
    from paddle_tpu_torch.ops.kernels import pooling as pl

    saved = (cf.conv2d_bn_act, pl.max_pool2d_nhwc, pl.avg_pool2d_nhwc)
    cf.conv2d_bn_act = cf.conv2d_bn_act_plain
    pl.max_pool2d_nhwc = pl.max_pool2d_nhwc_plain
    pl.avg_pool2d_nhwc = pl.avg_pool2d_nhwc_plain
    try:
        yield
    finally:
        cf.conv2d_bn_act, pl.max_pool2d_nhwc, pl.avg_pool2d_nhwc = saved


def static_model(name, build, seed):
    """One program through the port's static graph in fp32: the pipeline's
    op counts, kernel launches per forward, rollbacks, golden parity with
    the unrewritten program, the kernels against their plain versions in
    the rewritten program, images/s with the pipeline on and off."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.static import layers as L
    from paddle_tpu_torch.static import nets
    from paddle_tpu_torch.static import passes as P
    from paddle_tpu_torch.utils import monitor

    batch = STATIC_BATCH[name]
    main, startup, fetches = build(static, L, nets, seed)
    test = main.clone(for_test=True)
    rng = np.random.default_rng(seed)
    scope = bn_state(static, startup, test, rng)
    state = {k: scope.find_var(k).cpu().numpy() for k in scope.keys()}
    feed = {"img": rng.standard_normal((batch, 3, 32, 32)).astype(np.float32)}
    rewritten, report = P.PassManager(P.DEFAULT_PIPELINE).apply(
        test, {"img"}, fetches)
    log(f"[static] {name} b{batch} fp32: {report.to_text()}")
    exe = static.Executor(DEV)
    rollbacks = monitor.counter("passes.rollbacks")
    rollbacks0 = rollbacks.value()
    with opt_passes("default"):
        check(exe.executed_program(test, ["img"], fetches) is not test,
              f"{name}: the Executor runs the pipeline's rewrite")
        run_static(exe, test, feed, fetches, scope)
        torch.cuda.synchronize()
        config.reset_counts()
        outs = run_static(exe, test, feed, fetches, scope)
        torch.cuda.synchronize()
        counts = config.launch_counts()
        for k, n in STATIC_LAUNCHES[name].items():
            check(counts.get(k, 0) == n, f"{name}: {counts.get(k, 0)} {k} "
                  f"launches per forward (want {n})")
        check(counts.get("avg_pool2d", 0) == 0, f"{name}: no avg pools")
        with vision_plain():
            plain_outs = run_static(exe, test, feed, fetches, scope)
        for f, got, ref in zip(fetches, outs, plain_outs):
            r = rel_err(got, ref)
            check(r <= TOL_STATIC_REL, f"{name}: fetch {f} kernels vs plain "
                  f"versions rel err {r:.3g} <= {TOL_STATIC_REL}")
        prof = profile_forward(exe, test, feed, fetches, scope)
    check(all(torch.isfinite(t).all() for t in outs),
          f"{name}: finite fetches of shapes "
          f"{[tuple(t.shape) for t in outs]}")
    with opt_passes(""):
        parity = {}
        for f in fetches:
            ref = exe.run(test, feed=feed, fetch_list=[f], scope=scope)[0]
            tol = TOL_STATIC_REL * float(np.abs(ref).max())
            rep = P.golden_parity(test, rewritten, feed, [f], state=state,
                                  rtol=0.0, atol=tol, place=DEV)
            check(rep.ok, f"{name}: golden parity of {f}, pipeline vs "
                  f"none: {rep.to_text()} (atol {tol:.3g})")
            parity[f] = rep.per_fetch[f] / float(np.abs(ref).max())
        config.reset_counts()
        run_static(exe, test, feed, fetches, scope)
        torch.cuda.synchronize()
        check(not config.launch_counts(), f"{name}: no kernel launches "
              "with the pipeline off")
        prof_off = profile_forward(exe, test, feed, fetches, scope)
    times = static_timings(exe, test, feed, fetches, scope, batch)
    rolled = rollbacks.value() - rollbacks0
    check(rolled == 0, f"{name}: {rolled} pipeline rollbacks")
    on, off = times["on"], times["off"]
    log(f"[static] {name}: pipeline on {on['images_per_s']:.1f} images/s "
        f"(median {on['wall_ms']:.3f} ms wall a run, IQR "
        f"{on['wall_iqr_ms']:.3f}; {on['device_span_ms']:.3f} ms between "
        f"device events), off {off['images_per_s']:.1f} images/s "
        f"({off['wall_ms']:.3f} ms, IQR {off['wall_iqr_ms']:.3f}; "
        f"{off['device_span_ms']:.3f} ms): "
        f"{on['images_per_s'] / off['images_per_s']:.3f}x; device busy on "
        f"{prof['busy_ms']:.3f} ms, off {prof_off['busy_ms']:.3f} ms")
    return counts, dict(
        batch=batch, dtype="float32", ops_before=report.ops_before,
        ops_after=report.ops_after,
        passes={p.name: [p.ops_before, p.ops_after] for p in report.passes},
        launches=counts, rollbacks=rolled, parity_rel_err=parity,
        pipeline_on=dict(on, profile=prof),
        pipeline_off=dict(off, profile=prof_off))


def static_phase(seed):
    log("[static] static-graph inference: Program, layers, Executor, "
        "DEFAULT_PIPELINE")
    counts, out = {}, {}
    for name, build in (("conv_tower", conv_tower),
                        ("vgg16_bn_drop", vgg16_bn_drop)):
        counts[name], out[name] = static_model(name, build, seed)
    return counts["vgg16_bn_drop"], out


def vision_entries(vision, counts):
    """The kernels-line entries of rows 10 and 13: fp32 at a VGG-16 shape
    (the static phase's path), bf16 beside it, every case listed; launches
    per VGG-16 forward of the static phase."""
    from paddle_tpu_torch.ops.kernels import conv_fused as cf
    from paddle_tpu_torch.ops.kernels import pooling as pl

    def numbers(kind, label, prefix=""):
        r = vision[(kind, label, torch.float32)]
        rb = vision[(kind, label, torch.bfloat16)]
        return {f"{prefix}max_abs_err": r["err"], f"{prefix}ms": r["ms"],
                f"{prefix}plain_ms": r["plain_ms"],
                f"{prefix}bound_ms": r["bound"][0],
                f"{prefix}bound_by": r["bound"][1],
                f"{prefix}library_ms": r["library_ms"],
                f"{prefix}eager_ms": r["eager_ms"],
                f"{prefix}bf16_ms": rb["ms"],
                f"{prefix}bf16_max_abs_err": rb["err"],
                f"{prefix}bf16_bound_ms": rb["bound"][0],
                f"{prefix}bf16_library_ms": rb["library_ms"]}

    def cases(kind, mode=None):
        return [dict(case=label, dtype=dtag(dtype), ms=x["ms"],
                     eager_ms=x["eager_ms"], plain_ms=x["plain_ms"],
                     library_ms=x["library_ms"], bound_ms=x["bound"][0],
                     bound_by=x["bound"][1], max_abs_err=x["err"],
                     **({"splits": x["splits"]} if "splits" in x else {}))
                for (k, label, dtype), x in vision.items()
                if k == kind and x.get("mode", mode) == mode]

    conv = {"name": cf.KERNEL, "route": "cuda",
            "source": f"paddle_tpu_torch/ops/kernels/csrc/{cf.SOURCE}.cu",
            "replaces": cf.REPLACES,
            "launches": counts.get(cf.KERNEL, 0),
            **numbers("conv", CONV_CASES[0][0]),
            "library": "F.conv2d (cuDNN, channels-last, TF32 off) on the "
                       "folded weights and bias, then the act",
            "dtype": "float32", "shape": CONV_CASES[0][0] + " b128",
            "launches_per": "vgg16_bn_drop forward (static phase, b128)",
            "cases": cases("conv")}
    pool = {"name": pl.MAX_KERNEL, "route": "cuda",
            "source": f"paddle_tpu_torch/ops/kernels/csrc/{pl.SOURCE}.cu",
            "replaces": pl.REPLACES,
            "launches": counts.get(pl.MAX_KERNEL, 0),
            **numbers("pool", POOL_CASES[0][0]),
            "library": "F.max_pool2d on a channels-last view",
            "dtype": "float32", "shape": POOL_CASES[0][0] + " b128",
            "launches_per": "vgg16_bn_drop forward (static phase, b128)",
            "cases": cases("pool", "max"),
            pl.AVG_KERNEL: {"launches": counts.get(pl.AVG_KERNEL, 0),
                            **numbers("pool", POOL_CASES[5][0]),
                            "library": "F.avg_pool2d on a channels-last "
                                       "view",
                            "cases": cases("pool", "avg")}}
    return [conv, pool]


# -- phase 9: train-mode vision forward (rows 11 and 12) -----------------------

# Rows 11 and 12 at their main-path shapes: the (rows, C) of VGG-16's
# train-mode BNs that the gate passes at b128 (groups 2-5), and one
# cold-cache shape beyond the 50 MB L2 (ResNet-50's stage 1 at b64: 64 x 56
# x 56 rows of 256 channels, 205 MB in fp32).
BN_CASES = (
    ("vgg 16x16 c128 b128", (32768, 128)),
    ("vgg 8x8 c256 b128", (8192, 256)),
    ("vgg 4x4 c512 b128", (2048, 512)),
    ("vgg 2x2 c512 b128", (512, 512)),
    ("resnet50 stage1 c256 b64 (cold)", (200704, 256)),
)
# Row 11 against its plain version: the same fp32 sums in another order,
# relative to the largest sum.  Row 12 multiplies and adds without FMA
# contraction, as the plain version does: bit for bit.
TOL_BN_STATS_REL = 1e-5
# Launches of each of rows 11 and 12 per train-mode forward, pinned on the
# CPU by tests/test_torch_bn_train.py (the JAX dispatch at full width: the
# BNs of groups 2-5); the conv-BN tower's 2.
VISION_TRAIN_LAUNCHES = {"vgg16_bn_drop": 11, "conv_bn_tower": 2}
VISION_TRAIN_BATCH = {"vgg16_bn_drop": 128, "conv_bn_tower": 64}
# The train-mode forward with rows 11-12 against the same program with their
# plain versions (same seed, same dropout masks): the batch statistics'
# fp32 sums in another order, carried through 13 normalised layers;
# relative to each fetch's and each running statistic's largest value.
TOL_VISION_TRAIN_REL = 1e-4


def bn_case(bt, gen, rows, c, dtype, timed=True):
    """Rows 11 and 12 against their plain versions (row 11 twice, bit for
    bit); with ``timed`` their times beside the plain versions', the
    library calls' (``torch.var_mean``; ``torch.addcmul`` then
    ``torch.relu``) and the bounds."""
    x = randn(gen, (rows, c), dtype, 2.0, 0.5)
    gamma = randn(gen, (c,), torch.float32, 0.2, 1.0)
    beta = randn(gen, (c,), torch.float32, 0.5)
    tag = f"{rows} x {c} {dtag(dtype)}"
    with torch.no_grad():
        s, ss = bt.batch_stats(x)
        torch.cuda.synchronize()
        ps, pss = bt.batch_stats_plain(x)
        err = max(rel_err(s, ps), rel_err(ss, pss))
        check(err <= TOL_BN_STATS_REL, f"{bt.STATS_KERNEL} {tag}: sums rel "
              f"err {err:.3g} <= {TOL_BN_STATS_REL}")
        s2, ss2 = bt.batch_stats(x)
        check(torch.equal(s, s2) and torch.equal(ss, ss2),
              f"{bt.STATS_KERNEL} {tag}: two runs agree bit for bit")
        mean = s / rows
        var = torch.clamp(ss / rows - mean * mean, min=0.0)
        a = gamma * torch.rsqrt(var + 1e-5)
        b = beta - mean * a
        y = bt.scale_act(x, a, b, "relu")
        torch.cuda.synchronize()
        check(torch.equal(y, bt.scale_act_plain(x, a, b, "relu")),
              f"{bt.SCALE_KERNEL} {tag} relu: bit for bit the plain version")
        check(torch.equal(bt.scale_act(x, a, b, ""),
                          bt.scale_act_plain(x, a, b, "")),
              f"{bt.SCALE_KERNEL} {tag} no act: bit for bit the plain "
              f"version")
        if not timed:
            return None
        elt = x.element_size()
        ad, bd = a.to(dtype), b.to(dtype)
        stats = dict(timings(lambda: bt.batch_stats(x),
                             lambda: bt.batch_stats_plain(x),
                             lambda: torch.var_mean(x, dim=0),
                             *reversed(bt.stats_cost(rows, c, elt)), dtype),
                     err=max(max_abs(s, ps), max_abs(ss, pss)))
        scale = dict(timings(lambda: bt.scale_act(x, a, b, "relu"),
                             lambda: bt.scale_act_plain(x, a, b, "relu"),
                             lambda: torch.relu(torch.addcmul(bd, x, ad)),
                             *reversed(bt.scale_cost(rows, c, elt)), dtype),
                     err=max_abs(y, bt.scale_act_plain(x, a, b, "relu")))
    return stats, scale


@contextlib.contextmanager
def bn_plain():
    """Rows 11 and 12 swapped, as module attributes, for their plain
    versions."""
    from paddle_tpu_torch.ops.kernels import bn_act_train as bt

    saved = (bt.batch_stats, bt.scale_act)
    bt.batch_stats, bt.scale_act = bt.batch_stats_plain, bt.scale_act_plain
    try:
        yield
    finally:
        bt.batch_stats, bt.scale_act = saved


def conv_bn_tower(static, L, nets, seed):
    """The conv tower with train-mode BNs (conv/BN(relu)/max-pool twice,
    fc 10; ch 128, 32 x 32) and no dropout."""
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = seed
    with static.program_guard(main, startup):
        img = L.data("img", [3, 32, 32])
        h = L.conv2d(img, 128, 3, padding=1)
        h = L.batch_norm(h, act="relu")
        h = L.pool2d(h, 2, "max", 2)
        h = L.conv2d(h, 128, 3, padding=1)
        h = L.batch_norm(h, act="relu")
        h = L.pool2d(h, 2, "max", 2)
        out = L.fc(L.flatten(h), 10)
    return main, startup, [out.name]


def bn_stat_names(program):
    return [n for op in program.global_block().ops if op.type == "batch_norm"
            for n in op.inputs["Mean"] + op.inputs["Variance"]]


def copy_scope(static, scope):
    new = static.Scope()
    for k in scope.keys():
        new.set(k, scope.find_var(k).clone())
    return new


def vision_train_model(name, build, seed):
    """One main (train-mode) program forward under DEFAULT_PIPELINE in
    fp32: launches of rows 11 and 12 per forward; the fetches and running
    statistics against the same run with their plain versions; golden
    parity with the pipeline off (programs without dropout); the forward's
    device span and a profile."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops.kernels import bn_act_train as bt
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.static import layers as L
    from paddle_tpu_torch.static import nets
    from paddle_tpu_torch.static import passes as P

    batch = VISION_TRAIN_BATCH[name]
    main, startup, fetches = build(static, L, nets, seed)
    # a nonzero program seed: with 0 the Executor draws one for each run,
    # and the two runs below would draw different dropout masks
    main.random_seed = seed + 1
    rng = np.random.default_rng(seed)
    scope0 = static.Scope()
    static.Executor(DEV).run(startup, scope=scope0)
    feed = {"img": rng.standard_normal((batch, 3, 32, 32)).astype(np.float32)}
    want = VISION_TRAIN_LAUNCHES[name]
    stats = bn_stat_names(main)
    with opt_passes("default"):
        runs = {}
        for mode in ("kernels", "plain"):
            scope = copy_scope(static, scope0)
            exe = static.Executor(DEV)      # step 0: the same dropout masks
            ctx = bn_plain() if mode == "plain" else contextlib.nullcontext()
            config.reset_counts()
            with ctx:
                outs = run_static(exe, main, feed, fetches, scope)
                torch.cuda.synchronize()
            runs[mode] = (outs, scope, config.launch_counts())
        counts = runs["kernels"][2]
        fused = [op for op in exe.executed_program(
            main, ["img"], fetches).global_block().ops
            if op.type == "fused_conv2d_bn_act"]
        check(fused and not any(op.attrs["is_test"] for op in fused),
              f"{name}: {len(fused)} train-mode fused convs run")
        for k in (bt.STATS_KERNEL, bt.SCALE_KERNEL):
            check(counts.get(k, 0) == want, f"{name}: {counts.get(k, 0)} "
                  f"{k} launches per forward (want {want})")
            check(runs["plain"][2].get(k, 0) == 0,
                  f"{name}: no {k} launch with the plain versions")
        err = {}
        for f, got, ref in zip(fetches, runs["kernels"][0], runs["plain"][0]):
            err[f] = rel_err(got, ref)
            check(torch.isfinite(got).all() and err[f] <=
                  TOL_VISION_TRAIN_REL, f"{name}: fetch {f} "
                  f"{tuple(got.shape)} kernels vs plain versions rel err "
                  f"{err[f]:.3g} <= {TOL_VISION_TRAIN_REL}")
        stat_err = 0.0
        for n in stats:
            got = runs["kernels"][1].find_var(n)
            ref = runs["plain"][1].find_var(n)
            check(not torch.equal(ref, scope0.find_var(n)),
                  f"{name}: running statistic {n} updated")
            stat_err = max(stat_err, rel_err(got, ref))
        check(stat_err <= TOL_VISION_TRAIN_REL, f"{name}: {len(stats)} "
              f"running statistics, kernels vs plain versions rel err "
              f"{stat_err:.3g} <= {TOL_VISION_TRAIN_REL}")
        scope = runs["kernels"][1]
        span = _events_ms(lambda: run_static(exe, main, feed, fetches, scope),
                          STATIC_REPS)
        with bn_plain():
            plain_span = _events_ms(
                lambda: run_static(exe, main, feed, fetches, scope),
                STATIC_REPS)
        prof = profile_forward(exe, main, feed, fetches, scope)
    out = dict(batch=batch, dtype="float32", launches=counts,
               fetch_rel_err=err, running_stats=len(stats),
               running_stats_rel_err=stat_err, forward_span_ms=span,
               plain_forward_span_ms=plain_span, profile=prof)
    if name == "conv_bn_tower":
        rewritten, _ = P.PassManager(P.DEFAULT_PIPELINE).apply(
            main, {"img"}, fetches)
        state = {k: scope0.find_var(k).cpu().numpy() for k in scope0.keys()}
        with opt_passes(""):
            rep = P.golden_parity(main, rewritten, feed, fetches, state=state,
                                  rtol=TOL_VISION_TRAIN_REL,
                                  atol=TOL_VISION_TRAIN_REL / 10, place=DEV)
        check(rep.ok, f"{name}: golden parity, pipeline (rows 11-12) vs "
              f"none (batch_norm + relu): {rep.to_text()}")
        out["golden_parity"] = dict(max_abs_err=rep.max_abs_err,
                                    state_max_err=rep.state_max_err)
    log(f"[vision train] {name} b{batch}: forward {span:.3f} ms between "
        f"device events with rows 11-12, {plain_span:.3f} ms with their "
        f"plain versions; fetch rel err {max(err.values()):.3g}, running "
        f"statistics {stat_err:.3g}")
    return counts, out


def vision_train_phase(seed):
    """The train-mode forward of VGG-16 and the conv-BN tower."""
    log("[vision train] train-mode forward under DEFAULT_PIPELINE")
    counts, out = {}, {}
    for name, build in (("vgg16_bn_drop", vgg16_bn_drop),
                        ("conv_bn_tower", conv_bn_tower)):
        counts[name], out[name] = vision_train_model(name, build, seed)
    return counts["vgg16_bn_drop"], out


# -- phase 10: int8 kernels (rows 14 and 15) -----------------------------------

# Row 14 at VGG-16's 512 x 512 fcs at b128 and an ERNIE-base FFN shape
# (4096 tokens x 768 -> 3072), as (m, k, n); row 15 at VGG-16's int8 convs
# at b128, the tower's second conv at b64, a 3x3 s2 p1 and a 7x7 s2 p3
# conv, as (n, h, w, c, o, k, s, p).
INT8_MM_CASES = (
    ("vgg fc 512->512 b128", (128, 512, 512)),
    ("ernie-base ffn 768->3072 4096 rows", (4096, 768, 3072)),
)
INT8_MM_ACT_SHAPE = (40, 256, 256)
INT8_CONV_CASES = (
    ("vgg 128->128 16x16 b128", (128, 16, 16, 128, 128, 3, 1, 1)),
    ("vgg 256->256 8x8 b128", (128, 8, 8, 256, 256, 3, 1, 1)),
    ("vgg 512->512 4x4 b128", (128, 4, 4, 512, 512, 3, 1, 1)),
    ("vgg 512->512 2x2 b128", (128, 2, 2, 512, 512, 3, 1, 1)),
    ("tower 128->128 16x16 b64", (64, 16, 16, 128, 128, 3, 1, 1)),
    ("3x3 s2 p1 128->256 16x16 b128", (128, 16, 16, 128, 256, 3, 2, 1)),
    ("7x7 s2 p3 128->128 32x32 b32", (32, 32, 32, 128, 128, 7, 2, 3)),
)
INT8_CONV_ACT_SHAPE = (2, 7, 9, 128, 128, 3, 1, 1)
# Kernel against plain version: both sum exactly and apply the epilogue as
# the same two fp32 roundings, so the piecewise-linear acts agree bit for
# bit; sigmoid and tanh differ by the ulps of expf / tanhf against
# PyTorch's (relative to the largest value; bf16: one rounding flip).
TOL_INT8_REL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}
LINEAR_ACTS = ("", "relu", "relu6")


def int8_operands(gen, x_shape, w_shape, n_out):
    x = torch.randint(-127, 128, x_shape, generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, w_shape, generator=gen, dtype=torch.int8)
    scale = torch.rand(n_out, generator=gen) * 1e-4 + 1e-5
    bias = torch.randn(n_out, generator=gen) * 0.5
    return x.to(DEV), w.to(DEV), scale.to(DEV), bias.to(DEV)


def int8_check(name, tag, got, ref, dtype, act):
    r = rel_err(got, ref)
    if act in LINEAR_ACTS:
        check(torch.equal(got, ref), f"{name} {tag}: bit for bit the plain "
              f"version")
    else:
        check(r <= TOL_INT8_REL[dtype], f"{name} {tag}: rel err {r:.3g} <= "
              f"{TOL_INT8_REL[dtype]}")
    return max_abs(got, ref)


def int8_mm_case(i8, gen, dims, dtype, act, timed=True):
    """Row 14 against its plain version (exact sums: float64 on the card);
    with ``timed`` its times beside the plain version's, ``torch._int_mm``'s
    product alone, and the bound."""
    m, k, n = dims
    x, w, scale, bias = int8_operands(gen, (m, k), (k, n), n)
    run = lambda: i8.int8_matmul_dequant(x, w, scale, bias, act, dtype)
    plain = lambda: i8.int8_matmul_dequant_plain(x, w, scale, bias, act,
                                                 dtype)
    got = run()
    torch.cuda.synchronize()
    err = int8_check(i8.MATMUL_KERNEL, f"{m}x{k} @ {k}x{n} {dtag(dtype)} "
                     f"act={act or 'none'}", got, plain(), dtype, act)
    if not timed:
        return None
    ops, nbytes = i8.matmul_cost(m, n, k, got.element_size())
    return dict(timings(run, plain, lambda: torch._int_mm(x, w), nbytes,
                        ops, torch.int8), err=err, ops=ops)


def int8_conv_case(i8, gen, dims, dtype, act, timed=True):
    """Row 15 against its plain version; with ``timed`` its times beside the
    plain version's and the bound.  No single PyTorch call computes an int8
    convolution: cuDNN's convolution on the dequantized operands
    (channels-last, in the output type, TF32 off) is timed as context."""
    n, h, w, c, o, k, s, p = dims
    x, wq, scale, bias = int8_operands(gen, (n, h, w, c), (o, c, k, k), o)
    args = ((s, s), (p, p), act, dtype)
    run = lambda: i8.int8_conv2d_dequant(x, wq, scale, bias, *args)
    plain = lambda: i8.int8_conv2d_dequant_plain(x, wq, scale, bias, *args)
    got = run()
    torch.cuda.synchronize()
    err = int8_check(i8.CONV_KERNEL, f"n{n} {h}x{w} {c}->{o} k{k} s{s} p{p} "
                     f"{dtag(dtype)} act={act or 'none'}", got, plain(),
                     dtype, act)
    if not timed:
        return None
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    ops, nbytes = i8.conv_cost(n, oh, ow, c, o, k, k, h, w,
                               got.element_size())
    xf = x.permute(0, 3, 1, 2).to(dtype) * 0.01
    wf = (wq.to(dtype) * 0.01).contiguous(memory_format=torch.channels_last)
    bf = bias.to(dtype)
    cudnn = lambda: torch.nn.functional.conv2d(xf, wf, bf, s, p)
    return dict(timings(run, plain, None, nbytes, ops, torch.int8), err=err,
                ops=ops, cudnn_dequant_ms=time_ms(cudnn))


def int8_kernel_phase(gen):
    """Rows 11 and 12 against their plain versions at their shapes in fp32
    and bf16; rows 14 and 15 at theirs, fp32 and bf16 out, every act at a
    small shape."""
    from paddle_tpu_torch.ops.kernels import bn_act_train as bt
    from paddle_tpu_torch.ops.kernels import int8 as i8

    log("[int8 kernels] rows 11, 12, 14 and 15 against their plain "
        "versions")
    bn_cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, (rows, c) in BN_CASES:
            bn_cases[(label, dtype)] = bn_case(bt, gen, rows, c, dtype)
        bn_case(bt, gen, 8 * 3, 384, dtype, timed=False)   # a ragged grid
    for (label, dtype), (st, sc) in bn_cases.items():
        for k, r in ((bt.STATS_KERNEL, st), (bt.SCALE_KERNEL, sc)):
            log(f"  {k} {label} {dtag(dtype)}: {r['ms']:.4f} ms (eager "
                f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
                f"library {r['library_ms']:.4f} ms, bound "
                f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, dims in INT8_MM_CASES:
            results[("matmul", label, dtype)] = int8_mm_case(
                i8, gen, dims, dtype, "relu")
        for label, dims in INT8_CONV_CASES:
            results[("conv", label, dtype)] = int8_conv_case(
                i8, gen, dims, dtype, "relu")
        for act in i8.EPILOGUE_ACTS:
            int8_mm_case(i8, gen, INT8_MM_ACT_SHAPE, dtype, act, timed=False)
            int8_conv_case(i8, gen, INT8_CONV_ACT_SHAPE, dtype, act,
                           timed=False)
    for (kind, label, dtype), r in results.items():
        lib = (f"torch._int_mm {r['library_ms']:.4f} ms" if kind == "matmul"
               else f"cuDNN on dequantized operands (context) "
                    f"{r['cudnn_dequant_ms']:.4f} ms")
        log(f"  int8 {kind} {label} {dtag(dtype)} out: {r['ms']:.4f} ms "
            f"(eager {r['eager_ms']:.4f} ms; {r['ops'] / r['ms'] / 1e9:.1f} "
            f"TOPS), plain {r['plain_ms']:.4f} ms, {lib}, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
    return bn_cases, results


# -- phase 11: int8 static inference -------------------------------------------

# Launches of rows 15 / 14 per int8 forward, pinned on the CPU by
# tests/test_torch_int8.py (the JAX dispatch at full width): the tower's
# second conv; VGG-16's 10 convs of C, O % 128 and its two 512 x 512 fcs.
INT8_LAUNCHES = {
    "conv_tower": {"int8_conv2d_dequant": 1, "int8_matmul_dequant": 0},
    "vgg16_bn_drop": {"int8_conv2d_dequant": 10, "int8_matmul_dequant": 2}}
# The int8 program with rows 14-15 against the same program with their
# plain versions: exact sums and the same epilogue in both, bit for bit up
# to the order of cuDNN's float convolutions elsewhere in the program.
TOL_INT8_PLAIN_REL = 1e-6
# The kernel route against the simulate route (use_pallas_int8 off: the
# fake-quant values through cuDNN's fp32 convolution or cuBLAS): the same
# int8 grid, exact sums against fp32 ones.  Each quant op of a program is
# held on the inputs the kernel route gave it, and one quantized fc is held
# end to end, to the reference's rtol = atol = 1e-4 for one fc
# (tests/test_pallas_vision.py:333), relative to the op's largest output.
# Whole programs are not compared: the next layer's quantization moves a
# value that lies an fp32 rounding from a rounding boundary by one level,
# and over VGG-16's 16 quantized layers that reaches ~1% of the largest
# logit (on the CPU, scaling the input by 1 + 1e-6 moves the int8 logits
# by 1.1% at b32); the two routes' program-level difference is printed.
TOL_INT8_OP_REL = 1e-4
TOL_INT8_FC = 1e-4
INT8_FC_BATCH = 128


@contextlib.contextmanager
def int8_plain():
    from paddle_tpu_torch.ops.kernels import int8 as i8

    saved = (i8.int8_matmul_dequant, i8.int8_conv2d_dequant)
    i8.int8_matmul_dequant = i8.int8_matmul_dequant_plain
    i8.int8_conv2d_dequant = i8.int8_conv2d_dequant_plain
    try:
        yield
    finally:
        i8.int8_matmul_dequant, i8.int8_conv2d_dequant = saved


def int8_ops_against_simulate(exe, program, feed, fetches, scope):
    """Run ``program`` recording each quant op's inputs and output, then
    hold each output against the simulate route (use_pallas_int8 off) on
    the same inputs.  Returns (ops, ops on the kernel route, worst rel err
    of an op's output relative to its largest value)."""
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.static import registry

    real = {t: registry._REGISTRY[t] for t in ("quant_conv2d", "quant_mul")}
    records = []

    def recorder(t):
        def lowering(ins, attrs, op):
            n0 = sum(config.launch_counts().values())
            outs = real[t](ins, attrs, op)
            kernel = sum(config.launch_counts().values()) > n0
            records.append((t, ins, attrs, op, outs, kernel))
            return outs
        return lowering

    registry._REGISTRY.update({t: recorder(t) for t in real})
    try:
        run_static(exe, program, feed, fetches, scope)
    finally:
        registry._REGISTRY.update(real)
    worst = 0.0
    with int8_flag(False):
        for t, ins, attrs, op, outs, _ in records:
            slot = "Output" if t == "quant_conv2d" else "Out"
            sim = real[t](ins, attrs, op)[slot][0]
            worst = max(worst, rel_err(outs[slot][0], sim))
    return len(records), sum(r[-1] for r in records), worst


@contextlib.contextmanager
def int8_flag(on):
    from paddle_tpu_torch.core import flags

    saved = flags.get_flag("use_pallas_int8")
    flags.set_flags({"use_pallas_int8": on})
    try:
        yield
    finally:
        flags.set_flags({"use_pallas_int8": saved})


def int8_model(name, build, seed):
    """One program through PTQ (one calibration batch) and
    QUANT_INFER_PIPELINE in fp32: quant op counts, launches of rows 15 / 14
    per forward, the kernel route against its plain versions and against
    the simulate route, the int8 error against the float program, images/s
    of the int8 and fp32 programs, and a profile of one int8 forward."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.slim import PostTrainingQuantization
    from paddle_tpu_torch.static import layers as L
    from paddle_tpu_torch.static import nets
    from paddle_tpu_torch.static import passes as P

    batch = STATIC_BATCH[name]
    main, startup, fetches = build(static, L, nets, seed)
    fp32_prog = main.clone(for_test=True)
    qprog = main.clone(for_test=True)
    rng = np.random.default_rng(seed)
    scope = bn_state(static, startup, qprog, rng)
    fp32_scope = copy_scope(static, scope)
    feed = {"img": rng.standard_normal((batch, 3, 32, 32)).astype(np.float32)}
    exe = static.Executor(DEV)
    with opt_passes(""):
        fp32_out = run_static(exe, fp32_prog, feed, fetches, fp32_scope)
        t0 = time.perf_counter()
        PostTrainingQuantization(
            exe, program=qprog, feed_names=["img"],
            batch_generator=lambda: iter([feed]), batch_nums=1,
            scope=scope).quantize()
        ptq_s = time.perf_counter() - t0
        rewritten, report = P.PassManager(P.QUANT_INFER_PIPELINE).apply(
            qprog, {"img"}, fetches)
        types = [op.type for op in rewritten.global_block().ops]
        quant_ops = {t: types.count(t) for t in ("quant_conv2d", "quant_mul")}
        log(f"[int8] {name} b{batch}: PTQ {ptq_s:.2f} s; "
            f"{report.to_text()}; {quant_ops}")
        run_static(exe, rewritten, feed, fetches, scope)
        torch.cuda.synchronize()
        config.reset_counts()
        outs = run_static(exe, rewritten, feed, fetches, scope)
        torch.cuda.synchronize()
        counts = config.launch_counts()
        for k, n in INT8_LAUNCHES[name].items():
            check(counts.get(k, 0) == n, f"{name}: {counts.get(k, 0)} {k} "
                  f"launches per int8 forward (want {n})")
        check(all(torch.isfinite(t).all() for t in outs),
              f"{name}: finite int8 fetches of shapes "
              f"{[tuple(t.shape) for t in outs]}")
        with int8_plain():
            plain_outs = run_static(exe, rewritten, feed, fetches, scope)
        with int8_flag(False):
            config.reset_counts()
            sim_outs = run_static(exe, rewritten, feed, fetches, scope)
            torch.cuda.synchronize()
            check(not any(k.startswith("int8") for k in
                          config.launch_counts()),
                  f"{name}: no int8 launch on the simulate route")
        errs = {}
        for f, got, ref, sim, flt in zip(fetches, outs, plain_outs, sim_outs,
                                         fp32_out):
            e_plain, e_sim = rel_err(got, ref), rel_err(got, sim)
            e_int8 = rel_err(got, flt)
            check(e_plain <= TOL_INT8_PLAIN_REL, f"{name}: fetch {f} kernels "
                  f"vs plain versions rel err {e_plain:.3g} <= "
                  f"{TOL_INT8_PLAIN_REL}")
            errs[f] = dict(vs_plain=e_plain, vs_simulate=e_sim,
                           int8_rel_err=e_int8)
        n_ops, n_kernel, op_err = int8_ops_against_simulate(
            exe, rewritten, feed, fetches, scope)
        want = sum(INT8_LAUNCHES[name].values())
        check(n_kernel == want and op_err <= TOL_INT8_OP_REL,
              f"{name}: {n_ops} quant ops ({n_kernel} on the kernels) "
              f"against the simulate route on the same inputs: rel err "
              f"{op_err:.3g} <= {TOL_INT8_OP_REL}")
        prof = profile_forward(exe, rewritten, feed, fetches, scope)
    times = interleaved_timings(
        exe, {"int8": (rewritten, scope, ""),
              "fp32": (fp32_prog, fp32_scope, "default")},
        feed, fetches, batch)
    q, f = times["int8"], times["fp32"]
    log(f"[int8] {name}: int8 {q['images_per_s']:.1f} images/s (median "
        f"{q['wall_ms']:.3f} ms a run, IQR {q['wall_iqr_ms']:.3f}; "
        f"{q['device_span_ms']:.3f} ms between device events), fp32 with "
        f"DEFAULT_PIPELINE {f['images_per_s']:.1f} images/s "
        f"({f['wall_ms']:.3f} ms, IQR {f['wall_iqr_ms']:.3f}; "
        f"{f['device_span_ms']:.3f} ms): "
        f"{q['images_per_s'] / f['images_per_s']:.3f}x; int8 rel err vs the "
        f"float program {errs[fetches[0]]['int8_rel_err']:.4g}")
    return counts, dict(
        batch=batch, dtype="float32", ptq_s=ptq_s, quant_ops=quant_ops,
        ops_before=report.ops_before, ops_after=report.ops_after,
        launches=counts, errors=errs, op_vs_simulate_rel_err=op_err,
        int8=dict(q, profile=prof), fp32=f,
        vs_fp32=q["images_per_s"] / f["images_per_s"])


def int8_fc_check(seed):
    """The reference's fc check on the card: fc 128 -> 128 + relu at b128,
    PTQ'd; its quant_mul on row 14 against the simulate route within
    rtol = atol = TOL_INT8_FC, and within the PTQ error bound of the float
    program (5% of the largest value + 1e-3)."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.slim import PostTrainingQuantization
    from paddle_tpu_torch.static import layers as L
    from paddle_tpu_torch.static import passes as P

    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = seed + 1
    with static.program_guard(main, startup):
        x = L.data("x", [128])
        y = L.fc(x, 128, act="relu")
    scope = static.Scope()
    exe = static.Executor(DEV)
    exe.run(startup, scope=scope)
    feed = {"x": np.random.default_rng(seed).standard_normal(
        (INT8_FC_BATCH, 128)).astype(np.float32)}
    with opt_passes(""):
        float_out = exe.run(main, feed=feed, fetch_list=[y], scope=scope)[0]
        PostTrainingQuantization(
            exe, program=main, feed_names=["x"],
            batch_generator=lambda: iter([feed]), batch_nums=1,
            scope=scope).quantize()
        rewritten, _ = P.PassManager(("quant_infer",)).apply(
            main, {"x"}, [y.name])
        sim = exe.run(main, feed=feed, fetch_list=[y.name], scope=scope)[0]
        config.reset_counts()
        got = exe.run(rewritten, feed=feed, fetch_list=[y.name],
                      scope=scope)[0]
        launched = config.launch_counts().get("int8_matmul_dequant", 0)
    check(launched == 1, f"fc 128 -> 128 b{INT8_FC_BATCH}: {launched} "
          f"int8_matmul_dequant launch")
    err = float(np.abs(got - sim).max())
    check(np.allclose(got, sim, rtol=TOL_INT8_FC, atol=TOL_INT8_FC),
          f"fc 128 -> 128 b{INT8_FC_BATCH}: row 14 route vs simulate route "
          f"max abs err {err:.3g} within rtol = atol = {TOL_INT8_FC}")
    scale = float(np.abs(float_out).max())
    ptq = float(np.abs(got - float_out).max())
    check(ptq <= 0.05 * scale + 1e-3, f"fc 128 -> 128: int8 vs float max "
          f"abs err {ptq:.3g} <= 5% of {scale:.3g} + 1e-3")
    return dict(vs_simulate_max_abs_err=err, vs_float_max_abs_err=ptq)


def int8_phase(seed):
    log("[int8] int8 static inference: PostTrainingQuantization, "
        "QUANT_INFER_PIPELINE, Executor")
    counts, out = {}, {"fc128": int8_fc_check(seed)}
    for name, build in (("conv_tower", conv_tower),
                        ("vgg16_bn_drop", vgg16_bn_drop)):
        counts[name], out[name] = int8_model(name, build, seed)
    return counts["vgg16_bn_drop"], out


def new_entries(bn_cases, train_counts, int8_cases, int8_counts):
    """The kernels-line entries of rows 11, 12, 14 and 15: fp32 at the
    first main-path case, bf16 beside it, every case listed; launches per
    VGG-16 forward of the [vision train] (rows 11-12) and [int8] (rows
    14-15) phases."""
    from paddle_tpu_torch.ops.kernels import bn_act_train as bt
    from paddle_tpu_torch.ops.kernels import int8 as i8

    def entry(name, source, replaces, r, rb, launches, per, shape, library,
              cases):
        return {"name": name, "route": "cuda",
                "source": f"paddle_tpu_torch/ops/kernels/csrc/{source}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                "bound_by": r["bound"][1], "library_ms": r["library_ms"],
                "library": library, "eager_ms": r["eager_ms"],
                "dtype": "float32", "shape": shape,
                "bf16_ms": rb["ms"], "bf16_max_abs_err": rb["err"],
                "bf16_bound_ms": rb["bound"][0],
                "bf16_library_ms": rb["library_ms"],
                "launches_per": per, "cases": cases}

    def cases(results, pick):
        return [dict(case=label, dtype=dtag(dtype), ms=x["ms"],
                     eager_ms=x["eager_ms"], plain_ms=x["plain_ms"],
                     library_ms=x["library_ms"], bound_ms=x["bound"][0],
                     bound_by=x["bound"][1], max_abs_err=x["err"],
                     **({"cudnn_dequant_ms": x["cudnn_dequant_ms"]}
                        if "cudnn_dequant_ms" in x else {}))
                for label, dtype, x in pick(results)]

    first = BN_CASES[0][0]
    out = []
    for i, (name, replaces, lib) in enumerate((
            (bt.STATS_KERNEL, bt.STATS_REPLACES, "torch.var_mean(x, dim=0)"),
            (bt.SCALE_KERNEL, bt.SCALE_REPLACES,
             "torch.addcmul(b, x, a) then torch.relu"))):
        out.append(entry(
            name, bt.SOURCE, replaces, bn_cases[(first, torch.float32)][i],
            bn_cases[(first, torch.bfloat16)][i],
            train_counts.get(name, 0),
            "vgg16_bn_drop train-mode forward ([vision train], b128)",
            first, lib,
            cases(bn_cases, lambda res: [(lab, dt, x[i]) for (lab, dt), x
                                         in res.items()])))
    for kind, name, source, replaces, lib, first in (
            ("conv", i8.CONV_KERNEL, i8.CONV_SOURCE, i8.CONV_REPLACES,
             "none (no PyTorch call convolves int8; cudnn_dequant_ms is "
             "cuDNN on the dequantized operands, for context)",
             INT8_CONV_CASES[0][0]),
            ("matmul", i8.MATMUL_KERNEL, i8.MATMUL_SOURCE, i8.MATMUL_REPLACES,
             "torch._int_mm (the int32 product alone)",
             INT8_MM_CASES[0][0])):
        r = int8_cases[(kind, first, torch.float32)]
        rb = int8_cases[(kind, first, torch.bfloat16)]
        e = entry(name, source, replaces, r, rb, int8_counts.get(name, 0),
                  "vgg16_bn_drop int8 forward ([int8], b128)", first, lib,
                  cases(int8_cases, lambda res: [
                      (lab, dt, x) for (k, lab, dt), x in res.items()
                      if k == kind]))
        if kind == "conv":
            e["cudnn_dequant_ms"] = r["cudnn_dequant_ms"]
        out.append(e)
    return out

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
    from paddle_tpu_torch.ops.kernels import conv_fused as cf
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fap
    from paddle_tpu_torch.ops.kernels import layer_norm as ln
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

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
    for name in (fa.SOURCE, fa.SOURCE_BWD, cf.SOURCE):
        sass = subprocess.run(
            [os.path.join(os.path.dirname(build._nvcc()), "cuobjdump"),
             "-sass", str(build.library_path(name))],
            capture_output=True, text=True, check=True).stdout
        n = len(re.findall(r"\bHGMMA\b", sass))
        check(n > 0, f"{name}: {n} HGMMA (wgmma) instructions in its SASS")
        if name == cf.SOURCE:
            n = len(re.findall(r"\bHMMA\b", sass))
            check(n == 0, f"{name}: {n} HMMA (mma.sync) instructions in its "
                  f"SASS")

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
    torch.cuda.empty_cache()
    log("[bhsd] (b, h, s, d) kernels against their plain versions")
    bhsd, cross = bhsd_kernel_phase(gen)
    bhsd_counts, bhsd_model = bhsd_model_phase(args.seed,
                                               train["tokens_per_s"])
    torch.cuda.empty_cache()
    paged = paged_kernel_phase(gen, args.seed)
    paged_launches, paged_slice = paged_slice_phase(args.seed)
    torch.cuda.empty_cache()
    vision = vision_kernel_phase(gen)
    vision_counts, static_out = static_phase(args.seed)
    torch.cuda.empty_cache()
    train_counts, vision_train = vision_train_phase(args.seed)
    torch.cuda.empty_cache()
    bn_cases, int8_cases = int8_kernel_phase(gen)
    int8_counts, int8_out = int8_phase(args.seed)

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
        if "library_ms" in at_train[k.name]:
            entry["train_shape_library_ms"] = at_train[k.name]["library_ms"]
        if (k.name, torch.float32) in at_train:
            entry["train_shape_fp32_ms"] = \
                at_train[(k.name, torch.float32)]["ms"]
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
    for k in fa.KERNELS:
        kind = "bwd" if k.name == fa.KERNEL_BWD else "fwd"
        r = bhsd[("ERNIE-base", torch.bfloat16, kind)]
        r32 = bhsd[("ERNIE-base", torch.float32, kind)]
        entry = {
            "name": k.name, "route": "cuda",
            "source": f"paddle_tpu_torch/ops/kernels/csrc/{k.source}.cu",
            "replaces": k.replaces, "launches": bhsd_counts.get(k.name, 0),
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            "library": f"F.scaled_dot_product_attention "
                       f"({r['library_backend']} backend)",
            "dtype": "bfloat16", "shape": "b8 h12 s512 d64", "eager_ms":
            r["eager_ms"], "fp32_ms": r32["ms"], "fp32_max_abs_err":
            r32["err"], "launches_per": "train step (split-head route)",
            "train_shape_ms": at_train[k.name]["ms"],
            "train_shape_bound_ms": at_train[k.name]["bound"][0],
            "train_shape_max_abs_err": at_train[k.name]["err"],
            "cases": [dict(case=label, dtype=dtag(dtype), ms=x["ms"],
                           plain_ms=x["plain_ms"],
                           library_ms=x["library_ms"],
                           bound_ms=x["bound"][0], bound_by=x["bound"][1],
                           max_abs_err=x["err"])
                      for (label, dtype, kd), x in bhsd.items()
                      if kd == kind]}
        for key in ("dropout", "dropout_ms", "library_eager_ms"):
            if key in r:
                entry[key] = r[key]
        if kind == "bwd":
            entry["library_timing"] = "torch.profiler device time"
        if kind == "fwd":
            entry["serving_launches"] = \
                bhsd_model["serving"]["launches"].get(k.name, 0)
        kernels.append(entry)
    p32 = paged[torch.float32]
    entry = {
        "name": pa.KERNEL, "route": "cuda",
        "source": f"paddle_tpu_torch/ops/kernels/csrc/{pa.SOURCE}.cu",
        "replaces": pa.REPLACES, "launches": paged_launches,
        "max_abs_err": p32["err"], "ms": p32["ms"],
        "plain_ms": p32["plain_ms"], "bound_ms": p32["bound"][0],
        "bound_by": p32["bound"][1], "library_ms": p32["library_ms"],
        "library": "F.scaled_dot_product_attention on K/V gathered "
                   "beforehand (gather excluded)",
        "dtype": "float32", "eager_ms": p32["eager_ms"],
        "launches_per": "paged slice run (96 requests)"}
    for dtype, r in paged.items():
        t = {torch.float32: "fp32", torch.bfloat16: "bf16"}.get(dtype, "int8")
        entry.update({f"{t}_ms": r["ms"], f"{t}_max_abs_err": r["err"],
                      f"{t}_bound_ms": r["bound"][0],
                      f"{t}_plain_ms": r["plain_ms"],
                      f"{t}_library_ms": r["library_ms"]})
    kernels.append(entry)
    kernels += vision_entries(vision, vision_counts)
    kernels += new_entries(bn_cases, train_counts, int8_cases, int8_counts)
    check(len(kernels) == 15, f"the kernels line lists {len(kernels)} "
          f"kernels, one for each of the 15 TPU kernels")
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"bhsd": dict(bhsd_model, kernel_a_max_abs_err=cross)}),
          flush=True)
    print(json.dumps({"paged": paged_slice}), flush=True)
    print(json.dumps({"static": static_out}), flush=True)
    print(json.dumps({"vision_train": vision_train}), flush=True)
    print(json.dumps({"int8": int8_out}), flush=True)
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
