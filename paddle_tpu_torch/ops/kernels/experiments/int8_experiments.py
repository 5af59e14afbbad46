"""Measurements behind the design of the int8 GEMM kernels (rows 14 and 15;
PERF.md, section 6).  Not part of the port: nothing imports this module.

Run from the root of a checkout on a machine with one H100:

    python3 -m paddle_tpu_torch.ops.kernels.experiments.int8_experiments splits
    python3 -m paddle_tpu_torch.ops.kernels.experiments.int8_experiments variants

* ``splits`` times the shipped kernels at VGG-16's layers whose tiles do
  not fill the card, and at VGG's fc, with the K splits forced to other
  counts than ``int8.conv_plan`` / ``matmul_plan`` pick, and each of them
  and the 16x16 layer and the FFN shape with one CTA a work item instead
  of the persistent grid; each output is held bit for bit against the
  plan's.
* ``variants`` builds copies of the two sources and ``csrc/int8_gemm.cuh``
  with another tile width (``kBN`` 256: n256 wgmma, two epilogue passes),
  another number of pipeline stages or 64-column epilogue passes (a
  smaller staging buffer, room for a fifth stage), or with one phase
  knocked out (B's loads, the products, the output stores), and times them
  at VGG-16's six int8 conv shapes, VGG's fc and an ERNIE-base FFN shape
  (kBN 256 only where O % 256 == 0), each output held bit for bit against
  the plain version (a knock-out's differs).  ``--only TEXT`` keeps the
  variants whose name contains TEXT (and the shipped one).

Times are device times of 20 calls captured in one CUDA graph, fp32 out,
act relu; the card's name and power limit are printed first.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import torch

from .. import build
from .. import int8 as i8
from .attention_experiments import OUT, graph_ms

HEADER = "int8_gemm.cuh"
# (label, (n, h, w, c, o, k, s, p)), as chip_smoke.py's INT8_CONV_CASES
CONV = (("vgg 128->128 16x16", (128, 16, 16, 128, 128, 3, 1, 1)),
        ("vgg 128->256 8x8", (128, 8, 8, 128, 256, 3, 1, 1)),
        ("vgg 256->256 8x8", (128, 8, 8, 256, 256, 3, 1, 1)),
        ("vgg 256->512 4x4", (128, 4, 4, 256, 512, 3, 1, 1)),
        ("vgg 512->512 4x4", (128, 4, 4, 512, 512, 3, 1, 1)),
        ("vgg 512->512 2x2", (128, 2, 2, 512, 512, 3, 1, 1)))
# (label, (m, k, n))
MATMUL = (("vgg fc 512->512", (128, 512, 512)),
          ("ernie-base ffn 768->3072", (4096, 768, 3072)))
CONV_SPLITS = {"vgg 128->128 16x16": (1,),
               "vgg 512->512 2x2": (1, 2, 3, 4, 6, 8, 9, 12),
               "vgg 512->512 4x4": (1, 2, 3, 4),
               "vgg 256->512 4x4": (1, 2, 3),
               "vgg 256->256 8x8": (1, 2),
               "vgg 128->256 8x8": (1, 2)}
MATMUL_SPLITS = {"vgg fc 512->512": (1, 2, 4),
                 "ernie-base ffn 768->3072": (1,)}
STAGES = "constexpr int kStages = 5;"
WIDTH = "constexpr int kBN = 128;"
CHUNK = "constexpr int kChunkN = 64; "
PRODUCTS = "wgmma_s8<kBN>(acc, as + kk * 32, bs + kk * 32);"
EXPECT = "hopper::mbar_expect_tx(full + st, kStageBytes);"
STORES = "for (int b = 0; b < kChunkN * eb / 128; ++b)"
B_CONV = "hopper::tma_load_2d(b, bmap, bar, tap * s.c + c0, n0);"
B_MATMUL = "hopper::tma_load_2d(b, bmap, bar, u * kUnitK, n0);"
NO_B = {HEADER: [(EXPECT, EXPECT.replace("kStageBytes", "kABytes"))],
        "int8_conv2d_dequant.cu": [(B_CONV, "")],
        "int8_matmul_dequant.cu": [(B_MATMUL, "")]}


def _header(chunk=None, stages=None, width=None):
    subs = []
    if chunk:
        subs.append((CHUNK, CHUNK.replace("64; ", f"{chunk};")))
    if stages:
        subs.append((STAGES, STAGES.replace("5", str(stages))))
    if width:
        subs.append((WIDTH, WIDTH.replace("128", str(width))))
    return {HEADER: subs}


# name: ({file: [(anchor, replacement)]}, kBN); the knock-outs (no B
# loads, no products, no stores) compute wrong outputs on purpose and show
# where the time goes
VARIANTS = {
    "shipped (kBN 128, 5 stages, 64-column epilogue passes)": ({}, 128),
    "4 stages": (_header(stages=4), 128),
    "3 stages": (_header(stages=3), 128),
    "128-column epilogue passes, 4 stages": (_header(128, 4), 128),
    "128-column epilogue passes, 3 stages": (_header(128, 3), 128),
    "128-column epilogue passes, 2 stages": (_header(128, 2), 128),
    "32-column epilogue passes, 5 stages": (_header(32), 128),
    "32-column epilogue passes, 6 stages": (_header(32, 6), 128),
    "kBN 256, 3 stages": (_header(stages=3, width=256), 256),
    "knock-out: no B loads": (NO_B, 128),
    "knock-out: no products": ({HEADER: [(PRODUCTS, "")]}, 128),
    "knock-out: no output stores": (
        {HEADER: [(STORES, "for (int b = 0; b < 0; ++b)")]}, 128),
}

def operands(shape_x, shape_w, n_out, gen):
    x = torch.randint(-127, 128, shape_x, generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, shape_w, generator=gen, dtype=torch.int8)
    scale = torch.rand(n_out, generator=gen) * 1e-4 + 1e-5
    bias = torch.randn(n_out, generator=gen) * 0.5
    return x.cuda(), w.cuda(), scale.cuda(), bias.cuda()


def cases(gen):
    """(kind, label, run, plain, o) for every shape."""
    out = []
    for label, (n, h, w, c, o, k, s, p) in CONV:
        x, wq, sc, b = operands((n, h, w, c), (o, c, k, k), o, gen)
        args = ((s, s), (p, p), "relu")
        out.append(("conv", label,
                    lambda x=x, wq=wq, sc=sc, b=b, args=args:
                    i8.int8_conv2d_dequant(x, wq, sc, b, *args),
                    lambda x=x, wq=wq, sc=sc, b=b, args=args:
                    i8.int8_conv2d_dequant_plain(x, wq, sc, b, *args), o))
    for label, (m, k, n) in MATMUL:
        x, wq, sc, b = operands((m, k), (k, n), n, gen)
        out.append(("matmul", label,
                    lambda x=x, wq=wq, sc=sc, b=b:
                    i8.int8_matmul_dequant(x, wq, sc, b, "relu"),
                    lambda x=x, wq=wq, sc=sc, b=b:
                    i8.int8_matmul_dequant_plain(x, wq, sc, b, "relu"), n))
    return out


def _forced(plan_fn, splits):
    def plan(*a, **k):
        p = plan_fn(*a, **k)
        return p._replace(splits=min(splits, p.units))
    return plan


def splits_main(gen):
    conv_plan, matmul_plan, grid = i8.conv_plan, i8.matmul_plan, i8.grid_ctas
    for kind, label, run, _, _ in cases(gen):
        counts = (CONV_SPLITS if kind == "conv" else MATMUL_SPLITS).get(label)
        if counts is None:
            continue
        with torch.no_grad():
            ref = run()
            parts = []
            for splits in counts:
                for persistent in (True, False):
                    if kind == "conv":
                        i8.conv_plan = _forced(conv_plan, splits)
                    else:
                        i8.matmul_plan = _forced(matmul_plan, splits)
                    if not persistent:
                        i8.grid_ctas = lambda plan, sms=None: plan.ctas
                    try:
                        got = run()
                        same = torch.equal(got, ref)
                        t = graph_ms(run, reps=20)
                    finally:
                        i8.conv_plan, i8.matmul_plan = conv_plan, matmul_plan
                        i8.grid_ctas = grid
                    parts.append(f"{splits} splits{'' if persistent else ' (a CTA an item)'} "
                                 f"{t:.4f} ms{'' if same else ' DIFFERS'}")
        plan = (conv_plan(*_conv_args(label)) if kind == "conv"
                else matmul_plan(*_mm_args(label)))
        print(f"{kind} {label} (plan: {plan.splits} splits, {plan.tiles} "
              f"tiles): " + ", ".join(parts), flush=True)


def _conv_args(label):
    n, h, w, c, o, k, s, p = dict(CONV)[label]
    return n, h, w, c, o, k, k, s, s, p, p


def _mm_args(label):
    m, k, n = dict(MATMUL)[label]
    return m, n, k


def variants_main(gen, only=None):
    shapes = cases(gen)
    for i, (variant, (subs, width)) in enumerate(VARIANTS.items()):
        if only and i and only not in variant:
            continue
        vdir = OUT / f"int8-{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        for name in (HEADER, f"{i8.CONV_SOURCE}.cu",
                     f"{i8.MATMUL_SOURCE}.cu"):
            text = (build.CSRC / name).read_text()
            for old, new in subs.get(name, []):
                if old not in text:
                    raise RuntimeError(f"{variant}: anchor not found")
                text = text.replace(old, new)
            (vdir / name).write_text(text)
        libs = {}
        for src in (i8.CONV_SOURCE, i8.MATMUL_SOURCE):
            cu = vdir / f"{src}.cu"
            lib = vdir / f"{src}.so"
            proc = subprocess.run(
                [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
                 str(lib), str(cu)], capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {variant}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            spills = [line.strip() for line in proc.stdout.splitlines()
                      if "spill" in line and " 0 bytes spill" not in line]
            if spills:
                print(f"  {variant} {src}: {spills[0]}", flush=True)
            libs[src] = ctypes.CDLL(str(lib))
        saved = dict(build._libs)
        build._libs.update(libs)
        block_n = i8.BLOCK_N
        i8.BLOCK_N = width
        times = []
        try:
            with torch.no_grad():
                for kind, label, run, plain, o in shapes:
                    if o % width:
                        continue
                    same = torch.equal(run(), plain())
                    times.append(f"{label} {graph_ms(run, reps=20):.4f} ms"
                                 f"{'' if same else ' DIFFERS'}")
        finally:
            i8.BLOCK_N = block_n
            build._libs.clear()
            build._libs.update(saved)
        print(f"{variant}: " + ", ".join(times), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("splits", "variants"))
    ap.add_argument("--only", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_experiments: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    build.build_all([i8.CONV_SOURCE, i8.MATMUL_SOURCE])
    gen = torch.Generator().manual_seed(0)
    if args.what == "splits":
        splits_main(gen)
    else:
        variants_main(gen, args.only)
    return 0


if __name__ == "__main__":
    sys.exit(main())
