"""Measurements behind the design of the fused conv kernel (row 10; PERF.md,
section 6).  Not part of the port: nothing imports this module.

Run from the root of a checkout on a machine with one H100:

    python3 -m paddle_tpu_torch.ops.kernels.experiments.conv_experiments splits
    python3 -m paddle_tpu_torch.ops.kernels.experiments.conv_experiments knockout

* ``splits`` times the shipped kernel at VGG-16's small layers and the
  1x1 s2 conv with the K splits forced to other counts than
  ``conv_fused.conv_plan`` picks (each output's largest difference from
  the plan's output printed beside its time), bf16 and fp32.
* ``knockout`` builds copies of ``csrc/conv2d_bn_act.cu`` with one phase of
  the bf16 kernel removed (the products, the A loads, the B loads, the
  epilogue, the epilogue's act, its global stores) and times each, to
  show which phase the time goes to.

Times are device times of 20 calls captured in one CUDA graph; the card's
name and power limit are printed first.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys

import torch

from .. import build
from .. import conv_fused as cf
from .attention_experiments import OUT, graph_ms

SRC = cf.SOURCE
# (label, (n, h, w, c, o, k, s, p)), as chip_smoke.py's CONV_CASES
CASES = (("vgg 128->128 16x16", (128, 16, 16, 128, 128, 3, 1, 1)),
         ("vgg 256->256 8x8", (128, 8, 8, 256, 256, 3, 1, 1)),
         ("vgg 512->512 4x4", (128, 4, 4, 512, 512, 3, 1, 1)),
         ("vgg 512->512 2x2", (128, 2, 2, 512, 512, 3, 1, 1)),
         ("1x1 s2 256->512 8x8", (128, 8, 8, 256, 512, 1, 2, 0)))
SPLITS = {"vgg 256->256 8x8": (1, 2),
          "vgg 512->512 4x4": (1, 2, 3, 5),
          "vgg 512->512 2x2": (1, 4, 8, 9, 12, 16),
          "1x1 s2 256->512 8x8": (1, 2, 4)}
PRODUCTS = """#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_ss128(acc, hopper::desc_sw128(as + kk * 32),
                            hopper::desc_sw128(bs + kk * 32), 1);"""
A_LOAD = """        hopper::tma_load_im2col_4d(stage, &amap, full + st, c0, w0, h0, img,
                                   (uint16_t)j, (uint16_t)i);"""
B_LOAD = """        hopper::tma_load_2d(stage + kABytes, &bmap, full + st,
                            tap * s.c + c0, n0);"""
EXPECT = "hopper::mbar_expect_tx(full + st, kStageBytes);"
EPILOGUE = "    const int64_t p0 = m0 + cw * 64;"
ACT = "apply_act(acc[4 * n + 2 * half] * av.x + bv.x, kAct);"
ACT1 = "apply_act(acc[4 * n + 2 * half + 1] * av.y + bv.y, kAct);"
STORE = "      if (r < rows)\n        *reinterpret_cast<uint4*>(out"
KNOCKOUTS = {
    "shipped": [],
    "no products": [(PRODUCTS, "")],
    "no A loads": [(A_LOAD, ""), (EXPECT, EXPECT.replace("kStageBytes",
                                                         "kBBytes"))],
    "no B loads": [(B_LOAD, ""), (EXPECT, EXPECT.replace("kStageBytes",
                                                         "kABytes"))],
    "no epilogue": [(EPILOGUE, "    if (act >= 0) return;\n" + EPILOGUE)],
    "epilogue without the act": [
        (ACT, "acc[4 * n + 2 * half] * av.x + bv.x;"),
        (ACT1, "acc[4 * n + 2 * half + 1] * av.y + bv.y;")],
    "epilogue without its global stores": [
        (STORE, STORE.replace("(r < rows)", "(r < rows && act < 0)"))],
}


def inputs(dims, dtype, gen):
    n, h, w, c, o, k, s, p = dims
    x = (torch.randn((n, h, w, c), generator=gen)).to(dtype).cuda()
    wt = (torch.randn((o, c, k, k), generator=gen)
          / math.sqrt(c * k * k)).to(dtype).cuda()
    a = (torch.randn((o,), generator=gen) * 0.2 + 1.0).cuda()
    b = (torch.randn((o,), generator=gen) * 0.5).cuda()
    return x, wt, a, b, ((s, s), (p, p), "relu")


def splits_main(gen):
    plan_fn = cf.conv_plan
    for dtype in (torch.bfloat16, torch.float32):
        for label, dims in CASES:
            if label not in SPLITS:
                continue
            x, wt, a, b, args = inputs(dims, dtype, gen)
            with torch.no_grad():
                ref = cf.conv2d_bn_act(x, wt, a, b, *args)
                shipped = plan_fn(*dims[:5], dims[5], dims[5], dims[6],
                                  dims[6], dims[7], dims[7], dtype).splits
                parts = []
                for splits in SPLITS[label]:
                    def forced(*a_, **k_):
                        plan = plan_fn(*a_, **k_)
                        return plan._replace(splits=min(splits, plan.units))
                    cf.conv_plan = forced
                    try:
                        got = cf.conv2d_bn_act(x, wt, a, b, *args)
                        err = float((got.float() - ref.float()).abs().max())
                        t = graph_ms(lambda: cf.conv2d_bn_act(x, wt, a, b,
                                                              *args),
                                     reps=20)
                    finally:
                        cf.conv_plan = plan_fn
                    parts.append(f"{splits} splits {t:.4f} ms (max abs vs "
                                 f"the plan's {err:.3g})")
            print(f"{label} {str(dtype)[6:]} (plan: {shipped} splits): "
                  + ", ".join(parts), flush=True)


def knockout_main(gen):
    text = (build.CSRC / f"{SRC}.cu").read_text()
    cases = [(label, inputs(dims, torch.bfloat16, gen))
             for label, dims in CASES[:4]]
    for i, (variant, subs) in enumerate(KNOCKOUTS.items()):
        src = text
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"{variant}: anchor not found")
            src = src.replace(old, new)
        OUT.mkdir(parents=True, exist_ok=True)
        path = OUT / f"{SRC}-{i}.cu"
        path.write_text(src)
        lib = OUT / f"{path.stem}.so"
        proc = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
             str(lib), str(path)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {variant}:\n{proc.stdout}"
                               f"{proc.stderr}")
        build._libs[SRC] = ctypes.CDLL(str(lib))
        times = []
        with torch.no_grad():
            for label, (x, wt, a, b, args) in cases:
                t = graph_ms(lambda: cf.conv2d_bn_act(x, wt, a, b, *args),
                             reps=20)
                times.append(f"{label} {t:.4f} ms")
        build._libs.pop(SRC)
        print(f"bf16 {variant}: " + ", ".join(times), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("splits", "knockout"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("conv_experiments: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    build.build_all([SRC])
    gen = torch.Generator().manual_seed(0)
    if args.what == "splits":
        splits_main(gen)
    else:
        knockout_main(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
