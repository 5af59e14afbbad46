"""Measurements behind the design of the LayerNorm backward kernels (rows 6
and 8; PERF.md, section 6).  Not part of the port: nothing imports this
module.

Run from the root of a checkout on a machine with one H100:

    python3 -m paddle_tpu_torch.ops.kernels.experiments.layer_norm_bwd_experiments

Builds copies of ``csrc/layer_norm_bwd.cu`` that differ from the shipped
source in two choices -- the CTAs an SM the registers must allow
(``__launch_bounds__``' minimum: 1 as shipped, 2 or 3) and whether a warp
issues the next row's loads before it reduces the current one -- and
times rows 6 and 8 of each at 4096 x 768 and the training shape 32768 x
768 in bf16 and fp32, with the number of kernels that spill and the CTAs
one wave holds.  Each variant's dw and db are checked bit for bit across
two calls and its outputs against the plain version.  Times are device
times of 20 calls captured in one CUDA graph; the card's name and power
limit are printed first.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import torch

from .. import build
from .. import layer_norm as ln
from .attention_experiments import OUT, graph_ms

SRC = ln.SOURCE_BWD
BOUNDS = "__global__ void __launch_bounds__(kThreads)\nln_bwd_kernel("
PREFETCH = "  constexpr bool PREFETCH = kRowRegs <= 9;"
VARIANTS = {
    "shipped (min 1 CTA an SM, prefetch)": [],
    "min 2 CTAs an SM, prefetch": [
        (BOUNDS, BOUNDS.replace("(kThreads)", "(kThreads, 2)"))],
    "min 1 CTA an SM, no prefetch": [
        (PREFETCH, PREFETCH.replace("kRowRegs <= 9", "false"))],
    "min 2 CTAs an SM, no prefetch": [
        (BOUNDS, BOUNDS.replace("(kThreads)", "(kThreads, 2)")),
        (PREFETCH, PREFETCH.replace("kRowRegs <= 9", "false"))],
    "min 3 CTAs an SM, no prefetch": [
        (BOUNDS, BOUNDS.replace("(kThreads)", "(kThreads, 3)")),
        (PREFETCH, PREFETCH.replace("kRowRegs <= 9", "false"))],
}
DIM = 768


def inputs(n, dtype, gen):
    def rn(shape, scale=1.0, shift=0.0):
        t = torch.randn(shape, generator=gen) * scale + shift
        return t.to(dtype).cuda()

    x, res, dy = rn((n, DIM), 2.0, 0.5), rn((n, DIM)), rn((n, DIM))
    w, b = rn((DIM,), 0.1, 1.0), rn((DIM,), 0.1)
    _, mean, rstd = ln.layer_norm_fwd(x, w, b)
    _, mean_c, rstd_c = ln.residual_layer_norm_fwd(x, res, w, b, 1e-5, 0.1,
                                                   7)
    return x, res, dy, w, mean, rstd, mean_c, rstd_c


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        print("layer_norm_bwd_experiments: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    gen = torch.Generator().manual_seed(0)
    cases = {(dtype, n): inputs(n, dtype, gen)
             for dtype in (torch.bfloat16, torch.float32)
             for n in (4096, 32768)}
    text = (build.CSRC / f"{SRC}.cu").read_text()
    for i, (variant, subs) in enumerate(VARIANTS.items()):
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
        spills = sum(1 for line in (proc.stdout + proc.stderr).splitlines()
                     if "spill stores" in line
                     and not line.strip().startswith("0 bytes"))
        build._libs[SRC] = ctypes.CDLL(str(lib))
        ln._RESIDENT.clear()
        parts = []
        for (dtype, n), (x, res, dy, w, m, r, mc, rc) in cases.items():
            got = ln.layer_norm_bwd(x, w, m, r, dy)
            again = ln.layer_norm_bwd(x, w, m, r, dy)
            ref = ln.layer_norm_bwd_plain(x.float(), w.float(), m, r,
                                          dy.float())
            err = max(float((g.float() - q).abs().max() / q.abs().max())
                      for g, q in zip(got, ref))
            same = all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))
            t6 = graph_ms(lambda: ln.layer_norm_bwd(x, w, m, r, dy), reps=20)
            t8 = graph_ms(lambda: ln.residual_layer_norm_bwd(
                x, res, w, mc, rc, dy, 0.1, 7), reps=20)
            parts.append(f"{str(dtype)[6:]} {n}x{DIM}: row 6 {t6:.4f} ms, "
                         f"row 8 {t8:.4f} ms (rel err {err:.2g}, dw/db "
                         f"repeat {same})")
        build._libs.pop(SRC)
        print(f"{variant}: {spills} spilling kernels, CTAs a wave "
              f"{sorted(set(ln._RESIDENT.values()))}; " + "; ".join(parts),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
