"""Measurements behind the design of the bf16 flash-attention kernels
(PERF.md, section 6).  Not part of the port: nothing imports this module.

Run from the root of a checkout on a machine with one H100:

    python3 -m paddle_tpu_torch.ops.kernels.experiments.attention_experiments ordered
    python3 -m paddle_tpu_torch.ops.kernels.experiments.attention_experiments knockout

* ``ordered`` builds ``flash_attention_bwd_ordered.cu`` (the single-kernel
  backward with one recompute of S and an ordered dQ sum across key
  tiles), checks it against the shipped backward on the same inputs, and
  times both beside SDPA's backward at the chip smoke test's attention
  shapes and the training shape, bf16, no dropout.
* ``knockout`` builds copies of the shipped sources with one phase removed
  (the exponentials, the products, the dQ kernel, the epilogue, the
  loads) and times each, to show which phase the time goes to.

Times are device times of 10 calls captured in one CUDA graph (the
backward of SDPA by torch.profiler); the card's name and power limit are
printed first.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from .. import build
from .. import flash_attention as fa

HERE = Path(__file__).resolve().parent
OUT = build.BUILD_DIR / "experiments"
SHAPES = ((8, 12, 512, 64, False), (2, 25, 1024, 64, True),
          (1, 32, 4096, 128, True), (1, 16, 2048, 256, False),
          (2, 3, 256, 192, False), (64, 12, 512, 64, False))


def graph_ms(fn, reps=10, replays=3):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays / reps


def profiled_ms(fn, reps=10):
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / reps


def compile_lib(src: Path, name: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    out = OUT / f"{name}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
           str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(out))


def inputs(b, h, s, d, causal):
    q, k, v, do = (torch.randn(b, h, s, d, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    bias = torch.zeros(b, s, device="cuda")
    out, lse = fa.flash_attention_fwd(q, k, v, bias, d ** -0.5, causal)
    return q, k, v, do, bias, out, lse


def ordered_entry(lib):
    P, I, L, U, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                     ctypes.c_uint32, ctypes.c_float)
    fn = lib.flash_attention_packed_bwd
    fn.argtypes = ([P] * 13 + [I] + [I, I, I, I, L, L, L, F, I, U, U, F, I,
                                     I, P])
    fn.restype = I

    def run(q, k, v, bias, out, lse, do, causal):
        b, h, s, d = q.shape
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        delta = torch.empty_like(lse)
        acc = torch.empty(b, h, s, d, device="cuda")
        slices = 1 if d <= 128 else -(-d // 256)
        n_turns = b * h * slices * -(-s // 64)
        turns = torch.empty(n_turns, dtype=torch.int32, device="cuda")
        st = q.stride()
        err = fn(*(t.data_ptr() for t in (q, k, v, bias, out, do, lse, delta,
                                          dq, dk, dv, acc, turns)),
                 n_turns, b, s, h, d, st[0], st[1], st[2], d ** -0.5,
                 int(causal), 0, 0, 1.0, 0, 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ordered backward: CUDA error {err}")
        return dq, dk, dv
    return run


def ordered_main():
    run = ordered_entry(compile_lib(HERE / "flash_attention_bwd_ordered.cu",
                                    "bwd_ordered"))
    F = torch.nn.functional
    for b, h, s, d, causal in SHAPES:
        q, k, v, do, bias, out, lse = inputs(b, h, s, d, causal)
        bargs = (bias, out, lse, do, d ** -0.5, causal)
        shipped = fa.flash_attention_bwd(q, k, v, *bargs)
        other = run(q, k, v, bias, out, lse, do, causal)
        torch.cuda.synchronize()
        diff = max(float((x.float() - y.float()).abs().max()
                         / y.float().abs().max())
                   for x, y in zip(other, shipped))
        t_shipped = graph_ms(lambda: fa.flash_attention_bwd(q, k, v, *bargs))
        t_ordered = graph_ms(lambda: run(q, k, v, bias, out, lse, do, causal))
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        t_sdpa = profiled_ms(lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True))
        print(f"b{b} h{h} s{s} d{d} causal={int(causal)}: backward shipped "
              f"(dK/dV + dQ kernels) {t_shipped:.4f} ms, ordered dQ sum "
              f"{t_ordered:.4f} ms, SDPA {t_sdpa:.4f} ms; ordered vs shipped "
              f"rel diff {diff:.3g}", flush=True)


# (source, variant) -> [(text, replacement)]: each removes one phase.
FWD = "flash_attention_packed_fwd"
BWD = "flash_attention_packed_bwd"
_EXP = ("        s[4 * n] = hopper::exp2_ftz(s[4 * n] - mn0);\n"
        "        s[4 * n + 1] = hopper::exp2_ftz(s[4 * n + 1] - mn0);\n"
        "        s[4 * n + 2] = hopper::exp2_ftz(s[4 * n + 2] - mn1);\n"
        "        s[4 * n + 3] = hopper::exp2_ftz(s[4 * n + 3] - mn1);")
_QK = "            hopper::wgmma_ss<BK>(\n                s, sbase"
_PV = "            hopper::wgmma_rs64(o[v], pa[kk],"
_NODQ = ("  return launch_dq<BK, NC, NV>(a, batch, stream);", "  return 0;")
_PIPE = ("  for (int i = i0; i < nq; ++i) {\n    const int q0 = i * kBQ;\n"
         "    float sT[32], dpT[32];",
         "  for (int i = i0; i < nq; ++i) {\n    const int q0 = i * kBQ;\n"
         "    if (true) {\n      hopper::mbar_wait(full + st, ph);\n"
         "      if (lt == 0) hopper::mbar_arrive(empty + st);\n"
         "      if (++st == ST) { st = 0; ph ^= 1; }\n      continue;\n    }\n"
         "    float sT[32], dpT[32];")
_EPI = ("  // dK and dV of the consumer's keys and output boxes, staged",
        "  if (true) return;\n  // dK and dV of the consumer's keys and "
        "output boxes, staged")
_NOLOAD = [("        hopper::mbar_expect_tx(full + st, 2 * nspan * kBox + "
            "2 * kBQ * 4);", "        hopper::mbar_arrive(full + st);"),
           ("        hopper::bulk_load(stats", "        if (i < 0) "
            "hopper::bulk_load(stats"),
           ("        for (int c = 0; c < nspan; ++c) {\n          "
            "hopper::tma_load_4d(s + c * kBox, &qmap",
            "        for (int c = 0; c < 0; ++c) {\n          "
            "hopper::tma_load_4d(s + c * kBox, &qmap"),
           ("        hopper::mbar_expect_tx(kbar, 2 * NCH * KG * kBox);",
            "        hopper::mbar_arrive(kbar);"),
           ("        for (int c = 0; c < NCH; ++c)\n          for (int g = 0; "
            "g < KG; ++g) {", "        for (int c = 0; c < 0; ++c)\n"
            "          for (int g = 0; g < KG; ++g) {")]
KNOCKOUTS = {
    (FWD, "shipped"): [],
    (FWD, "no exp"): [(_EXP, _EXP.replace("hopper::exp2_ftz", ""))],
    (FWD, "no products"): [(_QK, "            if (j < 0) hopper::wgmma_ss<BK>("
                                 "\n                s, sbase"),
                           (_PV, "            if (j < 0) hopper::wgmma_rs64("
                                 "o[v], pa[kk],")],
    (BWD, "shipped"): [],
    (BWD, "no dQ kernel"): [_NODQ],
    (BWD, "no dQ, dK/dV consumers only wait"): [_NODQ, _PIPE],
    (BWD, "... and no epilogue"): [_NODQ, _PIPE, _EPI],
    (BWD, "... and no loads"): [_NODQ, _PIPE, _EPI] + _NOLOAD,
}


def knockout_main():
    libs = {}
    for (src, variant), subs in KNOCKOUTS.items():
        text = (build.CSRC / f"{src}.cu").read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{src} {variant}: anchor not found")
            text = text.replace(old, new)
        OUT.mkdir(parents=True, exist_ok=True)
        path = OUT / f"{src}-{len(libs)}.cu"
        path.write_text(text)
        libs[(src, variant)] = compile_lib(path, path.stem)
    cases = [inputs(*shape) + (shape,) for shape in
             ((64, 12, 512, 64, False), (1, 32, 4096, 128, True),
              (1, 16, 2048, 256, False))]
    for (src, variant), lib in libs.items():
        build._libs[src] = lib
        times = []
        for q, k, v, do, bias, out, lse, (_, _, _, d, causal) in cases:
            if src == FWD:
                run = lambda: fa.flash_attention_fwd(q, k, v, bias,
                                                     d ** -0.5, causal)
            else:
                run = lambda: fa.flash_attention_bwd(
                    q, k, v, bias, out, lse, do, d ** -0.5, causal)
            times.append(graph_ms(run))
        build._libs.pop(src)
        print(f"{'forward' if src == FWD else 'backward'} {variant}: "
              + ", ".join(f"{t:.4f} ms" for t in times)
              + "  (b64 h12 s512 d64; b1 h32 s4096 d128 causal; b1 h16 "
                "s2048 d256)", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("ordered", "knockout"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_experiments: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    build.build_all([FWD, BWD])
    if args.what == "ordered":
        ordered_main()
    else:
        knockout_main()
    return 0


if __name__ == "__main__":
    sys.exit(main())
