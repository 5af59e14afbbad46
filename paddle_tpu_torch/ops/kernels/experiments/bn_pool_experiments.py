"""Measurements behind the design of the batch-statistics kernel (row 11)
and the NHWC pool (row 13) (PERF.md, section 6).  Not part of the port: the
port imports nothing here.

Run from the root of a checkout on a machine with one H100:

    python3 -m paddle_tpu_torch.ops.kernels.experiments.bn_pool_experiments stats
    python3 -m paddle_tpu_torch.ops.kernels.experiments.bn_pool_experiments plans
    python3 -m paddle_tpu_torch.ops.kernels.experiments.bn_pool_experiments variants
    python3 -m paddle_tpu_torch.ops.kernels.experiments.bn_pool_experiments pool
    python3 -m paddle_tpu_torch.ops.kernels.experiments.bn_pool_experiments sass

* ``stats`` times, at VGG-16's four train-mode BN shapes at b128 in fp32
  and bf16, cold (``chip_smoke.cold_ms``: inputs cycled through >= 200 MB
  in one CUDA graph) and warm (``chip_smoke.time_ms``): the shipped
  one-launch cluster kernel at its plan, the same kernel with the plan
  forced to clusters of 8 and to twice and half the channel tile, the
  pull alternative (``bn_stats_pull.cu``: the same cluster, partials read
  through distributed shared memory between two cluster barriers), the
  cooperative alternative (one grid barrier, partials in scratch;
  ``bn_stats_coop.cu``) and the two-pass alternative with few partials
  and a wide second pass (``bn_stats_two_pass.cu``) at 16 and 32 row
  blocks, the baseline (``bn_stats_pr6.cu``, the two-launch design the
  shipped one replaced) and ``torch.var_mean``.  Each kernel's sums are
  held within 1e-5 of the plain version and bit for bit across two runs.
  It prints ``cudaOccupancyMaxActiveClusters`` of each plan first, and
  each variant's total over a VGG forward's launches last.
* ``plans`` times the shipped kernel at every channel tile and cluster
  of 1-16 at the same shapes (the plan's choice is fitted to these).
* ``variants`` builds copies of ``csrc/bn_act_train.cu`` (one nvcc each,
  all at once) with 16 or 4 loads in flight, 512 threads, unused shared
  memory that spreads the CTAs over more SMs, and knock-outs (no loads,
  no distributed-shared-memory stores, no cluster barriers: wrong sums on
  purpose) and times them at the plan.  ``--only TEXT`` keeps the
  variants whose name contains TEXT (and the shipped one).
* ``pool`` times, at VGG-16's four 2x2/2 max pools at b128 in fp32 and
  bf16, cold and warm: the shipped kernel at its plan and with its CTA
  forced to 256, 128, 64 and 32 threads, the baseline
  (``pool2d_nhwc_pr5.cu``: runtime windows, 8 channels a thread) and
  ``F.max_pool2d`` on a channels-last view; each kernel bit for bit the
  plain version.
* ``sass`` disassembles the shipped and the baseline pool libraries
  (``cuobjdump -sass``) and prints, for each 2x2/2 fp32 max kernel, how
  many 16-byte loads it issues before its first compare; and the shipped
  statistics kernels' loads.

The card's name and power limit are printed first.  The script imports
``chip_smoke`` from the current directory (the checkout's root).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import math
import os
import re
import subprocess
import sys

import torch

from .. import bn_act_train as bt
from .. import build
from .. import pooling as pl
from .attention_experiments import HERE, OUT, compile_lib

PULL = ("bn_stats_pull.cu", "bn_stats_pull")
STATS_ALTERNATIVES = {"coop": ("bn_stats_coop.cu", "bn_stats_coop"),
                      "two-pass": ("bn_stats_two_pass.cu",
                                   "bn_stats_two_pass")}


@functools.lru_cache(maxsize=None)
def library(source: str, name: str) -> ctypes.CDLL:
    return compile_lib(HERE / source, name)


def _cs():
    import chip_smoke as cs   # the checkout's root is the current directory

    return cs


@contextlib.contextmanager
def patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


# -- row 11 ---------------------------------------------------------------------

def baseline_stats(x):
    """The two-launch baseline (partials of C / 128 x row blocks, then a
    narrow reduce) with the grid it shipped with."""
    lib = library("bn_stats_pr6.cu", "bn_stats_pr6")
    fn = lib.bn_batch_stats
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes, fn.restype = [P] * 5 + [L, I, L, I, I, P], I
    rows, c = x.shape
    rows_per, parts = bt._grid(rows, c)
    part = torch.empty((2, parts, c), dtype=torch.float32, device=x.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
             out[0].data_ptr(), out[1].data_ptr(), rows, c, rows_per, parts,
             bt._DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"baseline stats: CUDA error {err}")
    return out[0], out[1]


def alternative_stats(kind, blocks):
    """``kind`` ("coop" or "two-pass") over ``blocks`` row blocks at the
    shipped plan's channel tile, widened until the grid has at most
    STATS_CTAS CTAs; partials in scratch made each call."""
    source, symbol = STATS_ALTERNATIVES[kind]
    fn = getattr(library(source, symbol.replace("bn_stats_", "stats_")),
                 symbol)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes, fn.restype = [P] * 4 + [L, I, I, I, L, I, P], I

    def run(x):
        rows, c = x.shape
        tile = bt.stats_plan(rows, c, x.dtype).tile_c
        while (c // tile) * blocks > bt.STATS_CTAS and c % (2 * tile) == 0 \
                and 2 * tile in bt.STATS_TILES:
            tile *= 2    # at most STATS_CTAS CTAs, all resident at once
        rows_per = -(-rows // blocks)
        part = torch.empty((2, blocks, c), dtype=torch.float32,
                           device=x.device)
        out = torch.empty((2, c), dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), part.data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr(), rows, c, tile, blocks, rows_per,
                 bt._DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{kind} stats: CUDA error {err}")
        return out[0], out[1]
    return run


def forced_stats(cluster=None, tile_scale=1):
    """The shipped kernel with its plan's cluster and channel tile
    forced."""
    plan_of = bt.stats_plan

    def run(x):
        rows, c = x.shape
        p = plan_of(rows, c, x.dtype)
        tile = p.tile_c * tile_scale if tile_scale >= 1 else \
            int(p.tile_c * tile_scale)
        r = cluster or p.cluster
        forced = bt.StatsPlan(tile_c=tile, channel_tiles=c // tile,
                              cluster=r, row_blocks=r,
                              rows_per_cta=-(-rows // r), threads=p.threads)
        with patched(bt, "stats_plan", lambda *a: forced):
            return bt.batch_stats(x)
    return run


def stats_variants(dtype):
    out = {"shipped (plan)": bt.batch_stats,
           "shipped, clusters of 8": forced_stats(cluster=8),
           "shipped, channel tile x2": forced_stats(tile_scale=2),
           "shipped, channel tile /2": forced_stats(tile_scale=0.5),
           "pull (two cluster barriers)": stats_with(pull_entry(),
                                                     bt.stats_plan),
           "baseline (two launches)": baseline_stats}
    for kind in STATS_ALTERNATIVES:
        for blocks in (16, 32):
            out[f"{kind}, {blocks} row blocks"] = alternative_stats(kind,
                                                                    blocks)
    return out


def pull_entry():
    fn = library(PULL[0], "stats_pull").bn_stats_pull
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes, fn.restype = [P] * 3 + [L, I, I, I, L, I, P], I
    return fn


def _valid_tile(rows, c, dtype, scale):
    tile = bt.stats_plan(rows, c, dtype).tile_c
    tile = int(tile * scale)
    return tile in bt.STATS_TILES and c % tile == 0 \
        and tile * dtype.itemsize >= 32


def measure(cs, tag, fn, check, make, in_bytes, bnd, launches, totals,
            key):
    """Print ``fn``'s cold and warm times beside the bound and ``check()``
    (a string), and keep (launches, cold ms, bound) under ``key``; a
    variant that fails is reported and skipped."""
    try:
        verdict = check()
        warm = cs.time_ms(lambda: fn(*make.first))
        cold = cs.cold_ms(fn, make, in_bytes)[0]
    except Exception as e:   # report the variant, go on with the others
        print(f"{tag}: FAILED {type(e).__name__}: {e}", flush=True)
        return
    totals.setdefault(key, []).append((launches, cold, bnd))
    print(f"{tag}: cold {cold:.4f} ms ({bnd / cold:.2f} of the bound "
          f"{bnd:.4f}), warm {warm:.4f} ms {verdict}", flush=True)


def print_totals(totals, cases, what):
    print(f"a VGG-16 forward's {what}, cold:", flush=True)
    for (name, dtype), rows in totals.items():
        if len(rows) != cases:
            continue
        ms = sum(n * t for n, t, _ in rows)
        bnd = sum(n * b for n, _, b in rows)
        print(f"  {name} {str(dtype)[6:]}: {ms:.4f} ms, {bnd / ms:.2f} of "
              f"the bound {bnd:.4f} ms", flush=True)


class Inputs:
    """The input sets of one shape, drawn once for every variant: as many
    as ``chip_smoke.cold_ms`` cycles for inputs of ``in_bytes``; ``make()``
    returns them in turn, ``first`` is the one checked."""

    def __init__(self, cs, draw, in_bytes):
        n = max(4, math.ceil(cs.COLD_BYTES / in_bytes))
        self.sets = [draw() for _ in range(n)]
        self.first = self.sets[0]
        self.turn = 0

    def __call__(self):
        self.turn += 1
        return self.sets[(self.turn - 1) % len(self.sets)]


def stats_main():
    cs = _cs()
    gen = torch.Generator().manual_seed(12)
    for dtype in (torch.float32, torch.bfloat16):
        for label, (rows, c) in cs.COLD_BN_CASES:
            p = bt.stats_plan(rows, c, dtype)
            print(f"plan {label} {cs.dtag(dtype)}: {p} ({p.ctas} CTAs, "
                  f"{p.channel_tiles} clusters); max active clusters "
                  f"{bt.stats_max_clusters(rows, c, dtype)} (clusters of 8:"
                  f" {_max_clusters_at(rows, c, dtype, 8)})", flush=True)
    totals = {}
    for dtype in (torch.float32, torch.bfloat16):
        elt = dtype.itemsize
        for (label, (rows, c)), launches in zip(cs.COLD_BN_CASES,
                                                cs.COLD_BN_LAUNCHES):
            flops, nbytes = bt.stats_cost(rows, c, elt)
            bnd = cs.bound(nbytes, flops, dtype)[0]
            make = Inputs(cs, lambda: (cs.randn(gen, (rows, c), dtype,
                                                2.0, 0.5),), rows * c * elt)
            x = make.first[0]
            ps, pss = bt.batch_stats_plain(x)
            variants = dict(stats_variants(dtype), **{
                "torch.var_mean": lambda x: torch.var_mean(x, dim=0)})
            for name, fn in variants.items():
                if ("tile x2" in name and not _valid_tile(rows, c, dtype, 2)
                        or "tile /2" in name
                        and not _valid_tile(rows, c, dtype, 0.5)):
                    continue

                def check(fn=fn, name=name):
                    if name == "torch.var_mean":
                        return "(library)"
                    s, ss = fn(x)
                    s2, ss2 = fn(x)
                    err = max(cs.rel_err(s, ps), cs.rel_err(ss, pss))
                    same = torch.equal(s, s2) and torch.equal(ss, ss2)
                    ok = err <= cs.TOL_BN_STATS_REL and same
                    return (f"(rel err {err:.3g}, repeats {same}) "
                            f"[{'ok' if ok else 'FAILED'}]")
                measure(cs, f"{label} {cs.dtag(dtype)} {name}", fn, check,
                        make, rows * c * elt, bnd, launches, totals,
                        (name, dtype))
    print_totals(totals, len(cs.COLD_BN_CASES),
                 "11 launches (2, 3, 3, 3 at the four shapes)")


def _max_clusters_at(rows, c, dtype, cluster):
    p = bt.stats_plan(rows, c, dtype)
    forced = bt.StatsPlan(tile_c=p.tile_c, channel_tiles=p.channel_tiles,
                          cluster=cluster, row_blocks=cluster,
                          rows_per_cta=-(-rows // cluster), threads=p.threads)
    with patched(bt, "stats_plan", lambda *a: forced):
        return bt.stats_max_clusters(rows, c, dtype)


def stats_with(fn, plan):
    """The shipped wrapper's call of a ``bn_batch_stats`` C entry ``fn``
    (the shipped library's or a variant's) with ``plan``."""
    def run(x):
        rows, c = x.shape
        p = plan(rows, c, x.dtype)
        out = torch.empty((2, c), dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), rows, c,
                 p.tile_c, p.cluster, p.rows_per_cta, bt._DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"stats variant: CUDA error {err}")
        return out[0], out[1]
    return run


def plan_of(tile, cluster):
    """A plan with the channel tile and cluster forced (None: the shipped
    plan's)."""
    def plan(rows, c, dtype):
        p = bt.stats_plan(rows, c, dtype)
        t, r = tile or p.tile_c, cluster or p.cluster
        return bt.StatsPlan(tile_c=t, channel_tiles=c // t, cluster=r,
                            row_blocks=r, rows_per_cta=-(-rows // r),
                            threads=p.threads)
    return plan


PUSH = ("    *cluster.map_shared_rank(&recv[rank * cols + o / R], "
        "(unsigned)(o % R)) =\n        mine;")
PUSH_LOCAL = "    recv[rank * cols + o / R] = mine;"
NO_LOADS = ("raw[u] = __ldg(reinterpret_cast<const uint4*>(q + u * "
            "lane_stride));", "raw[u] = make_uint4(0u, 0u, 0u, u);")
NO_BARRIERS = [("  cluster_arrive_relaxed();\n", ""),
               ("  cluster_wait();\n", ""), (PUSH, PUSH_LOCAL),
               ("  cluster.sync();\n", "  __syncthreads();\n")]
def pad_smem(kb):
    """Dynamic shared memory the kernel does not use, so that at most
    228 // kb CTAs share an SM: a cluster spreads over more SMs."""
    return [("    cfg->dynamicSmemBytes = 0;",
             f"    cfg->dynamicSmemBytes = {kb} * 1024;"),
            ("          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);",
             "          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
             "      if (err == cudaSuccess) err = cudaFuncSetAttribute("
             "bn_stats_cluster_kernel<T, TC>, "
             f"cudaFuncAttributeMaxDynamicSharedMemorySize, {kb} * 1024);")]


# name: [(anchor in csrc/bn_act_train.cu, replacement)]; the knock-outs
# compute wrong sums on purpose and show where the time goes
STATS_VARIANTS = {
    "shipped": [],
    "16 loads in flight": [("constexpr int kInFlight = 8;",
                            "constexpr int kInFlight = 16;")],
    "4 loads in flight": [("constexpr int kInFlight = 8;",
                           "constexpr int kInFlight = 4;")],
    "512 threads": [("constexpr int kStatsThreads = 256;",
                     "constexpr int kStatsThreads = 512;")],
    "one CTA an SM (116 KB of padding)": pad_smem(116),
    "two CTAs an SM (100 KB of padding)": pad_smem(100),
    "knock-out: no loads": [NO_LOADS],
    "knock-out: no DSMEM stores": [(PUSH, PUSH_LOCAL)],
    "knock-out: no cluster barriers, no DSMEM": NO_BARRIERS,
    "knock-out: no loads, no cluster barriers, no DSMEM":
        [NO_LOADS] + NO_BARRIERS,
}


def variant_libraries(only=None):
    """{name: the C entry of each variant}, one nvcc each, all at once."""
    src = (build.CSRC / f"{bt.SOURCE}.cu").read_text()
    procs = {}
    for i, (name, subs) in enumerate(STATS_VARIANTS.items()):
        if only and only not in name and name != "shipped":
            continue
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: anchor not found: {old!r}")
            text = text.replace(old, new)
        d = OUT / f"stats_variant_{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "bn_act_train.cu").write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
               str(d / "lib.so"), str(d / "bn_act_train.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       d)
    out = {}
    for name, (proc, d) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed:\n{log}", flush=True)
            continue
        spills = sorted({m for m in re.findall(r"(\d+) bytes spill stores",
                                               log) if m != "0"})
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers",
                                                  log)})
        print(f"{name}: registers {regs}, spill stores {spills or 0}",
              flush=True)
        fn = ctypes.CDLL(str(d / "lib.so")).bn_batch_stats
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes, fn.restype = [P] * 3 + [L, I, I, I, L, I, P], I
        out[name] = fn
    return out


def stats_sweep(rows_of_variants, title):
    """Cold and warm times of each (name, run) of ``rows_of_variants`` at
    VGG-16's four shapes in fp32 and bf16, with the forward's totals."""
    cs = _cs()
    gen = torch.Generator().manual_seed(12)
    totals = {}
    for dtype in (torch.float32, torch.bfloat16):
        elt = dtype.itemsize
        for (label, (rows, c)), launches in zip(cs.COLD_BN_CASES,
                                                cs.COLD_BN_LAUNCHES):
            flops, nbytes = bt.stats_cost(rows, c, elt)
            bnd = cs.bound(nbytes, flops, dtype)[0]
            make = Inputs(cs, lambda: (cs.randn(gen, (rows, c), dtype,
                                                2.0, 0.5),), rows * c * elt)
            x = make.first[0]
            ps, pss = bt.batch_stats_plain(x)
            for name, run in rows_of_variants(rows, c, dtype):
                def check(run=run):
                    s, ss = run(x)
                    err = max(cs.rel_err(s, ps), cs.rel_err(ss, pss))
                    return f"(rel err {err:.3g})"
                measure(cs, f"{label} {cs.dtag(dtype)} {name}", run, check,
                        make, rows * c * elt, bnd, launches, totals,
                        (name, dtype))
    print_totals(totals, len(cs.COLD_BN_CASES), title)


def plans_main():
    shipped = bt._entry(bt.STATS_KERNEL)

    def rows_of(rows, c, dtype):
        for tile in bt.STATS_TILES:
            if c % tile or tile * dtype.itemsize < 32:
                continue
            for cluster in (1, 2, 4, 8, 16):
                if cluster <= rows:
                    yield (f"tile {tile}, cluster {cluster}",
                           stats_with(shipped, plan_of(tile, cluster)))
        yield "the plan", stats_with(shipped, bt.stats_plan)
    stats_sweep(rows_of, "11 launches")


def variants_main(only=None):
    libs = variant_libraries(only)

    def rows_of(rows, c, dtype):
        for name, fn in libs.items():
            yield name, stats_with(fn, bt.stats_plan)
            if "an SM" in name:   # and with clusters of 8 and 4
                for r in (8, 4):
                    yield (f"{name}, clusters of {r}",
                           stats_with(fn, plan_of(None, r)))
    stats_sweep(rows_of, "11 launches")


# -- row 13 ---------------------------------------------------------------------

def baseline_pool(x, kernel, stride, padding):
    lib = library("pool2d_nhwc_pr5.cu", "pool2d_nhwc_pr5")
    fn = lib.pool2d_nhwc
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [P, P] + [I] * 11 + [ctypes.c_float, I, P], I
    n, h, w, c = x.shape
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    out = torch.empty((n, (h + 2 * ph - kh) // sh + 1,
                       (w + 2 * pw - kw) // sw + 1, c), dtype=x.dtype,
                      device=x.device)
    err = fn(x.data_ptr(), out.data_ptr(), n, h, w, c, kh, kw, sh, sw, ph,
             pw, 1, 1.0 / (kh * kw), pl._DTYPE_CODES[x.dtype],
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"baseline pool: CUDA error {err}")
    return out


def forced_pool(threads):
    plan_of = pl.pool_plan

    def run(x, *args):
        def plan(*a, **k):
            p = plan_of(*a, **k)
            return p.__class__(**dict(vars(p), threads=threads))
        with patched(pl, "pool_plan", plan):
            return pl.max_pool2d_nhwc(x, *args)
    return run


def pool_main():
    cs = _cs()
    gen = torch.Generator().manual_seed(13)
    F = torch.nn.functional
    totals = {}
    for dtype in (torch.float32, torch.bfloat16):
        elt = dtype.itemsize
        for (label, (mode, n, h, w, c, k, s, p)), launches in zip(
                cs.COLD_POOL_CASES, cs.COLD_POOL_LAUNCHES):
            args = ((k, k), (s, s), (p, p))
            oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
            flops, nbytes = pl.pool_cost(n, oh, ow, c, k, k, elt, h, w)
            bnd = cs.bound(nbytes, flops, dtype)[0]
            plan = pl.pool_plan(n, h, w, c, k, k, s, s, dtype, p, p)
            make = Inputs(cs, lambda: (cs.randn(gen, (n, h, w, c), dtype),),
                          n * h * w * c * elt)
            x = make.first[0]
            ref = pl.max_pool2d_nhwc_plain(x, *args)
            variants = {f"shipped (plan: {plan.threads} threads, "
                        f"{plan.ctas} CTAs)": pl.max_pool2d_nhwc}
            for t in pl.POOL_THREADS:
                variants[f"shipped, {t} threads"] = forced_pool(t)
            variants["baseline (runtime window)"] = baseline_pool
            variants["F.max_pool2d"] = lambda x, *a: F.max_pool2d(
                x.permute(0, 3, 1, 2), k, s, p)
            for name, fn in variants.items():
                run = lambda x, fn=fn: fn(x, *args)

                def check(run=run, name=name):
                    if name == "F.max_pool2d":
                        return "(library)"
                    ok = torch.equal(run(x), ref)
                    return f"[{'ok' if ok else 'FAILED'}: bit for bit]"
                measure(cs, f"{label} {cs.dtag(dtype)} {name}", run, check,
                        make, n * h * w * c * elt, bnd, launches, totals,
                        (name.split(" (")[0], dtype))
    print_totals(totals, len(cs.COLD_POOL_CASES), "4 pools")


# -- SASS -----------------------------------------------------------------------

def _functions(sass):
    """{mangled name: its instructions} of a cuobjdump -sass listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4}\*/", line):
            out[name].append(line.split(";")[0].split("*/", 1)[-1].strip())
    return out


def _sass(path):
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout


def sass_main():
    library("pool2d_nhwc_pr5.cu", "pool2d_nhwc_pr5")
    libs = {"shipped": build.library_path(pl.SOURCE),
            "baseline": OUT / "pool2d_nhwc_pr5.so"}
    for tag, path in libs.items():
        for name, ins in _functions(_sass(path)).items():
            # fp32 (f), max (Lb1), 2x2/2 or runtime window, 32-bit index
            fp32_max = "IfLb1E" in name
            window = "Li2ELi2ELi2ELi2EiE" in name or tag == "baseline"
            if not (fp32_max and window):
                continue
            first = next((i for i, s in enumerate(ins)
                          if re.match(r"(@!?P\d+ )?(FSETP|FMNMX)", s)),
                         len(ins))
            loads = sum(1 for s in ins[:first] if "LDG" in s)
            total = sum(1 for s in ins if "LDG" in s)
            print(f"{tag} {name}: {loads} of its {total} LDG before the "
                  f"first compare; {len(ins)} instructions", flush=True)
    for name, ins in _functions(_sass(build.library_path(bt.SOURCE))).items():
        if "bn_stats" in name:
            print(f"shipped {name}: {sum('LDG' in s for s in ins)} LDG, "
                  f"{len(ins)} instructions", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("stats", "plans", "variants", "pool",
                                     "sass"))
    ap.add_argument("--only", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bn_pool_experiments: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    build.build_all([bt.SOURCE, pl.SOURCE])
    with torch.no_grad():
        if args.what == "variants":
            variants_main(args.only)
        else:
            {"stats": stats_main, "plans": plans_main, "pool": pool_main,
             "sass": sass_main}[args.what]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
