"""Measurements behind the design of the paged-attention kernel (row 9;
PERF.md, section 6).  Not part of the port: the port imports nothing here.

Run from the root of a checkout on a machine with one H100:

    python3 -m paddle_tpu_torch.ops.kernels.experiments.paged_experiments splits
    python3 -m paddle_tpu_torch.ops.kernels.experiments.paged_experiments routes
    python3 -m paddle_tpu_torch.ops.kernels.experiments.paged_experiments variants
    python3 -m paddle_tpu_torch.ops.kernels.experiments.paged_experiments baseline

* ``splits`` times the shipped kernel at the shapes below with the split
  count forced (``paged_plan`` patched; the chunk on both routes), each
  output's max abs difference from the plan's beside its time.  The cost
  model ``split_cost_us`` is fitted to these.
* ``routes`` times prefill chunks (64 rows on one stride-0 table of the
  server's live width for their lengths) at nine context starts through
  both routes, the shared-table CTA group and the one-row kernel on the
  same stride-0 table, in the three cache types, beside the route the
  plan takes (the cheaper under the cost model).
* ``variants`` builds copies of ``csrc/paged_attention.cu`` (one nvcc
  each, all at once) with other tile sizes, stage counts, warps or
  unrolling, the int8 conversion by ``I2F`` instead of the byte permute,
  and knock-outs (no copies, no products, neither, no merge: wrong
  outputs on purpose), and times them at the same shapes, each beside its
  max abs difference from the plain version.  ``--only TEXT`` keeps the
  variants whose name contains TEXT (and the shipped one).
* ``baseline`` times the baseline kernel, ``paged_attention_pr3.cu`` (the
  design the shipped one replaced: one 8-warp CTA a row, synchronous
  16-byte loads), beside the shipped one: at ``chip_smoke.py``'s decode
  and chunk inputs (its ``paged_server_inputs``, same seed) and the
  256-row shape below, then over whole runs of ``chip_smoke.py``'s paged
  slice in fp32 and int8 KV under torch.profiler, each kernel's device
  time split into prefill chunks and decode steps (the baseline kernel in
  the wrapper's place for its runs).  ``baseline_library()`` builds it,
  ``baseline_paged_attention`` calls it with the wrapper's arguments.

Shapes (fp32, bf16 and int8 caches, d 128, blocks of 16): a decode step of
64 rows with own tables of 128 blocks (lengths 108..2048, 4 rows of 0), a
prefill chunk of 64 rows on one stride-0 table of 128 blocks (lengths
1141..1204), and 256 rows x 128 blocks (lengths 1..2048).  Times are device
times of 20 calls captured in one CUDA graph; the card's name and power
limit are printed first.  ``baseline`` imports ``chip_smoke`` from the root
of the checkout (the current directory).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import math
import re
import subprocess
import sys

import numpy as np
import torch

from .. import build
from .. import paged_attention as pa
from .attention_experiments import HERE, OUT, graph_ms

BASELINE_SOURCE = HERE / "paged_attention_pr3.cu"
BASELINE_KERNEL = re.compile(r"\bpaged_attn_kernel\b")   # its one kernel


@functools.lru_cache(maxsize=None)
def baseline_library() -> ctypes.CDLL:
    """The baseline kernel, built by nvcc into the experiments
    directory."""
    OUT.mkdir(parents=True, exist_ok=True)
    out = OUT / "paged_attention_baseline.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                           str(BASELINE_SOURCE)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the baseline paged kernel:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention.argtypes = ([P] * 7 + [I, I, I, I, ctypes.c_int64,
                                              ctypes.c_float, I, I, P])
    lib.paged_attention.restype = I
    return lib


def baseline_paged_attention(q, k_cache, v_cache, block_tables, context_lens,
                             sm_scale=None, kv_scales=None):
    """The baseline kernel on CUDA tensors, with the shipped wrapper's
    checks."""
    pa._check(q, k_cache, v_cache, block_tables, context_lens, kv_scales)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    num_seqs, d = q.shape
    out = torch.empty_like(q)
    quantized = k_cache.dtype == torch.int8
    err = baseline_library().paged_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(),
        kv_scales.data_ptr() if quantized else None, out.data_ptr(),
        num_seqs, d, k_cache.shape[1], block_tables.shape[1],
        block_tables.stride(0), float(sm_scale), pa._Q_CODES[q.dtype],
        pa._KV_CODES[k_cache.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"the baseline paged kernel failed: CUDA error "
                           f"{err}")
    return out


# -- shapes -------------------------------------------------------------------

def inputs(gen, rng, rows, width, lens, shared=False, bs=16, d=128):
    """fp32 q and caches over a pool of rows * width blocks (one table of
    width blocks when ``shared``), int8 blocks and scales, tables a
    random permutation."""
    nt = width if shared else rows * width
    nb = nt + 1
    t = dict(q=torch.randn((rows, d), generator=gen),
             k=torch.randn((nb, bs, d), generator=gen),
             v=torch.randn((nb, bs, d), generator=gen),
             k8=torch.randint(-127, 128, (nb, bs, d), generator=gen,
                              dtype=torch.int8),
             v8=torch.randint(-127, 128, (nb, bs, d), generator=gen,
                              dtype=torch.int8),
             scales=torch.rand((nb, 2), generator=gen) * 0.09 + 0.01)
    tables = torch.from_numpy(rng.permutation(nb - 1)[:nt] + 1).int()
    t["tables"] = tables.reshape(1 if shared else rows, width)
    t["lens"] = torch.from_numpy(np.asarray(lens, np.int32))
    t = {k: v.cuda() for k, v in t.items()}
    if shared:   # expanded on the card: a copy would not keep row stride 0
        t["tables"] = t["tables"].expand(rows, width)
    return t


def shapes(seed=0):
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    dec = rng.integers(108, 2049, 64)
    dec[:4] = 0
    return {"decode 64 x 128": inputs(gen, rng, 64, 128, dec),
            "chunk 64 on one table of 128": inputs(
                gen, rng, 64, 128, np.arange(1141, 1205), shared=True),
            "256 x 128": inputs(gen, rng, 256, 128,
                                rng.integers(1, 2049, 256))}


def operands(t, dtype):
    if dtype == torch.int8:
        return (t["q"], t["k8"], t["v8"], t["tables"], t["lens"]), {
            "kv_scales": t["scales"]}
    if dtype == torch.bfloat16:
        return tuple(x.to(dtype) for x in (t["q"], t["k"], t["v"])) + (
            t["tables"], t["lens"]), {}
    return (t["q"], t["k"], t["v"], t["tables"], t["lens"]), {}


def err(got, ref):
    return float((got.float() - ref.float()).abs().max())


# -- splits -------------------------------------------------------------------

def _forced(splits):
    plan_fn = pa.paged_plan

    def plan(*a, **k):
        p = plan_fn(*a, **k)
        s = max(1, min(splits, p.tiles))
        tps = -(-p.tiles // s)
        return p._replace(splits=-(-p.tiles // tps), tiles_per_split=tps)
    return plan


@contextlib.contextmanager
def route(shared_tile):
    """Rows sharing one table through the shared-table CTA group (True) or
    the one-row kernel (False), whatever the cost model says."""
    saved = pa.paged_plan

    def plan(num_seqs, max_blocks, block_size, d, kv_elt, shared,
             sms=pa.H100_SMS):
        return pa.route_plan(num_seqs, max_blocks, block_size, d, kv_elt,
                             shared and shared_tile, sms)[1]
    pa.paged_plan = plan
    try:
        yield
    finally:
        pa.paged_plan = saved


def timed(run, plan):
    saved = pa.paged_plan
    pa.paged_plan = plan
    try:
        return run(), graph_ms(run, reps=20)
    finally:
        pa.paged_plan = saved


SPLITS = {"decode 64 x 128": (1, 2, 3, 4, 6, 8, 12, 16, 24, 32),
          "chunk 64 on one table of 128": (1, 4, 8, 16, 32, 64, 128, 256),
          "256 x 128": (1, 2, 3, 4, 8)}


def _plan(args):
    return pa.paged_plan(args[0].shape[0], args[3].shape[1],
                         args[1].shape[1], args[0].shape[1],
                         args[1].element_size(), args[3].stride(0) == 0)


def splits_main():
    for label, t in shapes().items():
        shared = t["tables"].stride(0) == 0
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            for tile in ((True, False) if shared else (None,)):
                with (route(tile) if shared else contextlib.nullcontext()):
                    args, kw = operands(t, dtype)
                    run = lambda: pa.paged_attention(*args, **kw)
                    ref = run()
                    plan = _plan(args)
                    parts = []
                    for s in SPLITS[label]:
                        got, ms = timed(run, _forced(s))
                        parts.append(f"{s} {ms:.4f} ({err(got, ref):.1e})")
                name = ("" if tile is None else " shared-table route" if tile
                        else " one-row route")
                print(f"{label} {str(dtype)[6:]}{name} (plan {plan.splits} "
                      f"splits): " + ", ".join(parts), flush=True)
    print("(splits ms (max abs difference from the plan's output))",
          flush=True)


# -- routes -------------------------------------------------------------------

CHUNK_STARTS = (0, 64, 192, 448, 704, 960, 1140, 1472, 1984)


def live_width(blocks, most=128):
    """The paged server's table width for a row of ``blocks`` blocks: the
    next power of two (``PagedDecoder._live_width``)."""
    w = 1
    while w < blocks:
        w *= 2
    return min(w, most)


def routes_main(seed=0):
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    for start in CHUNK_STARTS:
        width = live_width(-(-(start + 64) // 16))
        t = inputs(gen, rng, 64, width, np.arange(start + 1, start + 65),
                   shared=True)
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            args, kw = operands(t, dtype)
            ref = pa.paged_attention_plain(*args, **kw)
            tile = _plan(args).shared_tile
            parts = [f"plan: {'shared-table' if tile else 'one-row'}"]
            for tile in (True, False):
                with route(tile):
                    run = lambda: pa.paged_attention(*args, **kw)
                    e = err(run(), ref)
                    parts.append(f"{'shared-table' if tile else 'one-row'} "
                                 f"({_plan(args).splits} splits) "
                                 f"{graph_ms(run, reps=20):.4f} ({e:.1e})")
            print(f"chunk 64 on one table of {width}, lengths {start + 1}.."
                  f"{start + 64}, {str(dtype)[6:]}: " + ", ".join(parts),
                  flush=True)
    print("(route (its plan's splits) ms (max abs difference from the "
          "plain version))", flush=True)


# -- variants -----------------------------------------------------------------

SRC = "paged_attention.cu"
I2F = ("f[4 * i + b] =\n          __uint_as_float(__byte_perm(x, 0x4B000000u,"
       " 0x7650u | b)) -\n          8388736.f;")
I2F_NEW = "f[4 * i + b] = (float)(int8_t)(w[i] >> (8 * b));"


def _const(name, old, new):
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


EXPECT = ("    hopper::mbar_expect_tx(fk, bytes);\n"
          "    hopper::mbar_expect_tx(fv, bytes);")
COPIES = ("    hopper::bulk_load(kdst + dst, p.k + off, (uint32_t)n * p.row_bytes,"
          " fk);\n    hopper::bulk_load(vdst + dst, p.v + off, (uint32_t)n * "
          "p.row_bytes, fv);")
ROW_LOOP = "for (int t0 = 0; t0 < nt; t0 += TPW * U) {"
SHARED_LOOP = "for (int t0 = 0; t0 < nt; t0 += kSub) {"
MERGE_LAUNCH = "  if (p.splits > 1) {"

# name: ([(anchor, replacement)], {wrapper constant: value}); the
# knock-outs compute wrong outputs on purpose and show where the time goes
VARIANTS = {
    "shipped (4 KB tiles, 4 warps x 3 stages a row, 4 shared stages)":
        ([], {}),
    "8 KB tiles": ([_const("kSlotBytes", 4096, 8192)], {"SLOT_BYTES": 8192}),
    "2 KB tiles": ([_const("kSlotBytes", 4096, 2048)], {"SLOT_BYTES": 2048}),
    "2 stages a row warp": ([_const("kRowStages", 3, 2)], {}),
    "4 stages a row warp": ([_const("kRowStages", 3, 4)], {}),
    "8 warps a row, 1 stage": ([_const("kRowWarps", 4, 8),
                                _const("kRowStages", 3, 1)],
                               {"ROW_WARPS": 8}),
    "2 tokens a lane group at once for int8 too": (
        [("sizeof(TKV) == 1 ? 2 : 1);", "1);")], {}),
    "8 tokens a shared-table lane at once": ([_const("kSub", 4, 8)], {}),
    "2 shared stages": ([_const("kSharedStages", 4, 2)], {}),
    "8 shared stages": ([_const("kSharedStages", 4, 8)], {}),
    "int8 by I2F": ([(I2F, I2F_NEW)], {}),
    "knock-out: no K/V copies": (
        [(EXPECT, "    hopper::mbar_arrive(fk);\n    hopper::mbar_arrive(fv);"),
         (COPIES, "")], {}),
    "knock-out: no scores or P.V": (
        [(ROW_LOOP, ROW_LOOP.replace("t0 < nt", "t0 < 0")),
         (SHARED_LOOP, SHARED_LOOP.replace("t0 < nt", "t0 < 0"))], {}),
    "knock-out: neither copies nor scores nor P.V": (
        [(EXPECT, "    hopper::mbar_arrive(fk);\n    hopper::mbar_arrive(fv);"),
         (COPIES, ""), (ROW_LOOP, ROW_LOOP.replace("t0 < nt", "t0 < 0")),
         (SHARED_LOOP, SHARED_LOOP.replace("t0 < nt", "t0 < 0"))], {}),
    "knock-out: no merge of the splits": (
        [(MERGE_LAUNCH, "  if (false) {")], {}),
}


def _variant_src(i, subs):
    vdir = OUT / f"paged-{i}"
    vdir.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / SRC).read_text()
    for sub in subs:
        old, new = sub[:2]
        count = sub[2] if len(sub) > 2 else 1
        if text.count(old) != count:
            raise RuntimeError(f"anchor not found {count} times: {old!r}")
        text = text.replace(old, new)
    (vdir / SRC).write_text(text)
    return vdir


def variants_main(only=None):
    chosen = [(i, name, v) for i, (name, v) in enumerate(VARIANTS.items())
              if not only or i == 0 or only in name]
    procs = {}
    for i, name, (subs, _) in chosen:   # one nvcc each, all at once
        vdir = _variant_src(i, subs)
        procs[i] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
             str(vdir / "paged_attention.so"), str(vdir / SRC)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), vdir)
    libs = {}
    for i, (proc, vdir) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {i}:\n{log}")
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and " 0 bytes spill" not in ln]
        libs[i] = (ctypes.CDLL(str(vdir / "paged_attention.so")), spills)
    cases = shapes()
    for i, name, (_, consts) in chosen:
        lib, spills = libs[i]
        saved_lib = build._libs.get(pa.SOURCE)
        saved = {k: getattr(pa, k) for k in consts}
        build._libs[pa.SOURCE] = lib
        for k, v in consts.items():
            setattr(pa, k, v)
        pa.paged_plan.cache_clear()
        times = []
        try:
            for label, t in cases.items():
                for dtype in (torch.float32, torch.bfloat16, torch.int8):
                    args, kw = operands(t, dtype)
                    run = lambda: pa.paged_attention(*args, **kw)
                    e = err(run(), pa.paged_attention_plain(*args, **kw))
                    times.append(f"{label} {str(dtype)[6:]} "
                                 f"{graph_ms(run, reps=20):.4f} ({e:.1e})")
        finally:
            build._libs[pa.SOURCE] = saved_lib
            for k, v in saved.items():
                setattr(pa, k, v)
            pa.paged_plan.cache_clear()
        print(f"{name}{' (' + spills[0] + ')' if spills else ''}: "
              + ", ".join(times), flush=True)


# -- the baseline kernel ------------------------------------------------------

def baseline_main(seed=0):
    import chip_smoke as cs   # runs the paged slice; at the checkout's root
    from paddle_tpu_torch.serving import make_paged_toy_lm

    dec, chunk = cs.paged_server_inputs(seed)
    cases = {"decode step (chip_smoke.py's)": dec,
             "prefill chunk (chip_smoke.py's)": chunk,
             "256 x 128": shapes()["256 x 128"]}
    for label, t in cases.items():
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            args, kw = operands(t, dtype)
            new = lambda: pa.paged_attention(*args, **kw)
            old = lambda: baseline_paged_attention(*args, **kw)
            e = err(old(), new())
            a, b = graph_ms(new, reps=20), graph_ms(old, reps=20)
            print(f"{label} {str(dtype)[6:]}: shipped {a:.4f} ms, baseline "
                  f"{b:.4f} ms ({a / b:.3f}x; max abs difference {e:.1e})",
                  flush=True)
    cfg = cs.PAGED_SERVE
    model = make_paged_toy_lm(vocab=cfg["vocab"], hidden=cfg["hidden"],
                              max_positions=cfg["max_positions"], seed=seed,
                              device=cs.DEV)
    prompts, _ = cs.serve_traffic(np.random.default_rng(seed), cfg)
    cs.serve_once(model, [prompts[0][:40], prompts[1][:300]], cfg)
    shipped = pa.paged_attention
    for kv in ("float32", "int8"):
        ref = cs.serve_once(model, prompts, cfg, kv_dtype=kv)["tokens"]
        runs = {"shipped": cs.slice_device_time(
            model, prompts, cfg, kv, ref, f"slice run, {kv} KV, shipped")}
        pa.paged_attention = baseline_paged_attention
        try:
            base = cs.serve_once(model, prompts, cfg, kv_dtype=kv)["tokens"]
            runs["baseline"] = cs.slice_device_time(
                model, prompts, cfg, kv, base,
                f"slice run, {kv} KV, baseline", BASELINE_KERNEL)
        finally:
            pa.paged_attention = shipped
        same = sum(a == b for a, b in zip(ref, base))
        a, b = runs["shipped"]["row9_ms"], runs["baseline"]["row9_ms"]
        print(f"slice run, {kv} KV: row 9 shipped {a:.3f} ms, baseline "
              f"{b:.3f} ms ({a / b:.3f}x); the two kernels' tokens equal on "
              f"{same} of {len(prompts)} requests", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("splits", "routes", "variants",
                                     "baseline"))
    ap.add_argument("--only", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("paged_experiments: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    build.build_all([pa.SOURCE])
    with torch.no_grad():
        if args.what == "splits":
            splits_main()
        elif args.what == "routes":
            routes_main()
        elif args.what == "baseline":
            baseline_main()
        else:
            variants_main(args.only)
    return 0


if __name__ == "__main__":
    sys.exit(main())
