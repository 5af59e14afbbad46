"""Typed global flags (counterpart of paddle_tpu/core/flags.py).

The JAX package's whole flag table, with its names, defaults, types and
env passthrough (``PDTPU_FLAGS_<name>``; bool strings parse as ``_coerce``
spells them).  A kernel flag that is on selects the kernel on CUDA
tensors; off selects the plain PyTorch composition on every device.  The
help texts of the flags the port reads describe the port; the others keep
the JAX package's text, which names the module that reads the flag there
and has no counterpart in the port yet (ROADMAP.md Queue 1): the port
defines them so that ``get_flags`` / ``set_flags`` and the env passthrough
take the same names in both packages.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict

_lock = threading.Lock()
_FLAGS: Dict[str, Any] = {}
_DEFS: Dict[str, tuple] = {}  # name -> (default, type, help)

_ENV_PREFIX = "PDTPU_FLAGS_"
_TRUE_STRINGS = frozenset(("1", "true", "yes", "on"))
_FALSE_STRINGS = frozenset(("0", "false", "no", "off", ""))


def _coerce(name: str, value, type_: Callable):
    if type_ is bool and isinstance(value, str):
        low = value.lower()
        if low in _TRUE_STRINGS:
            return True
        if low in _FALSE_STRINGS:
            return False
        raise ValueError(
            f"flag {name!r}: cannot parse {value!r} as bool (use one of "
            f"{sorted(_TRUE_STRINGS | _FALSE_STRINGS)})")
    return type_(value)


def define_flag(name: str, default, help: str = "", type_: Callable = None):
    type_ = type_ or type(default)
    _DEFS[name] = (default, type_, help)
    env = os.environ.get(_ENV_PREFIX + name)
    _FLAGS[name] = default if env is None else _coerce(name, env, type_)


def get_flag(name: str):
    try:
        return _FLAGS[name]
    except KeyError:
        raise KeyError(f"Unknown flag {name!r}; known: {sorted(_FLAGS)}") from None


def set_flags(flags: Dict[str, Any]):
    with _lock:
        for name, value in flags.items():
            if name not in _FLAGS:
                raise KeyError(f"Unknown flag {name!r}; known: {sorted(_FLAGS)}")
            _, type_, _ = _DEFS[name]
            if value is not None and not isinstance(value, type_):
                value = _coerce(name, value, type_)
            _FLAGS[name] = value


def get_flags(names=None) -> Dict[str, Any]:
    """{name: value} of ``names`` (one name or a list), else of every
    flag."""
    if names is None:
        return dict(_FLAGS)
    if isinstance(names, str):
        names = [names]
    return {n: get_flag(n) for n in names}


define_flag("default_dtype", "float32", "Default floating dtype for new tensors.")
define_flag("check_nan_inf", False, "Post-check every op output for NaN/Inf "
            "(ref: platform/flags.cc:44 FLAGS_check_nan_inf).")
define_flag("use_flash_attention", True, "Use the flash-attention CUDA "
            "kernels on CUDA tensors where the attention semantics allow "
            "it: packed (ops/kernels/flash_attention_packed.py) and "
            "(batch, heads, seq, head_dim) (ops/kernels/flash_attention.py).")
define_flag("use_fused_layer_norm", True, "Use the LayerNorm and the "
            "residual+dropout+LayerNorm CUDA kernels (ops/kernels/"
            "layer_norm.py) on CUDA tensors: one pass over device memory "
            "per call.")
define_flag("matmul_precision", "default", "jax.lax precision for matmuls: "
            "default|high|highest.")
define_flag("use_pallas_conv_fused", True, "Use the fused conv + BN + "
            "activation CUDA kernel (ops/kernels/conv_fused.py) for the "
            "inference fused_conv2d_bn_act op where the JAX package's shape "
            "gate holds: the BN transform a * x + b and the activation as "
            "an epilogue on the conv's output tiles.  Off or refused by the "
            "gate: the weight-space fold and one cuDNN convolution.  In "
            "training mode the flag selects the batch-statistics and scale "
            "+ act kernels (ops/kernels/bn_act_train.py) after the library "
            "conv.  The JAX package's name is kept.")
define_flag("use_pallas_pool", True, "Use the NHWC max / average pooling "
            "CUDA kernel (ops/kernels/pooling.py) where the JAX package's "
            "shape gate holds.  Off or refused by the gate: PyTorch's "
            "pooling.  The JAX package's name is kept.")
define_flag("use_pallas_int8", True, "Run the quant_conv2d / quant_mul "
            "ops (static/ops_fused.py) on the int8 CUDA kernels (ops/"
            "kernels/int8.py) where the JAX package's shape gate holds: "
            "int8 operands, int32 sums, an fp32 per-channel dequant "
            "epilogue.  Off or refused by the gate: the simulate route "
            "(fixed-scale fake quant + the float op), bit for bit the "
            "program before the quant_infer rewrite.  The JAX package's "
            "name is kept.")
define_flag("use_paged_attention", True, "Use the paged-attention decode "
            "CUDA kernel (ops/kernels/paged_attention.py) in the paged "
            "decoder: one-token attention gathered block by block through "
            "a per-sequence block table, online softmax, in-kernel int8 KV "
            "dequant.  Off: the plain gather + masked softmax on every "
            "device.")
define_flag("profiler_dir", "", "Directory for device traces when the "
            "profiler is enabled (utils/profiler.py start_device_trace: "
            "torch.profiler on the card; ref: platform/profiler.h:208).")
define_flag("eager_log_level", 0, "VLOG-style verbosity for framework logging "
            "(ref: glog VLOG levels).")
define_flag("metrics", True, "Collect runtime telemetry into the metrics "
            "registry (utils/monitor.py).  Off (PDTPU_FLAGS_metrics=0): "
            "instrumented paths still run but record nothing.")
define_flag("flight_recorder_size", 512, "Ring-buffer capacity of the "
            "in-memory flight recorder (utils/trace.py): the last N "
            "structured events (spans, RPCs, executor runs, heartbeats, NaN "
            "hits, exceptions) dumped to JSON post-mortem when a worker "
            "dies (no reference analogue — a crashed trainer there leaves "
            "only an exit code).")
define_flag("donate_state", True, "Donate the persistable-state pytree into "
            "the Executor's compiled step (jax.jit donate_argnums) so XLA "
            "updates parameters and optimizer slots in place and the scope "
            "write-back is a pointer swap instead of a copy.  Only values "
            "local to the run scope are donated (fall-through reads from a "
            "parent scope keep the reference's never-clobber-the-parent "
            "semantics).  Donation engages on TPU/GPU; XLA:CPU runs donated "
            "computations synchronously, so on CPU the flag keeps the "
            "device-resident async fast path but skips donate_argnums.  Off "
            "(PDTPU_FLAGS_donate_state=0): every step round-trips a fresh "
            "copy of the state, bit-for-bit today's behavior (ref: no "
            "analogue — the reference mutates Scope in place per op).")
define_flag("compile_cache_dir", "", "Directory for the persistent AOT "
            "executable cache (static/compile_cache.py).  Empty (default): "
            "disabled.  When set, the Executor serializes each compiled "
            "step via jax.export and reloads it on later runs — including "
            "in a different process — keyed by program fingerprint × mesh "
            "shape × sharding spec × jax/jaxlib/backend version, so a "
            "multi-worker fleet or a serving replica cold-starts without "
            "re-tracing or re-lowering.  Corrupted or mismatched entries "
            "fall back to a normal compile.  Cross-process reuse needs a "
            "stable PRNG seed: set program.random_seed (the derived "
            "per-process seed is part of the key).  (ref: no analogue — "
            "the reference recompiles its ProgramDesc per process; jax's "
            "own compilation cache inspired the key discipline.)")
define_flag("xprof_scopes", True, "Wrap every lowered op in a jax.named_scope "
            "(\"<op_type>.b<block>.i<idx>\") during Executor tracing, and "
            "every dygraph Layer.forward in its attribute-path scope, so op "
            "identity survives into optimized-HLO instruction metadata and "
            "utils/xprof.py can attribute per-instruction flops/bytes back "
            "to source ops.  Scopes are HLO metadata only: they change "
            "neither compiled code, compile-cache keys (program-content "
            "keyed), nor retrace behavior — pinned by tests.  Off "
            "(PDTPU_FLAGS_xprof_scopes=0): xprof reports still build but "
            "regions degrade to <unattributed> (ref: platform/"
            "device_tracer.h correlates kernels to ops via CUPTI; on TPU "
            "the HLO metadata layer is the correlation channel).")
define_flag("check_program", True, "Statically verify Programs before the "
            "Executor traces them (static/analysis.py): dataflow, registry, "
            "structure, and shape/dtype plausibility checks with typed "
            "diagnostics (ref: the framework/ir + inference/analysis "
            "pre-execution pass stage).")
define_flag("opt_passes", "", "Graph-rewrite pass pipeline applied to "
            "Programs on the Executor's first run of a (program, feeds, "
            "fetches) key (static/passes.py).  Empty (default): off.  "
            "'1'/'default': the default pipeline (constant_folding, cse, "
            "conv+BN+act and matmul+bias+act fusion, NHWC layout "
            "propagation, dce).  A comma list runs exactly those passes.  "
            "A pipeline that fails its check rolls back to the original "
            "program and counts passes.rollbacks.")
define_flag("elastic_save_every", 0, "Periodic elastic checkpointing in "
            "hapi Model.fit: every N global train steps the params + "
            "optimizer state are written as a resharding-capable manifest "
            "checkpoint (elastic/checkpoint.py) under elastic_ckpt_dir.  "
            "0 (default): off.  Set by fleet.DistributedStrategy's "
            "ElasticConfig, or directly (ref: the fleet elastic "
            "checkpoint cadence).")
define_flag("elastic_ckpt_dir", "", "Directory for the periodic elastic "
            "checkpoints Model.fit writes when elastic_save_every > 0; a "
            "restarted or resharded job resumes via "
            "elastic.restore_model / elastic.restore_checkpoint.")
define_flag("elastic_keep_last", 2, "How many elastic step checkpoints to "
            "retain under elastic_ckpt_dir (older step directories are "
            "garbage-collected after each save).")
define_flag("telemetry_port", 0, "Serve the live telemetry plane over HTTP "
            "on this port (utils/telemetry.py): /metrics (Prometheus text "
            "from the utils/monitor.py registry), /healthz (elastic "
            "membership + heartbeat age), /flight (flight-recorder ring), "
            "/xprof (last roofline report snapshot), /spans (recent trace "
            "spans).  0 (default): off.  `launch --telemetry_port BASE` "
            "exports PDTPU_TELEMETRY_PORT=BASE+rank per worker so every "
            "rank serves its own plane; the server thread is a daemon and "
            "never blocks process exit (ref: the reference's always-on "
            "platform/monitor.h StatValue registry, made scrapeable).")
define_flag("watchdog", False, "Attach the training goodput watchdog "
            "(utils/watchdog.py) to hapi Model.fit: rolling-median/MAD "
            "step-time anomaly detection, train.goodput_pct accounting "
            "(productive step time vs compile/restore/eviction/idle from "
            "executor/elastic flight events), cross-rank straggler "
            "attribution over the elastic heartbeat dir, and a "
            "loss-spike/NaN monitor.  Anomalies are flight-recorded and "
            "counted (watchdog.anomalies{kind}); detection never raises "
            "into the train loop.")
define_flag("watchdog_checkpoint_on_anomaly", False, "Let the watchdog "
            "write a pre-emptive elastic checkpoint (elastic/checkpoint.py "
            "save_checkpoint under elastic_ckpt_dir) when it sees a NaN/Inf "
            "or spiking loss — the last-known-good state is on disk before "
            "the job wastes hours diverging.  Needs elastic_ckpt_dir set "
            "and a checkpoint state provider (Model.fit wires one "
            "automatically when the watchdog flag is on).")
define_flag("check_sharding", True, "Statically verify Program x "
            "ShardingPlan pairings before the Executor traces them "
            "(static/shardcheck.py, SC001-SC009): feed batch divisibility, "
            "mesh-axis validity, state-placement conflicts, donation "
            "aliasing, comm_quantize applicability, sub-block aval "
            "consistency, and ZeRO/annotation conflicts, plus a static "
            "communication estimate.  Memoized by plan token x program "
            "version x feed shapes, so it runs only on compile-cache "
            "misses — steady-state steps never re-check (ref: the "
            "compile-time InferShape/InferVarType pass stage, extended "
            "with GSPMD layout knowledge).")
define_flag("check_memory", True, "Statically price a Program's peak HBM "
            "before the Executor traces it (static/memcheck.py, "
            "MC001-MC007): size every var from the shape/dtype engine, "
            "sweep buffer lifetimes in op order, divide by the "
            "ShardingPlan placement, and reject predicted-OOM programs "
            "(MC001) before any trace/compile.  Advisory findings "
            "(donation, ZeRO, embedding-shard opportunities) are "
            "flight-recorded, never raised.  Memoized like "
            "check_sharding, so steady-state steps never re-check.")
define_flag("memcheck_capacity_gb", 0.0, "Override the per-device HBM "
            "capacity (in GiB) memcheck verifies peak estimates against.  "
            "0 = auto-detect from the device kind via "
            "xprof.resolve_peaks (CPU backends have no table entry, so "
            "MC001 only fires there under an explicit override — set "
            "this in tests/CI to exercise the OOM gate).")
define_flag("ledger", True, "Calibration ledger (utils/ledger.py): on every "
            "Executor compile event and every closed steady-state step "
            "window, append a record joining the static cost models' "
            "predictions (shardcheck comm bytes, memcheck peak HBM, xprof "
            "roofline ms) with what the run actually measured "
            "(executor.step_time_ms, comm.allreduce_bytes, "
            "Executor.memory_stats), and export per-model drift gauges "
            "(ledger.drift_ratio{model=comm|mem|roofline}).  Drift outside "
            "a model's calibration band is flight-recorded as a "
            "ledger_drift anomaly the watchdog counts.  Records are kept "
            "in a bounded in-memory ring served at /ledger?since=; set "
            "ledger_dir (or PDTPU_LEDGER_DIR) to also append them as "
            "JSONL.  Pure observation: estimates reuse the memoized "
            "compile-path analyses, never trace, and never raise into "
            "Executor.run — warm persistent-cache starts and zero "
            "steady-state retraces are preserved.  Inert while the "
            "metrics flag is off.")
define_flag("ledger_window", 32, "Steady-state window size for the "
            "calibration ledger: every N measured executor.step_time_ms "
            "observations of one compiled entry close a window record "
            "joining the window's median step time against the entry's "
            "roofline-modeled ms (and re-stating the compile-time "
            "comm/mem drift for continuity in the JSONL stream).")
define_flag("ledger_dir", "", "Directory for per-rank calibration-ledger "
            "JSONL sinks (ledger.rank<N>.jsonl, one O_APPEND write per "
            "record so concurrent ranks on a shared filesystem never "
            "interleave mid-line).  Empty (default): in-memory ring only.  "
            "`launch --ledger_dir DIR` exports PDTPU_LEDGER_DIR per "
            "worker, the same pattern as the telemetry/elastic dirs.")
define_flag("slo", True, "SLO engine (utils/slo.py): a background sampler "
            "snapshots registry metrics into the history ring every "
            "slo_sample_secs and evaluates declarative SLO objectives with "
            "multi-window burn-rate alerting (Google-SRE fast/slow window "
            "pairs).  Firing page-severity alerts flip /healthz to 503; all "
            "alerts are served at /alerts and the retained samples at "
            "/history.  Observation-only: reads metrics, never touches the "
            "compile or dispatch path.  The engine only starts when the "
            "telemetry plane starts (telemetry_port / PDTPU_TELEMETRY_PORT) "
            "or via paddle_tpu.utils.slo.start().")
define_flag("slo_sample_secs", 5.0, "Self-sample interval (seconds) of the "
            "SLO engine's metrics-history sampler, and its alert-evaluation "
            "cadence.  Each tick snapshots counters as rates, gauges as "
            "values and histograms as inter-tick p50/p99 into bounded "
            "per-series rings (utils/monitor.py MetricsHistory).")
define_flag("slo_objectives", "", "Path to a TOML or JSON SLO-objective "
            "file loaded when the SLO engine starts (see utils/slo.py "
            "load_objectives; `python -m tools.slocheck FILE` validates one "
            "against the metric inventory).  Empty (default): the built-in "
            "default objectives (serve.ttft_p99_ms, serve.load_shed rate, "
            "train.goodput_pct, ledger.drift_ratio).")
define_flag("history_dir", "", "Directory for per-rank metrics-history "
            "JSONL mirrors (history.rank<N>.jsonl): each SLO-engine sample "
            "tick appends one line with the tick's {series: value} snapshot "
            "via a single O_APPEND write.  Empty (default): in-memory ring "
            "only.  `launch --history_dir DIR` exports PDTPU_HISTORY_DIR "
            "per worker, the same pattern as the ledger dir.")
