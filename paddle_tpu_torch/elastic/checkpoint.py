"""Sharded checkpoint save/restore with resharding (counterpart of
paddle_tpu/elastic/checkpoint.py).

Reference parity: the fleet checkpoint saver
(fluid/incubate/checkpoint/checkpoint_saver.py over the fleet fs client)
and the elastic-training story of "End-to-end Adaptive Distributed
Training on PaddlePaddle" (PAPERS.md arxiv 2112.02752): a job that loses a
worker resumes at a *different* world size without a cold restart.

A checkpoint is a directory of per-leaf per-shard ``.npy`` files plus a
digest-verified JSON manifest, byte-compatible with the JAX package's, so
either package restores the other's:

* schema version, ``step``, optional PRNG key (a list of ints),
* the source mesh (axis names/sizes + ``mesh_fingerprint``) and the
  ``ShardingPlan.fingerprint()`` the state was placed under,
* per leaf: dtype/shape, the spec it was saved under, and one entry per
  distinct shard — file ``leaf%04d.shard%03d.npy``, index
  ``[[start, stop], ...]`` per dim, and a SHA-256 digest;
* the manifest's own SHA-256 over
  ``json.dumps(body, sort_keys=True, separators=(",", ":"))``.

The port's ranks are processes, not the devices of one process:

* **Writing.** A leaf is either whole on this rank or a slice marked by
  ``parallel.sharding.place`` / ``mark_slice`` (its spec and whole
  shape).  Under a plan its spec is the plan's (a marked slice must
  already be cut by it); without one a marked slice keeps its own spec and
  a whole leaf is replicated.  Each distinct index is written once, by the
  lowest rank of the mesh that holds it (a process that is the whole mesh,
  world 1, writes every index of its whole leaves).  The ranks write into
  one ``step_%08d.tmp.<pid of rank 0>`` directory and leave their shard
  digests beside the files; after a barrier rank 0 writes the manifest,
  ``os.replace``s the directory into place, advances ``LATEST`` and runs
  the ``keep_last`` GC, and a last barrier releases the ranks.
* **Reading.** Every rank reads and verifies the manifest.  Without a plan
  each leaf is gathered whole (numpy, as the JAX package returns).  Under
  a plan each rank assembles only the box its target spec gives it from
  the shards that overlap it (digest-checked), as a tensor on the mesh's
  device marked with its spec (world 1: the whole tensor).
  ``resharded_leaves`` counts the leaves whose ``_placement_sig`` changed,
  the JAX package's rule.

Dtypes: fp32 and integer leaves round-trip bit for bit in both
directions.  A bfloat16 leaf is written as its raw 2-byte words (``.npy``
descr ``V2``, what ``np.save`` of an ``ml_dtypes`` array writes) under
manifest dtype ``"bfloat16"``; the port reads it back as a
``torch.bfloat16`` tensor, and the JAX package reads the same words it
reads from its own bfloat16 files.  ``prng_key`` takes a
``torch.Generator`` (its ``get_state()`` bytes are recorded;
``restore_generator`` puts them back) or a JAX key array (kept as data).

``ElasticCheckpoint`` (a hapi callback) writes ``param/<name>`` leaves under
the network's parameter names (the JAX package's) and ``opt/%04d`` leaves
in this fixed order: ``opt/0000`` the optimizer's step count (int64), then
for each parameter of the optimizer's bound list, in order, each of its
slots (Adam: the first and second moments).

Write hygiene mirrors the JAX package: everything lands in the tmp
directory first, the ``LATEST`` pointer advances atomically afterwards,
and a torn or hand-edited checkpoint raises ``CheckpointError`` (flight
events ``elastic_manifest_corrupt`` / ``elastic_shard_corrupt``) instead of
restoring garbage.
"""
from __future__ import annotations

import glob
import hashlib
import io
import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import mesh as _mesh
from ..parallel import sharding as _sharding
from ..utils import monitor as _monitor
from ..utils import trace as _trace

__all__ = [
    "CheckpointError", "save_checkpoint", "restore_checkpoint",
    "latest_step", "list_steps", "load_manifest", "write_state",
    "read_state", "scope_state", "restore_scope_state",
    "ElasticCheckpoint", "restore_model", "restore_generator",
    "MANIFEST_NAME",
]

MANIFEST_NAME = "manifest.json"
_LATEST = "LATEST"
_SCHEMA = 1
_DIGESTS = "shards.rank%05d.json"

# -- telemetry (the JAX package's metric names) ------------------------------
_m_ckpt_ms = _monitor.histogram(
    "elastic.checkpoint_ms",
    "Wall time of one elastic checkpoint save (ms): shard extraction, "
    "per-shard .npy writes, manifest, atomic rename, LATEST advance.")
_m_restore_ms = _monitor.histogram(
    "elastic.restore_ms",
    "Wall time of one elastic checkpoint restore (ms): digest-verified "
    "gather-by-manifest plus re-placement onto the target mesh.")
_m_resharded = _monitor.counter(
    "elastic.resharded_leaves",
    "State leaves whose physical partitioning changed across a restore "
    "(saved mesh/spec differs from the target placement) — the reshard "
    "work an elastic resume paid for.")


class CheckpointError(RuntimeError):
    """A checkpoint failed integrity verification or is structurally
    unusable: a silently-wrong restore corrupts training, so this always
    raises."""


# ---------------------------------------------------------------------------
# manifest plumbing
# ---------------------------------------------------------------------------

def _canon_body(body: Dict[str, Any]) -> bytes:
    return json.dumps(body, sort_keys=True, separators=(",", ":")).encode()


def _mesh_axes(mesh) -> Dict[str, int]:
    return {str(a): int(mesh.shape[a]) for a in mesh.axis_names}


def _spec_to_json(spec) -> List[Any]:
    """Spec entries as JSON: None | axis name | [axis names]."""
    out: List[Any] = []
    for e in tuple(spec):
        if e is None:
            out.append(None)
        elif isinstance(e, (tuple, list)):
            out.append([str(x) for x in e])
        else:
            out.append(str(e))
    return out


def _trim(spec) -> Tuple:
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(tuple(e) if isinstance(e, list) else e for e in out)


def _placement_sig(axes: Dict[str, int], spec: List[Any]) -> str:
    """Physical-partitioning signature of one leaf: its spec plus the sizes
    of only the axes the spec references (the JAX package's rule)."""
    used: List[str] = []
    for e in spec:
        if e is None:
            continue
        used.extend(e if isinstance(e, list) else [e])
    sizes = {a: int(axes.get(a, 1)) for a in used}
    return json.dumps({"spec": spec, "sizes": sizes}, sort_keys=True)


def _prng_to_json(prng_key) -> Optional[List[int]]:
    if prng_key is None:
        return None
    if isinstance(prng_key, torch.Generator):
        return [int(x) for x in prng_key.get_state().tolist()]
    if isinstance(prng_key, torch.Tensor):
        prng_key = prng_key.detach().cpu().numpy()
    arr = np.asarray(prng_key)
    return [int(x) for x in np.ravel(arr.view(np.uint32)
                                     if arr.dtype.kind not in "iu" else arr)]


def restore_generator(generator: torch.Generator, prng_key) -> None:
    """Put the state a checkpoint recorded from a ``torch.Generator``
    (``meta["prng_key"]``) back into ``generator``."""
    generator.set_state(torch.tensor(list(prng_key), dtype=torch.uint8))


# ---------------------------------------------------------------------------
# ranks and leaves
# ---------------------------------------------------------------------------

def _rank_world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    if _rank_world()[1] > 1:
        dist.barrier()


def _rank0_int(value: int) -> int:
    """Rank 0's ``value`` on every rank."""
    if _rank_world()[1] == 1:
        return int(value)
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.broadcast(t, src=0)
    return int(t.item())


def _coords(rank: int, mesh) -> Dict[str, int]:
    """Mesh coordinates of ``rank`` (ranks laid out row-major over the
    mesh's dims, as ``mesh.build_mesh`` lays them)."""
    sizes = [mesh.shape[a] for a in mesh.axis_names]
    return dict(zip(mesh.axis_names,
                    (int(c) for c in np.unravel_index(rank, sizes))))


def _mine(mesh) -> Optional[Dict[str, int]]:
    """This rank's coordinates, or None when this process is the whole
    mesh (world 1)."""
    rank, world = _rank_world()
    if world == 1:
        return None
    if mesh.size != world:
        raise CheckpointError(
            f"the mesh {mesh!r} has {mesh.size} ranks but the job {world}")
    return _coords(rank, mesh)


def _shape_of(v) -> Tuple[int, ...]:
    return tuple(int(d) for d in (v.shape if hasattr(v, "shape")
                                  else np.shape(v)))


def _host(v) -> Tuple[np.ndarray, str]:
    """(host array to ``np.save``, manifest dtype) of a tensor or array."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return (t.contiguous().view(torch.int16).numpy()
                    .view(np.dtype("V2")), "bfloat16")
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(v)
    return a, str(a.dtype)


def _distinct_indices(spec, shape, mesh) -> List[Tuple[List[List[int]], int]]:
    """(index, owning rank) per distinct shard of a leaf under ``spec``:
    the owner is the lowest rank holding the index."""
    seen: Dict[str, Tuple[List[List[int]], int]] = {}
    for r in range(mesh.size):
        idx = _sharding.spec_index(spec, shape, mesh, _coords(r, mesh))
        seen.setdefault(json.dumps(idx), (idx, r))
    return list(seen.values())


def _save_npy(path: str, arr: np.ndarray) -> str:
    """Write ``arr`` as ``.npy`` (the bytes ``np.save`` writes); its
    SHA-256, taken from the bytes in memory."""
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    data = buf.getbuffer()
    with open(path, "wb") as f:
        f.write(data)
    return hashlib.sha256(data).hexdigest()


# ---------------------------------------------------------------------------
# core writer/reader (directory-level; save_checkpoint adds step/LATEST/GC)
# ---------------------------------------------------------------------------

def _write_shards(dir_path, state, plan, mesh, optimizer_slots):
    """This rank's shard files; {leaf name: [entry, ...]} of what it wrote
    and the leaves' specs."""
    rank, world = _rank_world()
    specs: Dict[str, Any] = {}
    if plan is not None:
        specs = plan.state_shardings(state, mesh, optimizer_slots)
    # the mesh that says which rank holds which index: the plan's, else
    # the current one when a leaf is a marked slice (whole leaves are
    # then replicated: rank 0 writes them)
    where = mesh if mesh is not None else (
        _mesh.current_mesh() if any(_sharding.slice_spec(v) is not None
                                    for v in state.values()) else None)
    mine = _mine(where) if where is not None else None
    written: Dict[str, Any] = {}
    leaf_specs: Dict[str, List[Any]] = {}
    for li, (name, value) in enumerate(sorted(state.items())):
        marked = _sharding.slice_spec(value)
        shape = marked[1] if marked is not None else _shape_of(value)
        if plan is not None:
            spec = _trim(specs[name])
            if marked is not None and _trim(marked[0]) != spec:
                raise CheckpointError(
                    f"leaf {name!r} is this rank's slice by {marked[0]} but "
                    f"the plan places it by {tuple(specs[name])}")
        elif marked is not None:
            spec = _trim(marked[0])
        else:
            spec = ()
        leaf_specs[name] = _spec_to_json(spec)
        entries = []
        if spec:
            shards = _distinct_indices(spec, shape, where)
        else:
            shards = [([[0, d] for d in shape], 0)]
        for si, (idx, owner) in enumerate(shards):
            if world > 1 and owner != rank:
                continue
            if marked is not None:
                held = _sharding.spec_index(spec, shape, where, mine)
                if held != idx:
                    continue          # world 1 holds one slice of a leaf
                part = value
            else:
                part = value[tuple(slice(a, b) for a, b in idx)] \
                    if idx else value
            arr, dtype = _host(part)
            fname = f"leaf{li:04d}.shard{si:03d}.npy"
            digest = _save_npy(os.path.join(dir_path, fname), arr)
            entries.append({"si": si, "file": fname, "index": idx,
                            "sha256": digest, "dtype": dtype})
        written[name] = entries
    return written, leaf_specs


def write_state(dir_path: str, state: Dict[str, Any], *, step: int = 0,
                plan=None, mesh=None, prng_key=None,
                optimizer_slots=None) -> None:
    """Write the manifest layout (shard files + manifest.json) into
    ``dir_path``, which every rank of the job sees.  ``state`` is a flat
    {name: tensor or array} dict, each leaf whole or this rank's marked
    slice; with a ``plan`` the leaves are written as the plan places them
    (``optimizer_slots`` as ``ShardingPlan.state_shardings`` takes it).
    Called by every rank together: it ends in a barrier."""
    if not isinstance(state, dict):
        raise TypeError(f"elastic state must be a flat dict, got {type(state)}")
    rank, world = _rank_world()
    if rank == 0:
        os.makedirs(dir_path, exist_ok=True)
    if plan is not None:
        mesh = mesh or plan.resolve_mesh()
    _barrier()
    written, leaf_specs = _write_shards(dir_path, state, plan, mesh,
                                        optimizer_slots)
    if world > 1:
        with open(os.path.join(dir_path, _DIGESTS % rank), "w") as f:
            json.dump(written, f)
    _barrier()
    if rank == 0:
        if world > 1:
            merged: Dict[str, List[Any]] = {k: [] for k in written}
            for path in sorted(glob.glob(os.path.join(dir_path,
                                                      "shards.rank*.json"))):
                with open(path) as f:
                    for k, entries in json.load(f).items():
                        merged[k].extend(entries)
                os.unlink(path)
            written = merged
        leaves = []
        for name in sorted(state):
            entries = sorted(written[name], key=lambda e: e["si"])
            value = state[name]
            marked = _sharding.slice_spec(value)
            shape = marked[1] if marked is not None else _shape_of(value)
            dtype = entries[0]["dtype"] if entries else "float32"
            leaves.append({
                "name": name, "shape": list(shape), "dtype": dtype,
                "spec": leaf_specs[name],
                "shards": [{"file": e["file"], "index": e["index"],
                            "sha256": e["sha256"]} for e in entries]})
        axes: Dict[str, int] = {}
        if mesh is not None:
            axes = _mesh_axes(mesh)
            mesh_fp = _mesh.mesh_fingerprint(mesh)
        else:
            mesh_fp = "single"
        body = {
            "schema": _SCHEMA,
            "step": int(step),
            "prng_key": _prng_to_json(prng_key),
            "mesh": {"axes": axes, "fingerprint": mesh_fp},
            "plan_fingerprint": (plan.fingerprint() if plan is not None
                                 else None),
            "leaves": leaves,
        }
        payload = {"sha256": hashlib.sha256(_canon_body(body)).hexdigest(),
                   "manifest": body}
        with open(os.path.join(dir_path, MANIFEST_NAME), "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
    _barrier()


def _read_manifest_file(path: str) -> Dict[str, Any]:
    try:
        with open(path) as f:
            payload = json.load(f)
        body = payload["manifest"]
        digest = payload["sha256"]
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise CheckpointError(f"unreadable checkpoint manifest {path}: {e}") \
            from e
    if hashlib.sha256(_canon_body(body)).hexdigest() != digest:
        _trace.flight_recorder().record(
            "elastic_manifest_corrupt", name=os.path.basename(path),
            path=path)
        raise CheckpointError(f"checkpoint manifest digest mismatch: {path}")
    if body.get("schema") != _SCHEMA:
        raise CheckpointError(
            f"checkpoint schema {body.get('schema')} != {_SCHEMA}: {path}")
    return body


def _load_shard(dir_path: str, sh: Dict[str, Any]) -> np.ndarray:
    fpath = os.path.join(dir_path, sh["file"])
    try:
        with open(fpath, "rb") as f:
            raw = f.read()
    except OSError as e:
        raise CheckpointError(f"missing checkpoint shard {fpath}: {e}") from e
    if hashlib.sha256(raw).hexdigest() != sh["sha256"]:
        _trace.flight_recorder().record(
            "elastic_shard_corrupt", name=sh["file"], path=fpath)
        raise CheckpointError(f"checkpoint shard digest mismatch: {fpath}")
    part = np.load(io.BytesIO(raw), allow_pickle=False)
    if part.dtype.kind == "V" and part.dtype.itemsize == 2:
        part = part.view(np.uint16)            # bfloat16 words
    return part


def _assemble(dir_path, leaf, box) -> np.ndarray:
    """The ``box`` ([[start, stop], ...]) of one leaf from the shards that
    overlap it."""
    out = None
    for sh in leaf["shards"]:
        lo = [max(a, s) for (a, _), (s, _) in zip(box, sh["index"])]
        hi = [min(b, e) for (_, b), (_, e) in zip(box, sh["index"])]
        if any(h <= l for l, h in zip(lo, hi)):
            continue
        part = _load_shard(dir_path, sh)
        if out is None:
            out = np.empty([b - a for a, b in box], dtype=part.dtype)
        src = tuple(slice(l - s, h - s)
                    for l, h, (s, _) in zip(lo, hi, sh["index"]))
        dst = tuple(slice(l - a, h - a) for l, h, (a, _) in zip(lo, hi, box))
        out[dst] = part[src]
    if out is None:
        dt = np.uint16 if leaf.get("dtype") == "bfloat16" else np.dtype(
            leaf.get("dtype", "float32"))
        out = np.empty([b - a for a, b in box], dtype=dt)
    return out


def _to_torch(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape))
    if dtype == "bfloat16":
        t = t.view(torch.int16).view(torch.bfloat16)
    return t.to(device) if device is not None else t


def read_state(dir_path: str, *, plan=None, mesh=None, optimizer_slots=None
               ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Gather-by-manifest restore of one manifest directory.

    Returns ``(state, meta)``.  Without a ``plan`` the state is whole host
    numpy arrays (bfloat16 leaves: ``torch.bfloat16`` tensors); with one,
    each rank gets its slice under ``plan.state_shardings`` on the target
    mesh (marked, on the mesh's device) and ``elastic.resharded_leaves``
    counts the leaves whose partitioning changed."""
    body = _read_manifest_file(os.path.join(dir_path, MANIFEST_NAME))
    state: Dict[str, Any] = {}
    resharded = 0
    if plan is None:
        for leaf in body["leaves"]:
            whole = [[0, int(d)] for d in leaf["shape"]]
            arr = _assemble(dir_path, leaf, whole)
            state[leaf["name"]] = (_to_torch(arr, "bfloat16", None)
                                   if leaf.get("dtype") == "bfloat16"
                                   else arr)
    else:
        mesh = mesh or plan.resolve_mesh()
        shapes = {leaf["name"]: _sharding._Shape(leaf["shape"])
                  for leaf in body["leaves"]}
        specs = plan.state_shardings(shapes, mesh, optimizer_slots)
        mine = _mine(mesh)
        target_axes = _mesh_axes(mesh)
        saved_axes = body["mesh"]["axes"]
        for leaf in body["leaves"]:
            name, shape = leaf["name"], tuple(leaf["shape"])
            spec = _trim(specs[name])
            target_spec = _spec_to_json(spec)
            if (_placement_sig(saved_axes, leaf["spec"])
                    != _placement_sig(target_axes, target_spec)):
                resharded += 1
            if mine is None:
                box = [[0, d] for d in shape]
            else:
                box = _sharding.spec_index(spec, shape, mesh, mine)
            t = _to_torch(_assemble(dir_path, leaf, box),
                          leaf.get("dtype"), mesh.device)
            if mine is not None and spec:
                _sharding.mark_slice(t, spec, shape)
            state[name] = t
        _m_resharded.inc(resharded)
    meta = {"step": body["step"], "prng_key": body["prng_key"],
            "mesh_axes": body["mesh"]["axes"],
            "mesh_fingerprint": body["mesh"]["fingerprint"],
            "plan_fingerprint": body["plan_fingerprint"],
            "resharded_leaves": resharded}
    return state, meta


# ---------------------------------------------------------------------------
# step-directory management
# ---------------------------------------------------------------------------

def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{int(step):08d}")


def list_steps(ckpt_dir: str) -> List[int]:
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return []
    steps = []
    for n in names:
        if n.startswith("step_") and ".tmp" not in n:
            try:
                steps.append(int(n[len("step_"):]))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The step the atomically-maintained LATEST pointer names, falling
    back to a directory scan when the pointer is missing."""
    try:
        with open(os.path.join(ckpt_dir, _LATEST)) as f:
            return int(json.load(f)["step"])
    except (OSError, ValueError, KeyError):
        steps = list_steps(ckpt_dir)
        return steps[-1] if steps else None


def load_manifest(ckpt_dir: str, step: Optional[int] = None) -> Dict[str, Any]:
    """Digest-verified manifest body for one step (default: latest)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise CheckpointError(f"no checkpoints under {ckpt_dir}")
    return _read_manifest_file(
        os.path.join(_step_dir(ckpt_dir, step), MANIFEST_NAME))


def save_checkpoint(ckpt_dir: str, state: Dict[str, Any], step: int, *,
                    plan=None, mesh=None, prng_key=None,
                    keep_last: int = 2, optimizer_slots=None) -> str:
    """Atomic manifest checkpoint of ``state`` at ``step`` under
    ``ckpt_dir``, called by every rank of the job together.  Returns the
    final step directory.  A crash at any point leaves either the previous
    checkpoint set or the new one — never a half-written directory
    reachable through LATEST."""
    t0 = time.perf_counter()
    rank, _ = _rank_world()
    final = _step_dir(ckpt_dir, step)
    tmp = f"{final}.tmp.{_rank0_int(os.getpid())}"
    if rank == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    write_state(tmp, state, step=step, plan=plan, mesh=mesh,
                prng_key=prng_key, optimizer_slots=optimizer_slots)
    if rank == 0:
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        # LATEST advances only after the directory it names exists
        fd, ptmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".latest")
        with os.fdopen(fd, "w") as f:
            json.dump({"step": int(step)}, f)
        os.replace(ptmp, os.path.join(ckpt_dir, _LATEST))
        if keep_last and keep_last > 0:
            for old in list_steps(ckpt_dir)[:-keep_last]:
                shutil.rmtree(_step_dir(ckpt_dir, old), ignore_errors=True)
    _barrier()
    dur_ms = (time.perf_counter() - t0) * 1000.0
    _m_ckpt_ms.observe(dur_ms)
    _trace.flight_recorder().record(
        "elastic_checkpoint", name=f"step{int(step)}", step=int(step),
        dir=final, dur_ms=dur_ms, leaves=len(state))
    return final


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None, *,
                       plan=None, mesh=None, optimizer_slots=None
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Restore ``(state, meta)`` from ``ckpt_dir`` (default: latest step),
    resharding onto ``plan``'s mesh when one is given — the mesh shape the
    checkpoint was saved under does not have to match."""
    t0 = time.perf_counter()
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise CheckpointError(f"no checkpoints under {ckpt_dir}")
    state, meta = read_state(_step_dir(ckpt_dir, step), plan=plan, mesh=mesh,
                             optimizer_slots=optimizer_slots)
    dur_ms = (time.perf_counter() - t0) * 1000.0
    _m_restore_ms.observe(dur_ms)
    _trace.flight_recorder().record(
        "elastic_restore", name=f"step{int(step)}", step=int(step),
        dir=_step_dir(ckpt_dir, step), dur_ms=dur_ms,
        resharded_leaves=meta["resharded_leaves"])
    return state, meta


# ---------------------------------------------------------------------------
# Scope + hapi conveniences
# ---------------------------------------------------------------------------

def scope_state(program, scope) -> Dict[str, Any]:
    """Flat {name: value} of the program's persistable vars present in the
    scope — the Executor-side state an elastic checkpoint captures."""
    out = {}
    for v in program.global_block().vars.values():
        if getattr(v, "persistable", False):
            val = scope.find_var(v.name)
            if val is not None:
                out[v.name] = val
    return out


def restore_scope_state(state: Dict[str, Any], scope) -> None:
    for name, value in state.items():
        scope.set(name, value)


def _opt_slots(model) -> Tuple[Any, List[torch.Tensor]]:
    """The optimizer (parameters bound, state made) and its slot tensors
    in the documented ``opt/%04d`` order."""
    opt = model._optimizer
    if opt._parameters is None:
        opt._parameters = model.network.parameters()
    st = opt._bound_state(opt._param_list())
    slots = []
    for i in range(len(opt._param_list())):
        slots.extend(s for s in st["per_param"][str(i)]
                     if isinstance(s, torch.Tensor))
    return opt, slots


class ElasticCheckpoint:
    """hapi Callback: periodic elastic checkpointing every ``save_every``
    train steps (global across epochs).  Wired automatically by
    ``Model.fit`` when the ``elastic_save_every``/``elastic_ckpt_dir``
    flags are set (fleet's ElasticConfig sets them)."""

    def __init__(self, ckpt_dir: str, save_every: int = 100, plan=None,
                 keep_last: int = 2):
        self.model = None
        self.params: Dict[str, Any] = {}
        self.ckpt_dir = ckpt_dir
        self.save_every = int(save_every)
        self.plan = plan
        self.keep_last = int(keep_last)
        self._gstep = 0

    # the callback protocol (CallbackList dispatches by attribute)
    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        self._gstep += 1
        if self.save_every > 0 and self._gstep % self.save_every == 0:
            self._save()

    def __getattr__(self, name):
        # every other hook (eval / predict) is a no-op
        if name.startswith("on_"):
            return lambda *args, **kwargs: None
        raise AttributeError(name)

    def _flat_state(self) -> Dict[str, Any]:
        from .. import autograd

        params = autograd.parameters_dict(self.model.network)
        state: Dict[str, Any] = {f"param/{k}": v for k, v in params.items()}
        if self.model._optimizer is not None:
            opt, slots = _opt_slots(self.model)
            state["opt/0000"] = np.asarray(opt._bound_state(
                opt._param_list())["step"], np.int64)
            state.update({f"opt/{i + 1:04d}": s
                          for i, s in enumerate(slots)})
        return state

    def _save(self):
        save_checkpoint(self.ckpt_dir, self._flat_state(), self._gstep,
                        plan=self.plan, keep_last=self.keep_last)


def restore_model(model, ckpt_dir: str, step: Optional[int] = None,
                  plan=None) -> Dict[str, Any]:
    """Restore a hapi ``Model`` (network parameters + optimizer state) from
    an ``ElasticCheckpoint``-format directory; returns the checkpoint
    meta."""
    state, meta = restore_checkpoint(ckpt_dir, step, plan=plan)
    params = {k[len("param/"):]: v for k, v in state.items()
              if k.startswith("param/")}
    if params:
        model.network.set_state_dict(params)
    opt_leaves = sorted((k, v) for k, v in state.items()
                        if k.startswith("opt/"))
    if opt_leaves and model._optimizer is not None:
        opt, slots = _opt_slots(model)
        values = [v for _, v in opt_leaves]
        if len(values) != len(slots) + 1:
            raise CheckpointError(
                f"the checkpoint has {len(values) - 1} optimizer slots, the "
                f"model's optimizer {len(slots)}")
        with torch.no_grad():
            for dst, v in zip(slots, values[1:]):
                dst.copy_(torch.as_tensor(np.asarray(v)).to(dst.device))
        step_count = int(np.asarray(values[0]))
        opt._bound_state(opt._param_list())["step"] = step_count
        opt._step_count = step_count
    return meta
