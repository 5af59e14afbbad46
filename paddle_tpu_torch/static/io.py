"""Static-graph model persistence (counterpart of paddle_tpu/static/io.py).

Reference parity: python/paddle/fluid/io.py — save/load_persistables
(:598/:692) and save/load_inference_model (:1164/:1374), which serialize a
pruned ProgramDesc + parameter files.

Native format: a directory with `program.json` (the symbolic program:
vars + ops + attrs — human-readable, replaces the protobuf ProgramDesc) and
`params.npz` (every persistable's value).  load_inference_model rebuilds the
Program and returns (program, feed_names, fetch_names) exactly like the
reference API.

The reference's own format, a binary ``__model__`` ProgramDesc beside
per-variable LoDTensor files, is read and written through
``proto_format.py``: ``save_inference_model`` writes it when given a
``model_filename``, and ``load_inference_model`` reads it when given one,
or when the directory holds a ``__model__`` and no ``program.json``.

The native format is the JAX package's, so a model saved by either package
loads in the other: the same ``program.json`` and the same ``params.npz``
arrays (bfloat16 values are written as the two raw bytes of each element,
a ``V2`` array, which is how numpy stores the JAX package's bfloat16; on
load such an array becomes a bfloat16 tensor again).
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

import torch

from ..core import dtype as _dtype_mod
from .executor import Executor, Scope, global_scope
from .framework import Parameter, Program, Variable

__all__ = ["save_persistables", "load_persistables", "save_inference_model",
           "load_inference_model", "save", "load"]


def _to_saved(val) -> np.ndarray:
    """A scope value as the array the native format stores: its own dtype,
    bfloat16 as raw two-byte ``V2`` elements."""
    if isinstance(val, torch.Tensor):
        t = val.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(val)


def _from_saved(arr: np.ndarray):
    """A stored array as a scope value (``V2`` back to bfloat16)."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return arr


def _persistable_values(program: Program, scope: Scope):
    out = {}
    for v in program.list_vars():
        if v.persistable:
            val = scope.find_var(v.name)
            if val is not None:
                out[v.name] = _to_saved(val)
    return out


def save_persistables(executor: Executor, dirname: str,
                      main_program: Optional[Program] = None,
                      scope: Optional[Scope] = None):
    """ref fluid/io.py:598 — all persistables (params + optimizer state)."""
    from .framework import default_main_program
    program = main_program or default_main_program()
    scope = scope or global_scope()
    os.makedirs(dirname, exist_ok=True)
    np.savez(os.path.join(dirname, "params.npz"),
             **_persistable_values(program, scope))


def load_persistables(executor: Executor, dirname: str,
                      main_program: Optional[Program] = None,
                      scope: Optional[Scope] = None):
    from .framework import default_main_program
    program = main_program or default_main_program()
    scope = scope or global_scope()
    data = np.load(os.path.join(dirname, "params.npz"))
    for v in program.list_vars():
        if v.persistable and v.name in data:
            scope.set(v.name, _from_saved(data[v.name]))


def _block_json(blk) -> dict:
    return {
        "vars": [
            {"name": v.name, "shape": list(v.shape),
             "dtype": _dtype_mod.dtype_name(v.dtype),
             "persistable": v.persistable,
             "is_data": v.is_data, "parameter": isinstance(v, Parameter),
             "trainable": getattr(v, "trainable", False)}
            for v in blk.vars.values()],
        "ops": [
            {"type": op.type, "inputs": op.inputs, "outputs": op.outputs,
             "attrs": _jsonable(op.attrs)}
            for op in blk.ops],
    }


def _program_to_json(program: Program) -> dict:
    """Block 0 as the JAX package writes it; a program with control flow
    also writes its sub-blocks, in order, under ``sub_blocks`` (the JAX
    package writes block 0 only, so its control-flow programs do not
    survive a save)."""
    from . import op_version as _opv

    used = {op.type for blk in program.blocks for op in blk.ops}
    out = {
        # ref op_version_registry.h: stamp versions of the op types this
        # PROGRAM uses (stamping the whole registry would make packages
        # reject on version bumps in ops they never touch)
        "op_versions": {t: v for t, v in _opv.op_version_map().items()
                        if t in used},
        **_block_json(program.global_block()),
    }
    if len(program.blocks) > 1:
        out["sub_blocks"] = [dict(parent=blk.parent_idx, **_block_json(blk))
                             for blk in program.blocks[1:]]
    return out


def _jsonable(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (np.integer,)):
            v = int(v)
        elif isinstance(v, (np.floating,)):
            v = float(v)
        elif isinstance(v, (tuple,)):
            v = list(v)
        elif isinstance(v, np.ndarray):
            v = v.tolist()
        elif isinstance(v, torch.dtype):
            v = _dtype_mod.dtype_name(v)
        out[k] = v
    return out


def _program_from_json(d: dict) -> Program:
    from ..core.errors import UnimplementedError
    from . import op_version as _opv

    saved_versions = d.get("op_versions", {})  # pre-registry packages: v0
    problems = _opv.check_compatible(saved_versions)
    if problems:
        raise UnimplementedError("; ".join(problems))
    p = Program()
    blocks = [(p.global_block(), d)]
    for sub in d.get("sub_blocks", ()):
        blocks.append((p._create_block(sub["parent"]), sub))
    p._current_block_idx = 0
    for b, bd in blocks:
        for v in bd["vars"]:
            if v["parameter"]:
                b.create_parameter(v["name"], v["shape"], v["dtype"],
                                   trainable=v.get("trainable", True))
            else:
                b.create_var(v["name"], v["shape"], v["dtype"],
                             persistable=v["persistable"],
                             is_data=v["is_data"])
        for op in bd["ops"]:
            ins, outs, attrs = _opv.apply_converters(
                op["type"], int(saved_versions.get(op["type"], 0)),
                op["inputs"], op["outputs"], op["attrs"])
            b.append_op(op["type"], ins, outs, attrs)
    return p


def _prune_for_inference(program: Program, feed_names, fetch_names) -> Program:
    """Backward slice from the fetches, dropping backward/optimizer ops —
    the reference's prune + inference-transpile step (io.py:1164).  A kept
    control-flow op also needs the outer variables its sub-blocks read, and
    the sub-blocks are kept, with their indices, in test mode."""
    from .backward import _effective_io
    from .framework import copy_block

    blk = program.global_block()
    needed = set(fetch_names)
    kept = []
    for op in reversed(blk.ops):
        if op.type in ("backward_region", "sgd", "momentum", "adam", "feed",
                       "fetch"):
            continue
        ins, outs = _effective_io(program, op)
        if outs & needed:
            kept.append(op)
            needed |= ins
    kept.reverse()
    pruned = Program()
    copy_block(blk, pruned.global_block(), for_test=True,
               names=needed | set(fetch_names), ops=kept)
    if any(op.sub_block_indices() for op in kept):
        for src in program.blocks[1:]:
            copy_block(src, pruned._create_block(src.parent_idx),
                       for_test=True)
        pruned._current_block_idx = 0
    return pruned


def save_inference_model(dirname: str, feeded_var_names: Sequence[str],
                         target_vars: Sequence[Variable], executor: Executor,
                         main_program: Optional[Program] = None,
                         scope: Optional[Scope] = None,
                         cipher=None, model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None):
    """ref fluid/io.py:1164.  ``cipher`` (utils.crypto.Cipher) encrypts the
    saved parameter file like the reference's encrypted inference models
    (framework/io/crypto/): params.npz becomes params.npz.enc.

    ``model_filename`` selects the REFERENCE BINARY format: the program is
    written as a `framework.proto` ProgramDesc (conventionally
    ``model_filename="__model__"``) and parameters as LoDTensor files —
    one per var, or combined into ``params_filename`` — loadable by the
    reference's `load_inference_model` (static/proto_format.py)."""
    from .framework import default_main_program
    program = main_program or default_main_program()
    scope = scope or global_scope()
    fetch_names = [v.name if isinstance(v, Variable) else str(v)
                   for v in target_vars]
    pruned = _prune_for_inference(program, list(feeded_var_names), fetch_names)
    os.makedirs(dirname, exist_ok=True)
    if model_filename is not None:
        from . import proto_format as PF

        if cipher is not None:
            raise ValueError("cipher is a feature of the native json+npz "
                             "format; the reference wire format has no "
                             "encryption envelope")
        desc = PF.program_to_desc(pruned, list(feeded_var_names),
                                  fetch_names)
        with open(os.path.join(dirname, model_filename), "wb") as f:
            f.write(PF.encode_program_desc(desc))
        PF.save_reference_params(
            dirname, _persistable_values(pruned, scope), params_filename)
        # a stale native-format program would win load auto-detection
        for stale in ("program.json", "params.npz", "params.npz.enc"):
            sp = os.path.join(dirname, stale)
            if os.path.exists(sp):
                os.remove(sp)
        return fetch_names
    with open(os.path.join(dirname, "program.json"), "w") as f:
        json.dump({"program": _program_to_json(pruned),
                   "feeds": list(feeded_var_names),
                   "fetches": fetch_names}, f, indent=1)
    # mirror of the reference-format branch: a stale __model__ would win
    # the reference-API load spelling (model_filename="__model__")
    for stale in ("__model__", "__params__"):
        sp = os.path.join(dirname, stale)
        if os.path.exists(sp):
            os.remove(sp)
    plain = os.path.join(dirname, "params.npz")
    enc = plain + ".enc"
    if cipher is None:
        np.savez(plain, **_persistable_values(pruned, scope))
        if os.path.exists(enc):  # stale ciphertext from a prior cipher save
            os.remove(enc)
    else:
        import io as _io

        buf = _io.BytesIO()
        np.savez(buf, **_persistable_values(pruned, scope))
        cipher.encrypt_to_file(buf.getvalue(), enc)
        if os.path.exists(plain):  # stale plaintext from a prior plain save
            os.remove(plain)
    return fetch_names


def load_inference_model(dirname: str, executor: Executor,
                         scope: Optional[Scope] = None,
                         cipher=None, model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None
                         ) -> Tuple[Program, List[str], List[str]]:
    """ref fluid/io.py:1374 — returns (program, feed_names, fetch_names).
    Pass the ``cipher`` used at save time to read encrypted params.

    Accepts BOTH formats: the native `program.json` + `params.npz`, and
    the reference's binary `__model__` ProgramDesc + LoDTensor parameter
    files (auto-detected; or name them via ``model_filename`` /
    ``params_filename`` exactly like the reference API) — so a model
    exported by the reference's `save_inference_model` serves here
    unchanged (static/proto_format.py)."""
    scope = scope or global_scope()
    json_path = os.path.join(dirname, "program.json")
    if model_filename is None and not os.path.exists(json_path) \
            and os.path.exists(os.path.join(dirname, "__model__")):
        model_filename = "__model__"
    if model_filename is not None:
        from .framework import Parameter
        from . import proto_format as PF

        if cipher is not None:
            raise ValueError("cipher is a feature of the native json+npz "
                             "format; the reference wire format has no "
                             "encryption envelope")
        with open(os.path.join(dirname, model_filename), "rb") as f:
            desc = PF.parse_program_desc(f.read())
        program, feeds, fetches = PF.program_from_desc(desc)
        names = [v.name for v in program.list_vars()
                 if v.persistable or isinstance(v, Parameter)]
        for name, arr in PF.load_reference_params(
                dirname, names, params_filename).items():
            scope.set(name, arr)
        return program, feeds, fetches
    with open(json_path) as f:
        d = json.load(f)
    program = _program_from_json(d["program"])
    enc = os.path.join(dirname, "params.npz.enc")
    if cipher is not None:
        import io as _io

        data = np.load(_io.BytesIO(cipher.decrypt_from_file(enc)))
    elif os.path.exists(enc):
        raise ValueError(
            f"{dirname} holds an encrypted model (params.npz.enc); pass "
            "cipher= with the key it was saved with")
    else:
        data = np.load(os.path.join(dirname, "params.npz"))
    for name in data.files:
        scope.set(name, _from_saved(data[name]))
    return program, d["feeds"], d["fetches"]


def save(program: Program, model_prefix: str, executor: Executor = None,
         scope: Optional[Scope] = None, fetches: Sequence = ()) -> None:
    """Save a FULL program (including backward/optimizer ops) + its
    persistable state: ``<prefix>.pdmodel`` (JSON program) and
    ``<prefix>.pdparams`` (npz) (ref fluid/io.py save :1669 — program +
    state serialization; JSON in place of the pickled ProgramDesc).

    Unlike save_inference_model this does NOT prune: the saved program can
    keep TRAINING when reloaded (the reference's C++ train-from-saved-
    program demo contract, train/demo/demo_trainer.cc).
    """
    scope = scope or global_scope()
    os.makedirs(os.path.dirname(model_prefix) or ".", exist_ok=True)
    feeds = [v.name for v in program.global_block().vars.values()
             if getattr(v, "is_data", False)]
    fetch_names = [v.name if isinstance(v, Variable) else str(v)
                   for v in fetches]
    with open(model_prefix + ".pdmodel", "w") as f:
        json.dump({"program": _program_to_json(program), "feeds": feeds,
                   "fetches": fetch_names}, f, indent=1)
    with open(model_prefix + ".pdparams", "wb") as f:
        np.savez(f, **_persistable_values(program, scope))


def load(model_prefix: str, executor: Executor = None,
         scope: Optional[Scope] = None
         ) -> Tuple[Program, List[str], List[str]]:
    """Load a program + state saved by ``save`` (ref fluid/io.py load
    :1730).  Returns (program, feed_names, fetch_names)."""
    scope = scope or global_scope()
    with open(model_prefix + ".pdmodel") as f:
        d = json.load(f)
    program = _program_from_json(d["program"])
    data = np.load(model_prefix + ".pdparams")
    for name in data.files:
        scope.set(name, _from_saved(data[name]))
    return program, d["feeds"], d.get("fetches", [])
