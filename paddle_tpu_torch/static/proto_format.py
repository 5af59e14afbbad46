"""Reference binary model interop: `__model__` ProgramDesc + LoDTensor
parameter files (counterpart of paddle_tpu/static/proto_format.py, pure
Python and numpy, copied; a var's torch dtype maps to its VarType by name).

Reference parity: `framework/framework.proto:212` (ProgramDesc/BlockDesc/
OpDesc/VarDesc/VarType — field numbers schema-copied below, no paddle or
protobuf import), `framework/lod_tensor.cc SerializeToStream` +
`tensor_util.cc TensorToStream` (the parameter wire format), and
`python/paddle/fluid/io.py:1164/:1374` (save/load_inference_model's
`__model__` + per-var / `__params__` layout).

A model saved by the reference's `save_inference_model` loads HERE — the proto decoder maps
each OpDesc onto the registered lowerings (op names/attrs kept parity
across static/ops*.py precisely for this) through the op-version
migration path, and the LoDTensor reader ingests the parameter bytes.
The encoder side round-trips our pruned inference programs into the same
wire format, so models also port OUT to reference tooling.

Proto2 wire handling: varints are decoded with 64-bit sign semantics
(dims use -1), repeated scalars accept both packed and unpacked layouts,
and unknown fields are skipped by wire type — old/new reference minors
parse without a schema bump.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import dtype as _dtype_mod

__all__ = [
    "parse_program_desc", "encode_program_desc",
    "program_from_desc", "program_to_desc",
    "read_lod_tensor", "write_lod_tensor",
    "load_reference_params", "save_reference_params",
]

# -- AttrType enum (framework.proto:25) --------------------------------------
INT, FLOAT, STRING, INTS, FLOATS, STRINGS, BOOLEAN, BOOLEANS, BLOCK, LONG, \
    BLOCKS, LONGS = range(12)

# -- VarType.Type (framework.proto:105) --------------------------------------
VARTYPE_NP = {0: np.bool_, 1: np.int16, 2: np.int32, 3: np.int64,
              5: np.float32, 6: np.float64, 20: np.uint8, 21: np.int8}
NP_VARTYPE = {np.dtype(v).name: k for k, v in VARTYPE_NP.items()}


def _vartype_np(code: int):
    if code == 4:    # FP16
        return np.float16
    if code == 22:   # BF16
        import ml_dtypes

        return ml_dtypes.bfloat16
    try:
        return VARTYPE_NP[code]
    except KeyError:
        raise ValueError(f"unsupported VarType.Type {code}") from None


def _np_vartype(dtype) -> int:
    if isinstance(dtype, np.dtype) and dtype.kind == "V" \
            and dtype.itemsize == 2:
        return 22    # bfloat16 stored as raw two-byte elements
    name = (_dtype_mod.dtype_name(dtype) if isinstance(dtype, torch.dtype)
            else np.dtype(dtype).name)
    if name == "float16":
        return 4
    if name == "bfloat16":
        return 22
    try:
        return NP_VARTYPE[name]
    except KeyError:
        raise ValueError(f"no VarType.Type for dtype {name}") from None


LOD_TENSOR, FEED_MINIBATCH, FETCH_LIST = 7, 9, 10


# =========================================================================
# proto2 wire primitives
# =========================================================================

def _read_varint(b: bytes, off: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        byte = b[off]
        off += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result & 0xFFFFFFFFFFFFFFFF, off
        shift += 7


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _write_varint(v: int) -> bytes:
    v &= 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    while True:
        byte = v & 0x7F
        v >>= 7
        if v:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _iter_fields(b: bytes):
    """Yield (field_number, wire_type, value) skipping nothing: value is
    int for varint/fixed, bytes for length-delimited."""
    off = 0
    n = len(b)
    while off < n:
        key, off = _read_varint(b, off)
        num, wire = key >> 3, key & 7
        if wire == 0:
            v, off = _read_varint(b, off)
        elif wire == 1:
            v = struct.unpack_from("<Q", b, off)[0]
            off += 8
        elif wire == 2:
            ln, off = _read_varint(b, off)
            v = b[off:off + ln]
            off += ln
        elif wire == 5:
            v = struct.unpack_from("<I", b, off)[0]
            off += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield num, wire, v


def _field(num: int, wire: int, payload: bytes) -> bytes:
    return _write_varint((num << 3) | wire) + payload


def _f_varint(num: int, v: int) -> bytes:
    return _field(num, 0, _write_varint(v))


def _f_bytes(num: int, v: bytes) -> bytes:
    return _field(num, 2, _write_varint(len(v)) + v)


def _f_float(num: int, v: float) -> bytes:
    return _field(num, 5, struct.pack("<f", v))


def _varints_maybe_packed(wire, v) -> List[int]:
    """A repeated varint field: one value (unpacked) or a packed blob."""
    if wire == 0:
        return [v]
    out = []
    off = 0
    while off < len(v):
        x, off = _read_varint(v, off)
        out.append(x)
    return out


def _floats_maybe_packed(wire, v) -> List[float]:
    if wire == 5:
        return [struct.unpack("<f", struct.pack("<I", v))[0]]
    return list(struct.unpack(f"<{len(v) // 4}f", v))


# =========================================================================
# message decoders (field numbers from framework.proto)
# =========================================================================

def _parse_attr(b: bytes) -> Tuple[str, int, object]:
    name, atype = "", INT
    i = f = s = blk = l = None
    ints: List[int] = []
    floats: List[float] = []
    strings: List[str] = []
    b_ = None
    bools: List[bool] = []
    blocks: List[int] = []
    longs: List[int] = []
    for num, wire, v in _iter_fields(b):
        if num == 1:
            name = v.decode()
        elif num == 2:
            atype = v
        elif num == 3:
            i = _signed(v) & 0xFFFFFFFF
            i = i - (1 << 32) if i >= (1 << 31) else i
        elif num == 4:
            f = struct.unpack("<f", struct.pack("<I", v))[0]
        elif num == 5:
            s = v.decode()
        elif num == 6:
            ints.extend(_varints_maybe_packed(wire, v))
        elif num == 7:
            floats.extend(_floats_maybe_packed(wire, v))
        elif num == 8:
            strings.append(v.decode())
        elif num == 10:
            b_ = bool(v)
        elif num == 11:
            bools.extend(bool(x) for x in _varints_maybe_packed(wire, v))
        elif num == 12:
            blk = v
        elif num == 13:
            l = _signed(v)
        elif num == 14:
            blocks.extend(_varints_maybe_packed(wire, v))
        elif num == 15:
            longs.extend(_signed(x) for x in _varints_maybe_packed(wire, v))
    value = {
        INT: i, FLOAT: f, STRING: s,
        INTS: [x - (1 << 32) if x >= (1 << 31) else x
               for x in (y & 0xFFFFFFFF for y in ints)],
        FLOATS: floats, STRINGS: strings, BOOLEAN: b_, BOOLEANS: bools,
        BLOCK: blk, LONG: l, BLOCKS: blocks, LONGS: longs,
    }[atype]
    return name, atype, value


def _parse_opvar(b: bytes) -> Tuple[str, List[str]]:
    param, args = "", []
    for num, wire, v in _iter_fields(b):
        if num == 1:
            param = v.decode()
        elif num == 2:
            args.append(v.decode())
    return param, args


def _parse_op(b: bytes) -> dict:
    op = {"type": "", "inputs": {}, "outputs": {}, "attrs": {},
          "attr_types": {}}
    for num, wire, v in _iter_fields(b):
        if num == 3:
            op["type"] = v.decode()
        elif num == 1:
            k, args = _parse_opvar(v)
            op["inputs"][k] = args
        elif num == 2:
            k, args = _parse_opvar(v)
            op["outputs"][k] = args
        elif num == 4:
            name, atype, value = _parse_attr(v)
            op["attrs"][name] = value
            op["attr_types"][name] = atype
    return op


def _parse_tensor_desc(b: bytes) -> dict:
    dtype, dims = 5, []
    for num, wire, v in _iter_fields(b):
        if num == 1:
            dtype = v
        elif num == 2:
            dims.extend(_signed(x) for x in _varints_maybe_packed(wire, v))
    return {"data_type": dtype, "dims": dims}


def _parse_vartype(b: bytes) -> dict:
    vt = {"type": LOD_TENSOR, "tensor": None, "lod_level": 0}
    for num, wire, v in _iter_fields(b):
        if num == 1:
            vt["type"] = v
        elif num == 3:  # LoDTensorDesc
            for n2, w2, v2 in _iter_fields(v):
                if n2 == 1:
                    vt["tensor"] = _parse_tensor_desc(v2)
                elif n2 == 2:
                    vt["lod_level"] = v2
        elif num == 2:  # selected_rows TensorDesc
            vt["tensor"] = _parse_tensor_desc(v)
    return vt


def _parse_var(b: bytes) -> dict:
    var = {"name": "", "type": None, "persistable": False}
    for num, wire, v in _iter_fields(b):
        if num == 1:
            var["name"] = v.decode()
        elif num == 2:
            var["type"] = _parse_vartype(v)
        elif num == 3:
            var["persistable"] = bool(v)
    return var


def _parse_block(b: bytes) -> dict:
    blk = {"idx": 0, "parent_idx": -1, "vars": [], "ops": []}
    for num, wire, v in _iter_fields(b):
        if num == 1:
            blk["idx"] = v
        elif num == 2:
            blk["parent_idx"] = _signed(v)
        elif num == 3:
            blk["vars"].append(_parse_var(v))
        elif num == 4:
            blk["ops"].append(_parse_op(v))
    return blk


def parse_program_desc(data: bytes) -> dict:
    """ProgramDesc bytes -> {'blocks': [...], 'version': int}."""
    prog = {"blocks": [], "version": 0}
    for num, wire, v in _iter_fields(data):
        if num == 1:
            prog["blocks"].append(_parse_block(v))
        elif num == 4:  # Version message
            for n2, w2, v2 in _iter_fields(v):
                if n2 == 1:
                    prog["version"] = _signed(v2)
    return prog


# =========================================================================
# message encoders (round trip; also the export path)
# =========================================================================

def _enc_attr(name: str, atype: int, value) -> bytes:
    out = _f_bytes(1, name.encode()) + _f_varint(2, atype)
    if atype == INT:
        # proto2 int32: negative values are sign-extended to 64 bits and
        # emitted as the canonical 10-byte varint (NOT truncated to the
        # 32-bit pattern, which real protobuf decoders reject/misread)
        out += _f_varint(3, int(value) & 0xFFFFFFFFFFFFFFFF)
    elif atype == FLOAT:
        out += _f_float(4, float(value))
    elif atype == STRING:
        out += _f_bytes(5, str(value).encode())
    elif atype == INTS:
        for x in value:
            out += _f_varint(6, int(x) & 0xFFFFFFFFFFFFFFFF)
    elif atype == FLOATS:
        for x in value:
            out += _f_float(7, float(x))
    elif atype == STRINGS:
        for x in value:
            out += _f_bytes(8, str(x).encode())
    elif atype == BOOLEAN:
        out += _f_varint(10, 1 if value else 0)
    elif atype == BOOLEANS:
        for x in value:
            out += _f_varint(11, 1 if x else 0)
    elif atype == BLOCK:
        out += _f_varint(12, int(value))
    elif atype == LONG:
        out += _f_varint(13, int(value))
    elif atype == BLOCKS:
        for x in value:
            out += _f_varint(14, int(x))
    elif atype == LONGS:
        for x in value:
            out += _f_varint(15, int(x))
    else:
        raise ValueError(f"bad AttrType {atype}")
    return out


def _enc_opvar(num: int, param: str, args: Sequence[str]) -> bytes:
    body = _f_bytes(1, param.encode())
    for a in args:
        body += _f_bytes(2, a.encode())
    return _f_bytes(num, body)


def _enc_op(op: dict) -> bytes:
    body = b""
    for k, args in op["inputs"].items():
        body += _enc_opvar(1, k, args)
    for k, args in op["outputs"].items():
        body += _enc_opvar(2, k, args)
    body += _f_bytes(3, op["type"].encode())
    for name, value in op["attrs"].items():
        body += _f_bytes(4, _enc_attr(name, op["attr_types"][name], value))
    return body


def _enc_tensor_desc(td: dict) -> bytes:
    body = _f_varint(1, td["data_type"])
    for d in td["dims"]:
        body += _f_varint(2, d)
    return body


def _enc_var(var: dict) -> bytes:
    vt = var["type"]
    vt_body = _f_varint(1, vt["type"])
    if vt.get("tensor") is not None:
        lod_body = _f_bytes(1, _enc_tensor_desc(vt["tensor"])) \
            + _f_varint(2, vt.get("lod_level", 0))
        vt_body += _f_bytes(3, lod_body)
    body = _f_bytes(1, var["name"].encode()) + _f_bytes(2, vt_body)
    if var.get("persistable"):
        body += _f_varint(3, 1)
    return body


def _enc_block(blk: dict) -> bytes:
    body = _f_varint(1, blk["idx"]) + _f_varint(2, blk["parent_idx"])
    for v in blk["vars"]:
        body += _f_bytes(3, _enc_var(v))
    for op in blk["ops"]:
        body += _f_bytes(4, _enc_op(op))
    return body


def encode_program_desc(prog: dict) -> bytes:
    out = b""
    for blk in prog["blocks"]:
        out += _f_bytes(1, _enc_block(blk))
    out += _f_bytes(4, _f_varint(1, prog.get("version", 0)))
    return out


# =========================================================================
# desc <-> Program
# =========================================================================

def program_from_desc(desc: dict):
    """Decoded ProgramDesc -> (Program, feed_names, fetch_names).

    The reference's feed/fetch ops (io.py prepend_feed_ops/append_fetch_ops)
    are unwound into the (program, feeds, fetches) triple our Executor
    uses; op attrs flow through the op-version migration path (saved
    reference descs are version 0 of each op)."""
    from ..core.errors import UnimplementedError
    from . import op_version as _opv
    from .framework import Program
    from .registry import registered_ops

    if len(desc["blocks"]) != 1:
        raise UnimplementedError(
            "reference __model__ with control-flow sub-blocks: the proto "
            "importer handles single-block inference programs; rebuild "
            "cond/while via static.control_flow (executor lowers those to "
            "lax.cond/while_loop — the reference block encoding carries "
            "scope semantics that the single-block importer does not carry)")
    blk = desc["blocks"][0]
    p = Program()
    b = p.global_block()
    known = set(registered_ops())
    feeds = [op["outputs"]["Out"][0] for op in blk["ops"]
             if op["type"] == "feed"]
    fetches = [op["inputs"]["X"][0] for op in blk["ops"]
               if op["type"] == "fetch"]

    for var in blk["vars"]:
        vt = var["type"] or {}
        if vt.get("type") in (FEED_MINIBATCH, FETCH_LIST):
            continue
        td = vt.get("tensor") or {"data_type": 5, "dims": []}
        dtype = np.dtype(_vartype_np(td["data_type"])).name
        shape = tuple(td["dims"])
        if var["persistable"]:
            # reference VarDesc does not mark Parameter-ness; persistable
            # non-data vars load as parameters (io.py load matches on
            # persistables either way)
            b.create_parameter(var["name"], shape, dtype)
        else:
            b.create_var(var["name"], shape, dtype,
                         is_data=var["name"] in feeds)
    for op in blk["ops"]:
        if op["type"] in ("feed", "fetch"):
            continue
        if op["type"] not in known:
            raise UnimplementedError(
                f"__model__ uses op {op['type']!r} with no registered "
                "lowering")
        ins, outs, attrs = _opv.apply_converters(
            op["type"], 0, dict(op["inputs"]), dict(op["outputs"]),
            dict(op["attrs"]))
        # drop empty slots (the reference serializes dispensable empties)
        ins = {k: v for k, v in ins.items() if v}
        outs = {k: v for k, v in outs.items() if v}
        b.append_op(op["type"], ins, outs, attrs)
    return p, feeds, fetches


def _attr_type_of(value) -> Tuple[int, object]:
    if isinstance(value, bool):
        return BOOLEAN, value
    if isinstance(value, (int, np.integer)):
        v = int(value)
        return (INT, v) if -(1 << 31) <= v < (1 << 31) else (LONG, v)
    if isinstance(value, (float, np.floating)):
        return FLOAT, float(value)
    if isinstance(value, str):
        return STRING, value
    if isinstance(value, np.ndarray):
        value = value.tolist()
    if isinstance(value, (list, tuple)):
        vals = list(value)
        if all(isinstance(x, bool) for x in vals) and vals:
            return BOOLEANS, vals
        if all(isinstance(x, (int, np.integer)) for x in vals):
            vals = [int(x) for x in vals]
            if all(-(1 << 31) <= x < (1 << 31) for x in vals):
                return INTS, vals
            return LONGS, vals
        if all(isinstance(x, (int, float, np.floating, np.integer))
               for x in vals):
            return FLOATS, [float(x) for x in vals]
        if all(isinstance(x, str) for x in vals):
            return STRINGS, vals
    raise ValueError(f"attr value {value!r} has no AttrType mapping")


def program_to_desc(program, feeds: Sequence[str],
                    fetches: Sequence[str]) -> dict:
    """Our (single-block) Program -> ProgramDesc dict ready for
    encode_program_desc, with reference-style feed/fetch ops."""
    from ..core.errors import UnimplementedError
    from .framework import SUB_BLOCK_ATTRS, Parameter

    # mirror of the import-side guard (program_from_desc): a silently
    # truncated export would round-trip to a program missing its cond/while
    # bodies — fail legibly instead (ADVICE round-5 finding)
    if (len(program.blocks) > 1
            or any(a in op.attrs for op in program.global_block().ops
                   for a in SUB_BLOCK_ATTRS)):
        raise UnimplementedError(
            "exporting a Program with control-flow sub-blocks: the proto "
            "exporter emits single-block inference programs only — the "
            "reference block encoding carries scope semantics that do not "
            "survive a single-block desc, so a multi-block export would drop "
            "the cond/while bodies silently")

    blk = program.global_block()
    vars_out = [
        {"name": "feed", "persistable": True,
         "type": {"type": FEED_MINIBATCH, "tensor": None}},
        {"name": "fetch", "persistable": True,
         "type": {"type": FETCH_LIST, "tensor": None}},
    ]
    for v in blk.vars.values():
        vars_out.append({
            "name": v.name,
            "persistable": bool(v.persistable
                                or isinstance(v, Parameter)),
            "type": {"type": LOD_TENSOR, "lod_level": 0,
                     "tensor": {"data_type": _np_vartype(v.dtype),
                                "dims": [int(d) for d in v.shape]}}})
    ops_out = []
    for i, name in enumerate(feeds):
        ops_out.append({"type": "feed", "inputs": {"X": ["feed"]},
                        "outputs": {"Out": [name]},
                        "attrs": {"col": i}, "attr_types": {"col": INT}})
    for op in blk.ops:
        attrs, attr_types = {}, {}
        for k, v in op.attrs.items():
            try:
                attr_types[k], attrs[k] = _attr_type_of(v)
            except ValueError:
                continue  # lowering-internal attrs with no proto encoding
        ops_out.append({"type": op.type, "inputs": dict(op.inputs),
                        "outputs": dict(op.outputs), "attrs": attrs,
                        "attr_types": attr_types})
    for i, name in enumerate(fetches):
        ops_out.append({"type": "fetch", "inputs": {"X": [name]},
                        "outputs": {"Out": ["fetch"]},
                        "attrs": {"col": i}, "attr_types": {"col": INT}})
    return {"blocks": [{"idx": 0, "parent_idx": -1, "vars": vars_out,
                        "ops": ops_out}], "version": 0}


# =========================================================================
# LoDTensor parameter files (lod_tensor.cc SerializeToStream)
# =========================================================================

def write_lod_tensor(f, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr)
    f.write(struct.pack("<I", 0))          # LoDTensor version
    f.write(struct.pack("<Q", 0))          # lod levels
    f.write(struct.pack("<I", 0))          # Tensor version
    desc = _enc_tensor_desc({"data_type": _np_vartype(arr.dtype),
                             "dims": list(arr.shape)})
    f.write(struct.pack("<i", len(desc)))
    f.write(desc)
    f.write(arr.tobytes())


def read_lod_tensor(f) -> np.ndarray:
    (ver,) = struct.unpack("<I", f.read(4))
    if ver != 0:
        raise ValueError(f"unsupported LoDTensor version {ver}")
    (lod_levels,) = struct.unpack("<Q", f.read(8))
    for _ in range(lod_levels):
        (nbytes,) = struct.unpack("<Q", f.read(8))
        f.read(nbytes)  # LoD offsets: meaningless under the dense layout
    (tver,) = struct.unpack("<I", f.read(4))
    if tver != 0:
        raise ValueError(f"unsupported Tensor version {tver}")
    (dlen,) = struct.unpack("<i", f.read(4))
    td = _parse_tensor_desc(f.read(dlen))
    dtype = np.dtype(_vartype_np(td["data_type"]))
    count = int(np.prod(td["dims"])) if td["dims"] else 1
    data = f.read(count * dtype.itemsize)
    return np.frombuffer(data, dtype).reshape(td["dims"]).copy()


def save_reference_params(dirname: str, values: Dict[str, np.ndarray],
                          params_filename: Optional[str] = None) -> None:
    """Per-var files (save_vars) or one combined file (save_combine —
    tensors concatenated in SORTED name order, the reference convention)."""
    import os

    if params_filename:
        with open(os.path.join(dirname, params_filename), "wb") as f:
            for name in sorted(values):
                write_lod_tensor(f, values[name])
    else:
        for name, arr in values.items():
            with open(os.path.join(dirname, name), "wb") as f:
                write_lod_tensor(f, arr)


def load_reference_params(dirname: str, names: Sequence[str],
                          params_filename: Optional[str] = None
                          ) -> Dict[str, np.ndarray]:
    import os

    out = {}
    if params_filename:
        with open(os.path.join(dirname, params_filename), "rb") as f:
            for name in sorted(names):
                out[name] = read_lod_tensor(f)
    else:
        for name in names:
            with open(os.path.join(dirname, name), "rb") as f:
                out[name] = read_lod_tensor(f)
    return out
