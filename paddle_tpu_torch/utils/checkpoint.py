"""Checkpoint save/load (counterpart of paddle_tpu/utils/checkpoint.py).

Reference parity: fluid/io.py save/load_persistables (:598), dygraph
save_dygraph/load_dygraph state-dict pickles.  A state (a nested structure
of dicts, lists and tuples over tensors, arrays and numbers) is written as
``<path>.npz`` plus a structure file ``<path>.tree``, host-side.

The ``.npz`` is the JAX package's file exactly: one ``arr_i`` a leaf, in
JAX's leaf order (dict keys sorted, lists and tuples in order, None no
leaf), each leaf ``np.asarray`` of the value (tensors copied to the host;
bfloat16 through ``ml_dtypes`` where installed, else as float32).  Either
package's data file loads in the other.  The JAX ``.tree`` pickles a JAX
``PyTreeDef``, which the port cannot read without JAX; the port's pickles a
plain nested structure (``("d", [(key, node), ...])``, ``("l", [...])``,
``("t", [...])``, ``("n",)`` for None, ``("a", i)`` for leaf ``i``).
``load`` returns numpy leaves, dicts with their keys in sorted order, as
the JAX package's does.

Writes are atomic (tmp file in the target directory + ``os.replace`` per
file; the .npz — the file ``load`` keys its existence check on — lands
last), so a crashed saver never leaves a load-able half checkpoint.
Sharded/resharding checkpoints live in elastic/checkpoint.py; ``load``
recognizes that manifest layout when handed one (a directory containing
``manifest.json``, written by either package) and returns the gathered
flat state dict, so callers keep a single load entry point.
"""
from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

MANIFEST_NAME = "manifest.json"


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            try:
                import ml_dtypes
            except ImportError:
                return t.float().numpy()
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree):
    """(leaves, structure) in JAX's leaf order."""
    leaves: List[np.ndarray] = []

    def rec(x):
        if x is None:
            return ("n",)
        if isinstance(x, Mapping):
            return ("d", [(k, rec(x[k])) for k in sorted(x)])
        if isinstance(x, list):
            return ("l", [rec(v) for v in x])
        if isinstance(x, tuple):
            return ("t", [rec(v) for v in x])
        leaves.append(_host_array(x))
        return ("a", len(leaves) - 1)

    return leaves, rec(tree)


def _unflatten(node, leaves):
    kind = node[0]
    if kind == "n":
        return None
    if kind == "a":
        return leaves[node[1]]
    if kind == "d":
        return {k: _unflatten(v, leaves) for k, v in node[1]}
    items = [_unflatten(v, leaves) for v in node[1]]
    return items if kind == "l" else tuple(items)


def _atomic_write(path: str, writer) -> None:
    """Write via a tempfile in the destination directory + os.replace."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            writer(f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save(state: Any, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    leaves, structure = _flatten(state)
    arrays = {f"arr_{i}": a for i, a in enumerate(leaves)}
    npz_path = path + ".npz" if not path.endswith(".npz") else path
    # tree first, npz last: load() keys on the npz existing, so a crash in
    # between leaves nothing load() would accept
    _atomic_write(path + ".tree", lambda f: pickle.dump(structure, f))
    _atomic_write(npz_path, lambda f: np.savez(f, **arrays))


def load(path: str) -> Any:
    if os.path.isdir(path) and os.path.exists(
            os.path.join(path, MANIFEST_NAME)):
        from ..elastic import checkpoint as _eckpt

        state, _meta = _eckpt.read_state(path)
        return state
    npz_path = path + ".npz" if not path.endswith(".npz") else path
    if not os.path.exists(npz_path):
        raise FileNotFoundError(npz_path)
    data = np.load(npz_path, allow_pickle=False)
    with open(path + ".tree", "rb") as f:
        structure = pickle.load(f)
    leaves = [data[f"arr_{i}"] for i in range(len(data.files))]
    return _unflatten(structure, leaves)


def save_state_dict(state_dict: Dict[str, Any], path: str) -> None:
    save(state_dict, path)


def load_state_dict(path: str) -> Dict[str, Any]:
    return load(path)
