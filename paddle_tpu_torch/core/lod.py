"""LoDTensor and SelectedRows, the reference's ragged and sparse data model
(counterpart of paddle_tpu/core/lod.py).

``LoDTensor`` is a tensor plus the level-of-detail offset table that packs
variable-length sequences without padding (ref framework/lod_tensor.h:104);
``SelectedRows`` is the {rows, value, height} sparse row set an embedding
lookup's gradient takes in the reference (framework/selected_rows.h:32).

Both are HOST-side, numpy, as in the JAX package: the device ops
(``ops.sequence``) take the padded + lengths or flat + segment-ids forms,
and these classes convert losslessly to and from them.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["LoDTensor", "SelectedRows"]


def _lengths_to_offsets(lengths: Sequence[int]) -> List[int]:
    off = [0]
    for n in lengths:
        off.append(off[-1] + int(n))
    return off


class LoDTensor:
    """Host ragged tensor: flat values + hierarchical offset table.

    ``lod`` uses the reference's OFFSET convention (lod_tensor.h): level
    ``[0, 2, 5]`` means two sequences, rows [0:2) and [2:5).  Multi-level
    LoD nests: level i's offsets index into level i+1's entries (the
    outermost level first, as in the reference).
    """

    def __init__(self, data=None, lod: Optional[List[List[int]]] = None):
        self._data = None if data is None else np.asarray(data)
        self._lod: List[List[int]] = []
        if lod:
            self.set_lod(lod)

    # -- reference API -------------------------------------------------------
    def set(self, data, place=None):  # place accepted for parity
        self._data = np.asarray(data)

    def lod(self) -> List[List[int]]:
        return [list(l) for l in self._lod]

    def set_lod(self, lod: List[List[int]]) -> None:
        lod = [list(map(int, l)) for l in lod]
        for lv in lod:
            if not lv or lv[0] != 0 or any(b < a for a, b in zip(lv, lv[1:])):
                raise ValueError(
                    f"invalid LoD level {lv}: offsets must start at 0 and be "
                    "non-decreasing")
        for upper, lower in zip(lod, lod[1:]):
            if upper[-1] != len(lower) - 1:
                raise ValueError(
                    "nested LoD mismatch: outer level's last offset must "
                    "index the inner level's sequence count")
        self._lod = lod

    def recursive_sequence_lengths(self) -> List[List[int]]:
        return [[b - a for a, b in zip(lv, lv[1:])] for lv in self._lod]

    def set_recursive_sequence_lengths(self, lengths: List[List[int]]) -> None:
        self.set_lod([_lengths_to_offsets(lv) for lv in lengths])

    def has_valid_recursive_sequence_lengths(self) -> bool:
        if not self._lod:
            return self._data is not None
        return (self._data is not None
                and self._lod[-1][-1] == len(self._data))

    def numpy(self) -> np.ndarray:
        return self._data

    def __array__(self, dtype=None):
        return self._data if dtype is None else self._data.astype(dtype)

    @property
    def shape(self):
        return () if self._data is None else self._data.shape

    def __len__(self):
        return 0 if self._data is None else len(self._data)

    # -- device bridge -------------------------------------------------------
    def to_padded(self, maxlen: Optional[int] = None, pad_value=0.0):
        """Innermost level -> (padded [batch, maxlen, ...], lengths) — the
        layout ops.sequence consumes on device."""
        if not self._lod:
            raise ValueError("to_padded requires a LoD")
        offsets = self._lod[-1]
        lengths = np.asarray([b - a for a, b in zip(offsets, offsets[1:])],
                             np.int32)
        m = int(maxlen or (lengths.max() if len(lengths) else 0))
        feat = self._data.shape[1:]
        out = np.full((len(lengths), m) + feat, pad_value, self._data.dtype)
        for i, (a, b) in enumerate(zip(offsets, offsets[1:])):
            n = min(b - a, m)
            out[i, :n] = self._data[a:a + n]
        return out, lengths

    @classmethod
    def from_padded(cls, padded, lengths) -> "LoDTensor":
        padded = np.asarray(padded)
        lengths = [int(n) for n in np.asarray(lengths).ravel()]
        flat = np.concatenate([padded[i, :n] for i, n in enumerate(lengths)]
                              or [padded[:0, 0]])
        t = cls(flat)
        t.set_recursive_sequence_lengths([lengths])
        return t

    def __repr__(self):
        return (f"LoDTensor(shape={self.shape}, lod={self._lod})")


class SelectedRows:
    """Sparse row set: {rows, value, height} (ref selected_rows.h:32) —
    the reference's embedding-gradient representation; here the host-side
    form handed to sparse optimizers / the PS tables."""

    def __init__(self, rows: Sequence[int] = (), height: int = 0,
                 value=None):
        self._rows = [int(r) for r in rows]
        self._height = int(height)
        self._value = None if value is None else np.asarray(value)
        if self._value is not None and len(self._value) != len(self._rows):
            raise ValueError(
                f"value has {len(self._value)} rows for {len(self._rows)} "
                "row indices")

    def rows(self) -> List[int]:
        return list(self._rows)

    def height(self) -> int:
        return self._height

    def set_height(self, h: int) -> None:
        self._height = int(h)

    def get_tensor(self) -> Optional[np.ndarray]:
        return self._value

    def set(self, rows, value) -> None:
        value = np.asarray(value)
        rows = [int(r) for r in rows]
        if len(value) != len(rows):
            raise ValueError("rows/value length mismatch")
        self._rows, self._value = rows, value

    def sync_index(self) -> None:  # parity no-op (hash index is internal)
        pass

    def merge_add(self) -> "SelectedRows":
        """Reference MergeAdd (math/selected_rows_functor): sum duplicate
        rows — required before applying as a gradient."""
        uniq, inv = np.unique(self._rows, return_inverse=True)
        merged = np.zeros((len(uniq),) + self._value.shape[1:],
                          self._value.dtype)
        np.add.at(merged, inv, self._value)
        out = SelectedRows(uniq.tolist(), self._height, merged)
        return out

    def to_dense(self) -> np.ndarray:
        if self._height <= 0:
            raise ValueError("set height before to_dense()")
        out = np.zeros((self._height,) + self._value.shape[1:],
                       self._value.dtype)
        np.add.at(out, np.asarray(self._rows), self._value)
        return out

    @classmethod
    def from_dense_rows(cls, dense, rows, height=None) -> "SelectedRows":
        dense = np.asarray(dense)
        return cls(rows, height if height is not None else len(dense),
                   dense[np.asarray(rows)])

    def __repr__(self):
        return (f"SelectedRows(height={self._height}, "
                f"nnz_rows={len(self._rows)})")
