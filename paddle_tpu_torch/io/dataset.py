"""Dataset abstractions (counterpart of paddle_tpu/io/dataset.py; ref
python/paddle/fluid/dataloader/dataset.py -- Dataset, IterableDataset,
TensorDataset, ComposeDataset, ChainDataset, Subset, random_split).

Host-side numpy, as in the JAX package: ``random_split`` draws its
permutation from ``np.random.RandomState(seed)``, so one integer seed gives
the JAX package's split."""
from __future__ import annotations

import bisect
from typing import List, Sequence

import numpy as np


class Dataset:
    """Map-style dataset: implement __getitem__ and __len__."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    """Stream-style dataset: implement __iter__."""

    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise TypeError("IterableDataset is not indexable")

    def __len__(self):
        raise TypeError("IterableDataset has no length")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        assert all(len(t) == len(tensors[0]) for t in tensors)
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(np.asarray(t[idx]) for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    """Zip multiple map-datasets sample-wise."""

    def __init__(self, datasets: List[Dataset]):
        self.datasets = datasets

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, tuple) else (item,))
        return tuple(out)

    def __len__(self):
        return min(len(d) for d in self.datasets)


class ChainDataset(Dataset):
    """Concatenate datasets end to end."""

    def __init__(self, datasets: List[Dataset]):
        self.datasets = datasets
        self._cum = np.cumsum([len(d) for d in datasets]).tolist()

    def __getitem__(self, idx):
        ds_idx = bisect.bisect_right(self._cum, idx)
        prev = 0 if ds_idx == 0 else self._cum[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]

    def __len__(self):
        return self._cum[-1]


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset: Dataset, lengths: Sequence[int], generator=None):
    assert sum(lengths) == len(dataset)
    rng = np.random.RandomState(generator if isinstance(generator, int)
                                else None)
    perm = rng.permutation(len(dataset))
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n].tolist()))
        offset += n
    return out
