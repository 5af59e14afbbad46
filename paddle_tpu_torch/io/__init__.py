"""Datasets (counterpart of paddle_tpu.io).  The dataset abstractions are
ported; the loader, the samplers and the device prefetch wait for the data
slice (ROADMAP.md Queue 1 item 7)."""
from .dataset import (
    ChainDataset,
    ComposeDataset,
    Dataset,
    IterableDataset,
    Subset,
    TensorDataset,
    random_split,
)
