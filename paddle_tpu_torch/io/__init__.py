"""paddle_tpu_torch.io — datasets, samplers, DataLoader, device prefetch
and the multi-slot datasets (counterpart of paddle_tpu.io, with its
exports; ref: paddle/io/, fluid/dataloader, framework/data_feed.*)."""
from .dataloader import DataLoader, default_collate_fn
from .prefetch import DeviceFeeder, device_prefetch
from .dataset import (
    ChainDataset,
    ComposeDataset,
    Dataset,
    IterableDataset,
    Subset,
    TensorDataset,
    random_split,
)
from .multislot import DatasetFactory, InMemoryDataset, QueueDataset
from .sampler import (
    BatchSampler,
    DistributedBatchSampler,
    RandomSampler,
    Sampler,
    SequenceSampler,
)
