"""Flags, dtypes, device resolution and the host-side LoD data model
(counterpart of paddle_tpu.core)."""
from . import lod
from .lod import LoDTensor, SelectedRows
