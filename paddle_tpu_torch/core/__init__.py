"""Flags, dtypes, places, random streams, typed errors and the host-side
LoD data model (counterpart of paddle_tpu.core)."""
from . import dtype, errors, flags, lod, random
from .lod import LoDTensor, SelectedRows
from .device import (
    CPUPlace,
    CUDAPlace,
    Place,
    TPUPlace,
    device_guard,
    get_device,
    is_compiled_with_tpu,
    set_device,
)
from .dtype import convert_dtype, get_default_dtype, set_default_dtype
from .flags import get_flags, set_flags
from .random import get_rng_state, seed, set_rng_state
