"""hapi — high-level Model API (counterpart of paddle_tpu.hapi; ref:
python/paddle/hapi/model.py:788)."""
from . import callbacks
from .model import Model
