"""Vision models, datasets and transforms of the port (counterpart of
paddle_tpu.vision; ref python/paddle/vision/)."""
from . import datasets, models, transforms
