"""Image transforms (counterpart of paddle_tpu/vision/transforms.py; ref
python/paddle/vision/transforms/ -- Compose, Normalize, Resize, RandomCrop,
RandomHorizontalFlip, CenterCrop, ToTensor).  Numpy on the host (CHW), as
in the JAX package: the same numpy generator state gives the same result
bit for bit."""
from __future__ import annotations

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class Normalize:
    def __init__(self, mean, std, data_format="CHW"):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def __call__(self, x):
        shape = (-1, 1, 1) if self.data_format == "CHW" else (1, 1, -1)
        return (x - self.mean.reshape(shape)) / self.std.reshape(shape)


class Resize:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, x):
        c, h, w = x.shape
        oh, ow = self.size
        ridx = (np.arange(oh) * h / oh).astype(np.int64)
        cidx = (np.arange(ow) * w / ow).astype(np.int64)
        return x[:, ridx][:, :, cidx]


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, x):
        if np.random.rand() < self.prob:
            return x[:, :, ::-1].copy()
        return x


class RandomCrop:
    def __init__(self, size, padding=0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, x):
        if self.padding:
            x = np.pad(x, ((0, 0), (self.padding, self.padding),
                           (self.padding, self.padding)))
        c, h, w = x.shape
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return x[:, i:i + th, j:j + tw]


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, x):
        c, h, w = x.shape
        th, tw = self.size
        i = (h - th) // 2
        j = (w - tw) // 2
        return x[:, i:i + th, j:j + tw]


class ToTensor:
    """HWC uint8 -> CHW float32 in [0,1]."""

    def __call__(self, x):
        if x.ndim == 3 and x.shape[-1] in (1, 3):
            x = np.transpose(x, (2, 0, 1))
        return x.astype(np.float32) / 255.0
