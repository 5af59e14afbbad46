"""Vision datasets (counterpart of paddle_tpu/vision/datasets.py; ref
python/paddle/vision/datasets/ -- MNIST, FashionMNIST, Cifar10 / 100,
Flowers, VOC2012).

Nothing is downloaded: a dataset reads local files when it is given them
(idx / ubyte for MNIST, ``<label>/<image>.npy`` directories for Flowers and
VOC2012) and otherwise makes deterministic synthetic samples, the JAX
package's bit for bit for the same arguments.  Samples are numpy arrays.
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np

from ..io.dataset import Dataset


class MNIST(Dataset):
    """MNIST digits; (1, 28, 28) float32 in [-1, 1] + int label."""

    def __init__(self, image_path: Optional[str] = None,
                 label_path: Optional[str] = None, mode: str = "train",
                 transform=None, backend: str = "numpy",
                 synthetic_size: int = 2048):
        del backend
        self.mode = mode
        self.transform = transform
        if image_path and os.path.exists(image_path):
            if not label_path:
                raise ValueError(
                    "MNIST: label_path is required when image_path is given")
            self.images = _read_idx_images(image_path)
            self.labels = _read_idx_labels(label_path)
        else:
            # class base patterns are mode-independent so train/test share the
            # same underlying "digits" and eval accuracy is meaningful; only
            # the noise and label draw differ per mode
            base = np.random.RandomState(42).rand(10, 28, 28).astype(
                np.float32)
            rng = np.random.RandomState(0 if mode == "train" else 1)
            n = synthetic_size if mode == "train" else synthetic_size // 4
            self.labels = rng.randint(0, 10, n).astype(np.int32)
            noise = rng.rand(n, 28, 28).astype(np.float32) * 0.3
            self.images = (base[self.labels] + noise) / 1.3 * 255.0

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32) / 127.5 - 1.0
        img = img[None, :, :]  # CHW
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int32(self.labels[idx])

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 transform=None, synthetic_size: int = 1024):
        self.transform = transform
        if data_file and os.path.exists(data_file):
            raise NotImplementedError("local CIFAR archive loading: TODO")
        rng = np.random.RandomState(7 if mode == "train" else 8)
        n = synthetic_size if mode == "train" else synthetic_size // 4
        self.labels = rng.randint(0, 10, n).astype(np.int32)
        base = rng.rand(10, 3, 32, 32).astype(np.float32)
        self.images = np.clip(
            base[self.labels]
            + rng.rand(n, 3, 32, 32).astype(np.float32) * 0.3, 0, 1) * 255.0

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32) / 127.5 - 1.0
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int32(self.labels[idx])

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    pass


def _read_idx_images(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, f"bad MNIST image magic {magic}"
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows, cols)


def _read_idx_labels(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        assert magic == 2049, f"bad MNIST label magic {magic}"
        return np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)


class Flowers(Dataset):
    """Oxford-102 flowers (ref vision/datasets/flowers.py /
    paddle/dataset/flowers.py): (3, H, W) float32 image + int label.

    Loads a directory of ``<label>/<image>.npy`` arrays when ``data_dir``
    is given; otherwise synthesizes class-conditional images (each class
    gets a distinct color/frequency signature so classifiers can learn)."""

    NUM_CLASSES = 102

    def __init__(self, data_dir: Optional[str] = None, mode: str = "train",
                 size: int = 64, transform=None, synthetic_size: int = 512):
        self.transform = transform
        if data_dir and os.path.isdir(data_dir):
            self.items = []
            for label in sorted(os.listdir(data_dir)):
                d = os.path.join(data_dir, label)
                if not os.path.isdir(d):
                    continue
                for f in sorted(os.listdir(d)):
                    if f.endswith(".npy"):
                        self.items.append((os.path.join(d, f), int(label)))
            # deterministic 80/20 train/test split (text datasets policy)
            self.items = [x for i, x in enumerate(self.items)
                          if (i % 5 != 4) == (mode == "train")]
            self._synth = None
        else:
            rng = np.random.RandomState(11 if mode == "train" else 12)
            labels = rng.randint(0, self.NUM_CLASSES, synthetic_size)
            self._synth = (labels, size,
                           13 if mode == "train" else 14)
            self.items = list(range(synthetic_size))

    def __getitem__(self, idx):
        if self._synth is None:
            path, label = self.items[idx]
            img = np.load(path).astype(np.float32)
        else:
            labels, size, seed = self._synth
            label = int(labels[idx])
            rng = np.random.RandomState(seed * 100003 + idx)
            yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
            freq = 1 + label % 7
            base = np.stack([
                np.sin(2 * np.pi * freq * yy + label),
                np.cos(2 * np.pi * freq * xx + label * 0.5),
                np.sin(2 * np.pi * freq * (xx + yy)),
            ])
            img = (base + 0.1 * rng.randn(3, size, size)).astype(np.float32)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(label)

    def __len__(self):
        return len(self.items)


class VOC2012(Dataset):
    """Pascal VOC-2012 segmentation (ref vision/datasets/voc2012.py):
    (3, H, W) float32 image, (H, W) int64 mask in [0, 21)."""

    NUM_CLASSES = 21

    def __init__(self, data_dir: Optional[str] = None, mode: str = "train",
                 size: int = 64, transform=None, synthetic_size: int = 128):
        self.transform = transform
        self.size = size
        if data_dir and os.path.isdir(data_dir):
            imgs = sorted(f for f in os.listdir(data_dir)
                          if f.endswith(".img.npy"))
            self.items = [(os.path.join(data_dir, f),
                           os.path.join(data_dir,
                                        f.replace(".img.npy", ".mask.npy")))
                          for i, f in enumerate(imgs)
                          if (i % 5 != 4) == (mode == "train")]
            self._seed = None
        else:
            self._seed = 15 if mode == "train" else 16
            self.items = list(range(synthetic_size))

    def __getitem__(self, idx):
        if self._seed is None:
            img_p, mask_p = self.items[idx]
            img = np.load(img_p).astype(np.float32)
            mask = np.load(mask_p).astype(np.int64)
        else:
            rng = np.random.RandomState(self._seed * 100003 + idx)
            s = self.size
            mask = np.zeros((s, s), np.int64)
            img = rng.randn(3, s, s).astype(np.float32) * 0.1
            for _ in range(3):  # class-colored rectangles
                c = int(rng.randint(1, self.NUM_CLASSES))
                x0, y0 = rng.randint(0, s // 2, 2)
                w, h = rng.randint(s // 8, s // 2, 2)
                mask[y0:y0 + h, x0:x0 + w] = c
                img[:, y0:y0 + h, x0:x0 + w] += (
                    np.array([c % 3, (c // 3) % 3, (c // 9) % 3],
                             np.float32)[:, None, None] - 1.0)
        if self.transform is not None:
            img = self.transform(img)
        return img, mask

    def __len__(self):
        return len(self.items)
