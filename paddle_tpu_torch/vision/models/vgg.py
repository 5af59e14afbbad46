"""VGG family (counterpart of paddle_tpu/vision/models/vgg.py; ref
python/paddle/vision/models/vgg.py)."""
from __future__ import annotations

from typing import Optional

import torch

from ... import nn, ops
from ...core.device import resolve_device

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False, in_channels=3, *,
                generator: Optional[torch.Generator] = None):
    layers = []
    c = in_channels
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(c, v, 3, padding=1, generator=generator))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v))
            layers.append(nn.ReLU())
            c = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    def __init__(self, features, num_classes=1000, dropout=0.5, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.features = features
        self.num_classes = num_classes
        self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096, generator=g), nn.ReLU(),
                nn.Dropout(dropout),
                nn.Linear(4096, 4096, generator=g), nn.ReLU(),
                nn.Dropout(dropout),
                nn.Linear(4096, num_classes, generator=g))
        self.to(resolve_device(device))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(ops.flatten(x, 1, -1))
        return x


def _vgg(cfg, batch_norm, generator=None, **kw):
    return VGG(make_layers(_CFGS[cfg], batch_norm, generator=generator),
               generator=generator, **kw)


def vgg11(batch_norm=False, **kw):
    return _vgg("A", batch_norm, **kw)


def vgg13(batch_norm=False, **kw):
    return _vgg("B", batch_norm, **kw)


def vgg16(batch_norm=False, **kw):
    return _vgg("D", batch_norm, **kw)


def vgg19(batch_norm=False, **kw):
    return _vgg("E", batch_norm, **kw)
