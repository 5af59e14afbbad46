"""LeNet (counterpart of paddle_tpu/vision/models/lenet.py; ref
python/paddle/vision/models/lenet.py)."""
from __future__ import annotations

from typing import Optional

import torch

from ... import nn, ops
from ...core.device import resolve_device


class LeNet(nn.Layer):
    def __init__(self, num_classes=10, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1, generator=g),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0, generator=g),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120, generator=g),
                nn.Linear(120, 84, generator=g),
                nn.Linear(84, num_classes, generator=g),
            )
        self.to(resolve_device(device))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(ops.flatten(x, 1, -1))
        return x
