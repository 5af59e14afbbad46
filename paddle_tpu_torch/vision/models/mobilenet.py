"""MobileNet V1 / V2 (counterpart of paddle_tpu/vision/models/
mobilenet.py; ref python/paddle/vision/models/mobilenetv1.py /
mobilenetv2.py).  The depthwise convolutions are grouped convolutions with
groups = input channels, through cuDNN."""
from __future__ import annotations

from typing import Optional

import torch

from ... import nn, ops
from ...core.device import resolve_device
from ...nn import functional as F


class ConvBNLayer(nn.Layer):
    def __init__(self, cin, cout, k, stride=1, padding=0, groups=1,
                 act="relu", *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.Conv2D(cin, cout, k, stride=stride, padding=padding,
                              groups=groups, bias_attr=False,
                              generator=generator)
        self.bn = nn.BatchNorm2D(cout)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        if self.act == "relu":
            x = F.relu(x)
        elif self.act == "relu6":
            x = F.relu6(x)
        return x


class DepthwiseSeparable(nn.Layer):
    """ref mobilenetv1.py DepthwiseSeparable: depthwise 3x3 + pointwise
    1x1."""

    def __init__(self, cin, cout1, cout2, stride, scale=1.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c1, c2 = int(cout1 * scale), int(cout2 * scale)
        self.dw = ConvBNLayer(cin, c1, 3, stride=stride, padding=1,
                              groups=cin, generator=generator)
        self.pw = ConvBNLayer(c1, c2, 1, generator=generator)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    """ref mobilenetv1.py MobileNetV1."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool

        def s(c):
            return int(c * scale)

        self.conv1 = ConvBNLayer(3, s(32), 3, stride=2, padding=1,
                                 generator=g)
        cfg = [  # (cin, c1, c2, stride)
            (s(32), 32, 64, 1), (s(64), 64, 128, 2), (s(128), 128, 128, 1),
            (s(128), 128, 256, 2), (s(256), 256, 256, 1),
            (s(256), 256, 512, 2),
            (s(512), 512, 512, 1), (s(512), 512, 512, 1),
            (s(512), 512, 512, 1), (s(512), 512, 512, 1),
            (s(512), 512, 512, 1),
            (s(512), 512, 1024, 2), (s(1024), 1024, 1024, 1),
        ]
        self.blocks = nn.Sequential(*[
            DepthwiseSeparable(cin, c1, c2, st, scale, generator=g)
            for cin, c1, c2, st in cfg])
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(s(1024), num_classes, generator=g)
        self.to(resolve_device(device))

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(ops.flatten(x, 1, -1))
        return x


class InvertedResidual(nn.Layer):
    """ref mobilenetv2.py InvertedResidualUnit."""

    def __init__(self, cin, cout, stride, expand_ratio, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        hidden = int(round(cin * expand_ratio))
        self.use_res = stride == 1 and cin == cout
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(cin, hidden, 1, act="relu6",
                                      generator=g))
        layers += [
            ConvBNLayer(hidden, hidden, 3, stride=stride, padding=1,
                        groups=hidden, act="relu6", generator=g),
            ConvBNLayer(hidden, cout, 1, act=None, generator=g),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    """ref mobilenetv2.py MobileNetV2."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [  # t, c, n, s
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        cin = int(32 * scale)
        features = [ConvBNLayer(3, cin, 3, stride=2, padding=1, act="relu6",
                                generator=g)]
        for t, c, n, s in cfg:
            cout = int(c * scale)
            for i in range(n):
                features.append(InvertedResidual(cin, cout,
                                                 s if i == 0 else 1, t,
                                                 generator=g))
                cin = cout
        self.last_c = int(1280 * max(1.0, scale))
        features.append(ConvBNLayer(cin, self.last_c, 1, act="relu6",
                                    generator=g))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2),
                nn.Linear(self.last_c, num_classes, generator=g))
        self.to(resolve_device(device))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(ops.flatten(x, 1, -1))
        return x


def mobilenet_v1(scale=1.0, **kw):
    return MobileNetV1(scale=scale, **kw)


def mobilenet_v2(scale=1.0, **kw):
    return MobileNetV2(scale=scale, **kw)
