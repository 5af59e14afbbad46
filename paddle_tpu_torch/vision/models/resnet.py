"""ResNet family (counterpart of paddle_tpu/vision/models/resnet.py; ref
python/paddle/vision/models/resnet.py:168, PaddleClas's ResNet-50).

``data_format`` is NCHW (the reference's default) or NHWC: in NHWC the
convolutions and pools take channels-last views of the (N, H, W, C)
activations (``F.conv2d``, ``F.max_pool2d``), with no layout copy between
layers.  Parameters keep the reference's OIHW layout either way, so one
set of weights serves both.  BasicBlock for 18 / 34, BottleneckBlock for
50 / 101 / 152.
"""
from __future__ import annotations

from typing import Optional

import torch

from ... import nn, ops
from ...core.device import resolve_device


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 data_format="NCHW", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, df = generator, data_format
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, data_format=df, generator=g)
        self.bn1 = nn.BatchNorm2D(planes, data_format=df)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               data_format=df, generator=g)
        self.bn2 = nn.BatchNorm2D(planes, data_format=df)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 data_format="NCHW", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, df = generator, data_format
        self.conv1 = nn.Conv2D(inplanes, planes, 1, bias_attr=False,
                               data_format=df, generator=g)
        self.bn1 = nn.BatchNorm2D(planes, data_format=df)
        self.conv2 = nn.Conv2D(planes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, data_format=df, generator=g)
        self.bn2 = nn.BatchNorm2D(planes, data_format=df)
        self.conv3 = nn.Conv2D(planes, planes * self.expansion, 1,
                               bias_attr=False, data_format=df, generator=g)
        self.bn3 = nn.BatchNorm2D(planes * self.expansion, data_format=df)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    """ref resnet.py ResNet(Layer): depth in {18, 34, 50, 101, 152}."""

    _cfg = {18: (BasicBlock, (2, 2, 2, 2)),
            34: (BasicBlock, (3, 4, 6, 3)),
            50: (BottleneckBlock, (3, 4, 6, 3)),
            101: (BottleneckBlock, (3, 4, 23, 3)),
            152: (BottleneckBlock, (3, 8, 36, 3))}

    def __init__(self, depth=50, num_classes=1000, with_pool=True,
                 in_channels=3, data_format="NCHW", *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        block, layers = self._cfg[depth]
        g, df = generator, data_format
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.data_format = data_format
        self.conv1 = nn.Conv2D(in_channels, 64, 7, stride=2, padding=3,
                               bias_attr=False, data_format=df, generator=g)
        self.bn1 = nn.BatchNorm2D(64, data_format=df)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1, data_format=df)
        self.layer1 = self._make_layer(block, 64, layers[0], generator=g)
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2,
                                       generator=g)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2,
                                       generator=g)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2,
                                       generator=g)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1), data_format=df)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes,
                                generator=g)
        self.to(resolve_device(device))

    def _make_layer(self, block, planes, blocks, stride=1, *,
                    generator=None):
        g, df = generator, self.data_format
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False, data_format=df,
                          generator=g),
                nn.BatchNorm2D(planes * block.expansion, data_format=df))
        layers = [block(self.inplanes, planes, stride, downsample,
                        data_format=df, generator=g)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, data_format=df,
                                generator=g))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(ops.flatten(x, 1, -1))
        return x


def resnet18(**kw):
    return ResNet(18, **kw)


def resnet34(**kw):
    return ResNet(34, **kw)


def resnet50(**kw):
    return ResNet(50, **kw)


def resnet101(**kw):
    return ResNet(101, **kw)


def resnet152(**kw):
    return ResNet(152, **kw)
