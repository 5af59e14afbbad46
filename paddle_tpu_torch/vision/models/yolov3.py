"""YOLOv3 with the DarkNet-53 backbone (counterpart of paddle_tpu/vision/
models/yolov3.py; PaddleDetection's YOLOv3 on operators/detection/
yolo_box_op.cc and yolov3_loss_op.cc through ``ops.vision``).

A fixed input resolution (416 by default) fixes every head's shape; the
training loss and the inference decode are functions of the three heads.
NCHW, as the rest of the zoo's detectors.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ... import nn
from ...core.device import resolve_device
from ...nn import functional as F
from ...ops import vision as V

__all__ = ["DarkNet53", "YOLOv3", "yolov3_darknet53"]

# the canonical YOLOv3 anchor set (COCO), pixels at the input resolution
DEFAULT_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45,
                   59, 119, 116, 90, 156, 198, 373, 326]
DEFAULT_ANCHOR_MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]


class ConvBNLayer(nn.Layer):
    def __init__(self, in_ch, out_ch, k=3, stride=1, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.Conv2D(in_ch, out_ch, k, stride=stride,
                              padding=(k - 1) // 2, bias_attr=False,
                              generator=generator)
        self.bn = nn.BatchNorm2D(out_ch)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.conv(x)), 0.1)


class DarkBlock(nn.Layer):
    """1x1 squeeze + 3x3 expand residual block."""

    def __init__(self, ch, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = ConvBNLayer(ch, ch // 2, k=1, generator=generator)
        self.conv2 = ConvBNLayer(ch // 2, ch, k=3, generator=generator)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class DarkNet53(nn.Layer):
    """The backbone; returns C3, C4, C5 (strides 8 / 16 / 32)."""

    def __init__(self, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.stem = ConvBNLayer(3, 32, k=3, generator=g)
        self.stages = nn.LayerList()
        chans = [(32, 64, 1), (64, 128, 2), (128, 256, 8),
                 (256, 512, 8), (512, 1024, 4)]
        for in_ch, out_ch, blocks in chans:
            self.stages.append(nn.Sequential(
                ConvBNLayer(in_ch, out_ch, k=3, stride=2, generator=g),
                *[DarkBlock(out_ch, generator=g) for _ in range(blocks)]))

    def forward(self, x) -> List:
        x = self.stem(x)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return feats[2:]  # C3 (256, /8), C4 (512, /16), C5 (1024, /32)


class YoloDetectionBlock(nn.Layer):
    """The neck's 5-conv tower giving (route, tip)."""

    def __init__(self, in_ch, ch, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.conv0 = ConvBNLayer(in_ch, ch, k=1, generator=g)
        self.conv1 = ConvBNLayer(ch, ch * 2, k=3, generator=g)
        self.conv2 = ConvBNLayer(ch * 2, ch, k=1, generator=g)
        self.conv3 = ConvBNLayer(ch, ch * 2, k=3, generator=g)
        self.route = ConvBNLayer(ch * 2, ch, k=1, generator=g)
        self.tip = ConvBNLayer(ch, ch * 2, k=3, generator=g)

    def forward(self, x):
        x = self.conv3(self.conv2(self.conv1(self.conv0(x))))
        route = self.route(x)
        return route, self.tip(route)


class YOLOv3(nn.Layer):
    """The detector: backbone, FPN-style neck, 3 heads.

    ``forward(images)`` returns the 3 raw head tensors (strides 32, 16, 8);
    ``loss(heads, gt_box, gt_label)`` and ``predict(heads, img_size)`` wrap
    ``yolo_loss`` and ``yolo_box`` + ``multiclass_nms``.
    """

    def __init__(self, num_classes: int = 80,
                 anchors: Sequence[int] = DEFAULT_ANCHORS,
                 anchor_masks: Sequence[Sequence[int]] = DEFAULT_ANCHOR_MASKS,
                 ignore_thresh: float = 0.7, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.num_classes = num_classes
        self.anchors = list(anchors)
        self.anchor_masks = [list(m) for m in anchor_masks]
        self.ignore_thresh = ignore_thresh
        self.backbone = DarkNet53(generator=g)
        self.blocks = nn.LayerList()
        self.heads = nn.LayerList()
        self.routes = nn.LayerList()
        out_per_anchor = 5 + num_classes
        in_chs = [1024, 768, 384]  # C5; C4 + route; C3 + route
        chs = [512, 256, 128]
        for i, (ic, ch, m) in enumerate(zip(in_chs, chs, self.anchor_masks)):
            self.blocks.append(YoloDetectionBlock(ic, ch, generator=g))
            self.heads.append(nn.Conv2D(ch * 2, len(m) * out_per_anchor, 1,
                                        generator=g))
            if i < 2:
                self.routes.append(ConvBNLayer(ch, ch // 2, k=1,
                                               generator=g))
        self.to(resolve_device(device))

    def forward(self, x):
        c3, c4, c5 = self.backbone(x)
        outs = []
        feat = c5
        for i, skip in enumerate([None, c4, c3]):
            if skip is not None:
                feat = torch.cat([feat, skip], dim=1)
            route, tip = self.blocks[i](feat)
            outs.append(self.heads[i](tip))
            if i < 2:
                feat = F.interpolate(self.routes[i](route), scale_factor=2,
                                     mode="nearest")
        return outs  # strides 32, 16, 8

    def loss(self, heads, gt_box, gt_label, gt_score=None):
        """The three heads' ``yolo_loss`` summed; the mean over the
        batch."""
        total = 0.0
        for out, m, ds in zip(heads, self.anchor_masks, (32, 16, 8)):
            total = total + V.yolo_loss(
                out, gt_box, gt_label, anchors=self.anchors, anchor_mask=m,
                class_num=self.num_classes, ignore_thresh=self.ignore_thresh,
                downsample_ratio=ds, gt_score=gt_score)
        return total.mean()

    def predict(self, heads, img_size, conf_thresh: float = 0.01,
                nms_threshold: float = 0.45, keep_top_k: int = 100):
        """Decode + per-class NMS, every image in one batched NMS.
        img_size: [N, 2] (h, w).  Returns (dets [N, keep_top_k, 6],
        num_valid [N])."""
        boxes_all, scores_all = [], []
        for out, m, ds in zip(heads, self.anchor_masks, (32, 16, 8)):
            anc = []
            for idx in m:
                anc += self.anchors[2 * idx:2 * idx + 2]
            b, s = V.yolo_box(out, img_size, anchors=anc,
                              class_num=self.num_classes,
                              conf_thresh=conf_thresh, downsample_ratio=ds)
            boxes_all.append(b)
            scores_all.append(s)
        boxes = torch.cat(boxes_all, dim=1)                   # [N, M, 4]
        scores = torch.cat(scores_all, dim=1)                 # [N, M, C]
        return V._multiclass_nms(
            boxes, scores.transpose(1, 2), score_threshold=conf_thresh,
            nms_top_k=400, keep_top_k=keep_top_k,
            nms_threshold=nms_threshold, normalized=True,
            background_label=-1)


def yolov3_darknet53(num_classes: int = 80, **kwargs) -> YOLOv3:
    return YOLOv3(num_classes=num_classes, **kwargs)
