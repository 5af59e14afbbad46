"""Composite network helpers (counterpart of paddle_tpu/static/nets.py;
ref python/paddle/fluid/nets.py: simple_img_conv_pool, img_conv_group)
built from the layers DSL."""
from __future__ import annotations

from . import layers as L


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         act=None, param_attr=None, bias_attr=None):
    """ref nets.py simple_img_conv_pool — conv2d + pool2d."""
    conv = L.conv2d(input, num_filters, filter_size, padding=0,
                    param_attr=param_attr, bias_attr=bias_attr, act=act)
    return L.pool2d(conv, pool_size, pool_type=pool_type,
                    pool_stride=pool_stride, pool_padding=pool_padding)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act="relu",
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max"):
    """ref nets.py img_conv_group — N conv(+bn+dropout) layers then a pool
    (the VGG building block of the image_classification book model)."""
    n = len(conv_num_filter)

    def _broadcast(v):
        return list(v) if isinstance(v, (list, tuple)) else [v] * n

    filters = list(conv_num_filter)
    paddings = _broadcast(conv_padding)
    sizes = _broadcast(conv_filter_size)
    with_bn = _broadcast(conv_with_batchnorm)
    drops = _broadcast(conv_batchnorm_drop_rate)

    tmp = input
    for i in range(n):
        tmp = L.conv2d(tmp, filters[i], sizes[i], padding=paddings[i],
                       act=None if with_bn[i] else conv_act)
        if with_bn[i]:
            tmp = L.batch_norm(tmp, act=conv_act)
            if drops[i] > 0:
                tmp = L.dropout(tmp, dropout_prob=drops[i])
    return L.pool2d(tmp, pool_size, pool_type=pool_type,
                    pool_stride=pool_stride)
