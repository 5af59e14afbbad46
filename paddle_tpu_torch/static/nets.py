"""Composite network helpers (ref python/paddle/fluid/nets.py:
simple_img_conv_pool, img_conv_group, glu, sequence_conv_pool,
scaled_dot_product_attention) built from the layers DSL (counterpart of
paddle_tpu/static/nets.py, pure Python, copied)."""
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


def glu(input, dim=-1):
    """ref nets.py glu — gated linear unit: a * sigmoid(b)."""
    a, b = L.split(input, 2, dim=dim)
    return L.elementwise_mul(a, L.sigmoid(b))


def sequence_conv_pool(input, num_filters, filter_size, sequence_length,
                       param_attr=None, act="sigmoid", pool_type="max"):
    """ref nets.py sequence_conv_pool — sequence_conv + sequence_pool (the
    text-CNN building block of the understand_sentiment book model)."""
    conv = L.sequence_conv(input, num_filters, filter_size=filter_size,
                           sequence_length=sequence_length,
                           param_attr=param_attr, act=act)
    return L.sequence_pool(conv, pool_type, sequence_length)


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """ref nets.py scaled_dot_product_attention — multi-head attention from
    DSL primitives (batch, seq, dim inputs; single-head when num_heads=1).
    Returns the context tensor (batch, seq_q, dim_v)."""
    if keys.shape[-1] % num_heads or queries.shape[-1] % num_heads \
            or values.shape[-1] % num_heads:
        raise ValueError(
            f"scaled_dot_product_attention: hidden dims "
            f"(q {queries.shape[-1]}, k {keys.shape[-1]}, "
            f"v {values.shape[-1]}) must divide num_heads={num_heads}")
    d_k = keys.shape[-1] // num_heads
    if num_heads > 1:
        def split(x):
            b, s, dim = x.shape
            r = L.reshape(x, (-1, s, num_heads, dim // num_heads))
            return L.transpose(r, [0, 2, 1, 3])

        q, k, v = split(queries), split(keys), split(values)
    else:
        q, k, v = queries, keys, values
    scores = L.matmul(q, k, transpose_y=True, alpha=1.0 / (d_k ** 0.5))
    weights = L.softmax(scores)
    if dropout_rate > 0.0:
        weights = L.dropout(weights, dropout_prob=dropout_rate)
    ctx = L.matmul(weights, v)
    if num_heads > 1:
        # use the STATIC seq/dim from the declared inputs: matmul shape
        # inference propagates -1 batch dims and reshape allows one -1 only
        seq_q = queries.shape[1]
        dim_v = values.shape[-1]
        ctx = L.reshape(L.transpose(ctx, [0, 2, 1, 3]), (-1, seq_q, dim_v))
    return ctx
