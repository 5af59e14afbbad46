"""Transformer encoder layers (counterpart of
paddle_tpu/nn/layer/transformer.py).

Attention feeds the projection outputs in (batch, seq, heads*head_dim)
layout straight to the packed flash-attention kernel.  Where the packed
kernel refuses the head layout (an odd count of 64-wide heads, heads of 192
or 256), and on the cache and explicit-weights paths, the split-head
``_attend`` takes over: it views the projections as (batch, heads, seq,
head_dim), a transpose of strides that the (b, h, s, d) kernel reads in
place, and runs ``ops.attention.flash_attention`` (that kernel where its
gates hold, else the plain reference), or the explicit softmax when
``need_weights``.  The post-LN sublayer tail
``LN(residual + dropout(out))`` goes to the fused residual + LayerNorm
kernel, in the encoder and the decoder alike.  ``TransformerEncoder``
with ``enable_recompute`` runs each layer under ``autograd.recompute`` in
training (the layer's forward, kernels included, runs again inside the
backward, with the same dropout draws).  Parameters are built on the CPU
from ``generator`` (keyword-only; torch's default generator when None);
the caller moves the model to its device.
"""
from __future__ import annotations

import collections
import copy
import math
from typing import Optional

import torch

from ...core import flags
from ...core.device import resolve_device
from ...core import random as _random
from ...ops import attention as attn_ops
from ...ops.kernels import layer_norm as _fln
from .. import functional as F
from .base import Layer, LayerList
from .common import Dropout, Linear
from .norm import LayerNorm


class MultiHeadAttention(Layer):
    """q/k/v/out projections around scaled-dot-product attention: self or
    cross attention (``kdim`` / ``vdim`` size the key and value inputs),
    the attention weights returned beside the output (``need_weights``),
    and an incremental-decode ``Cache`` (keys and values appended step by
    step) or ``StaticCache`` (keys and values computed once)."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} not divisible by "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        attrs = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                     generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **attrs)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, **attrs)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, **attrs)
        self.out_proj = Linear(embed_dim, embed_dim, **attrs)
        # sequence parallelism: the mesh dim splitting the sequence, or
        # None (set by text.pretrainer; attention then goes through
        # Ulysses, parallel/ring_attention.py)
        self.seq_axis = None

    def _split_heads(self, x, heads=None):
        b, s, _ = x.shape
        return x.reshape(b, s, heads or self.num_heads,
                         self.head_dim).transpose(1, 2)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        if cache is None and not self.need_weights:
            qp = self.q_proj(query)
            kp = self.k_proj(key)
            vp = self.v_proj(value)
            heads = self.num_heads
            if self.seq_axis is not None:
                from ...parallel import ring_attention as _ring
                from ...parallel.mesh import mesh_axis_size

                qp, kp, vp = (_ring.ulysses_to_heads(t, self.seq_axis)
                              for t in (qp, kp, vp))
                heads //= mesh_axis_size(self.seq_axis)
            out = attn_ops.flash_attention_packed(
                qp, kp, vp, heads, attn_mask=attn_mask,
                dropout_p=self.dropout, training=self.training)
            if out is None:
                out = attn_ops.flash_attention(
                    self._split_heads(qp, heads), self._split_heads(kp, heads),
                    self._split_heads(vp, heads), attn_mask=attn_mask,
                    dropout_p=self.dropout, training=self.training)
                b, h, s_, d = out.shape
                out = out.transpose(1, 2).reshape(b, s_, h * d)
            if self.seq_axis is not None:
                out = _ring.ulysses_to_seq(out, self.seq_axis)
            return self.out_proj(out)
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, MultiHeadAttention.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, MultiHeadAttention.Cache):
                k = torch.cat([cache.k, k], dim=2)
                v = torch.cat([cache.v, v], dim=2)
                cache = MultiHeadAttention.Cache(k, v)
        return self._attend(q, k, v, attn_mask, cache)

    def _attend(self, q, k, v, attn_mask, cache):
        """Split-head attention on (b, h, s, d): ``out``, then the weights
        (``need_weights``) and the grown ``Cache``, as a tuple when there
        is more than ``out``."""
        weights = None
        if self.need_weights:
            # explicit weights (the flash kernel never materialises them)
            s_ = torch.matmul(q, k.transpose(-1, -2)).float()
            s_ = s_ / math.sqrt(self.head_dim)
            if attn_mask is not None:
                s_ = (s_.masked_fill(~attn_mask, -1e30)
                      if attn_mask.dtype == torch.bool
                      else s_ + attn_mask.float())
            weights = torch.exp(s_ - s_.amax(dim=-1, keepdim=True))
            weights = (weights / weights.sum(dim=-1, keepdim=True)).to(q.dtype)
            p = weights
            if self.dropout > 0.0 and self.training:
                p = F.dropout(weights, p=self.dropout, training=True)
            out = torch.matmul(p, v)
        else:
            out = attn_ops.flash_attention(q, k, v, attn_mask=attn_mask,
                                           dropout_p=self.dropout,
                                           training=self.training)
        b, h, s, d = out.shape
        out = self.out_proj(out.transpose(1, 2).reshape(b, s, h * d))
        outs = (out,)
        if self.need_weights:
            outs += (weights,)
        if isinstance(cache, MultiHeadAttention.Cache):
            outs += (cache,)
        return outs if len(outs) > 1 else out

    def gen_cache(self, key, value=None, type=None):
        """``StaticCache`` of the projected keys and values (``type`` =
        ``MultiHeadAttention.StaticCache``), else an empty ``Cache``."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(
                value if value is not None else key))
            return MultiHeadAttention.StaticCache(k, v)
        k = torch.zeros((key.shape[0], self.num_heads, 0, self.head_dim),
                        dtype=key.dtype, device=key.device)
        return MultiHeadAttention.Cache(k, k)


def _sublayer_epilogue(layer, out, residual, norm, dropout_layer):
    """src = norm(residual + dropout(out)), the post-LN sublayer tail.  With
    ``use_fused_layer_norm`` on, post-LN goes to kernel C (its plain version
    on CPU tensors), the dropout inside it seeded by one host draw;
    otherwise the composition runs."""
    rate = float(dropout_layer.p) if layer.training else 0.0
    if (not layer.normalize_before
            and norm.weight is not None and norm.bias is not None
            and flags.get_flag("use_fused_layer_norm")
            and len(norm.normalized_shape) == 1):
        seed = _random.draw_seed() if rate > 0.0 else None
        return _fln.fused_residual_dropout_layer_norm(
            out, residual, norm.weight, norm.bias, dropout_rate=rate,
            seed=seed, epsilon=norm.epsilon)
    src = residual + dropout_layer(out)
    if not layer.normalize_before:
        src = norm(src)
    return src


class TransformerEncoderLayer(Layer):
    """Self attention + FFN; ``normalize_before`` toggles pre-/post-LN."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.normalize_before = normalize_before
        attrs = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                     generator=generator)
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            dropout=attn_dropout if attn_dropout is not None else dropout,
            **attrs)
        self.linear1 = Linear(d_model, dim_feedforward, **attrs)
        self.linear2 = Linear(dim_feedforward, d_model, **attrs)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout if act_dropout is not None
                                   else dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        """``src`` after the layer; with a ``cache`` (an attention
        ``Cache``), ``(src, grown cache)``."""
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            out = self.self_attn(src, src, src, attn_mask=src_mask)
        else:
            out, cache = self.self_attn(src, src, src, attn_mask=src_mask,
                                        cache=cache)
        src = _sublayer_epilogue(self, out, residual, self.norm1,
                                 self.dropout1)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(
            self.linear1(src))))
        src = _sublayer_epilogue(self, src, residual, self.norm2,
                                 self.dropout2)
        return src if cache is None else (src, cache)


def _clones(layer, num_layers, generator):
    """``layer`` and ``num_layers - 1`` deep copies of it, each copy's
    parameters drawn anew (``_reinit``)."""
    layers = [layer]
    for _ in range(num_layers - 1):
        clone = copy.deepcopy(layer)
        _reinit(clone, generator)
        layers.append(clone)
    return LayerList(layers)


class TransformerEncoder(Layer):
    """``num_layers`` copies of ``encoder_layer``, the copies' parameters
    drawn anew.  ``enable_recompute`` recomputes each layer's activations
    in the backward (training mode, no cache), under ``recompute_policy``
    (``autograd.checkpoint_policy``'s names)."""

    def __init__(self, encoder_layer, num_layers, norm=None,
                 enable_recompute=False, recompute_policy=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = _clones(encoder_layer, num_layers, generator)
        self.num_layers = num_layers
        self.norm = norm
        self.enable_recompute = enable_recompute
        self.recompute_policy = recompute_policy

    def forward(self, src, src_mask=None, cache=None):
        """The stack's output; with ``cache`` (one attention ``Cache`` per
        layer, as ``gen_cache`` makes), ``(output, grown caches)``."""
        output = src
        new_caches = []
        remat = self.enable_recompute and self.training and cache is None
        for i, layer in enumerate(self.layers):
            if cache is None:
                if remat:
                    output = self._recompute_layer(layer, output, src_mask)
                else:
                    output = layer(output, src_mask=src_mask)
            else:
                output, c = layer(output, src_mask=src_mask, cache=cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        """One empty attention ``Cache`` per layer."""
        return [layer.self_attn.gen_cache(src) for layer in self.layers]

    def _recompute_layer(self, layer, x, mask):
        """``layer(x, src_mask=mask)`` under ``autograd.recompute``.  The
        replay runs in the backward, after a ``functional_call`` that bound
        other tensors to the parameters (a train step's compute-dtype casts)
        has restored the module's own: so the tensors bound now go in as
        inputs, and the function binds them again each time it runs."""
        from ...autograd import recompute

        names, tensors = zip(*layer.named_parameters())

        def run(x, m, *bound):
            return torch.func.functional_call(
                layer, dict(zip(names, bound)), (x,), {"src_mask": m})

        return recompute(run, x, mask, *tensors,
                         policy=self.recompute_policy)


class TransformerDecoderLayer(Layer):
    """Self attention + cross attention over ``memory`` + FFN;
    ``normalize_before`` toggles pre-/post-LN.  A ``cache`` is the pair
    (self-attention ``Cache``, cross-attention ``StaticCache`` or None)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.normalize_before = normalize_before
        ad = attn_dropout if attn_dropout is not None else dropout
        attrs = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                     generator=generator)
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=ad,
                                            **attrs)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout=ad,
                                             **attrs)
        self.linear1 = Linear(d_model, dim_feedforward, **attrs)
        self.linear2 = Linear(dim_feedforward, d_model, **attrs)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout if act_dropout is not None
                                   else dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            out = self.self_attn(tgt, tgt, tgt, attn_mask=tgt_mask)
        else:
            out, sc = self.self_attn(tgt, tgt, tgt, attn_mask=tgt_mask,
                                     cache=cache[0])
        tgt = _sublayer_epilogue(self, out, residual, self.norm1,
                                 self.dropout1)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        static = (cache[1] if cache is not None and isinstance(
            cache[1], MultiHeadAttention.StaticCache) else None)
        out = self.cross_attn(tgt, memory, memory, attn_mask=memory_mask,
                              cache=static)
        tgt = _sublayer_epilogue(self, out, residual, self.norm2,
                                 self.dropout2)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.act_dropout(self.activation(
            self.linear1(tgt))))
        tgt = _sublayer_epilogue(self, tgt, residual, self.norm3,
                                 self.dropout3)
        return tgt if cache is None else (tgt, (sc, cache[1]))


class TransformerDecoder(Layer):
    """``num_layers`` copies of ``decoder_layer``, the copies' parameters
    drawn anew."""

    def __init__(self, decoder_layer, num_layers, norm=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = _clones(decoder_layer, num_layers, generator)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        """The stack's output; with ``cache`` (one layer cache each, as
        ``gen_cache`` makes), ``(output, grown caches)``."""
        output = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, memory, tgt_mask=tgt_mask,
                               memory_mask=memory_mask)
            else:
                output, c = layer(output, memory, tgt_mask=tgt_mask,
                                  memory_mask=memory_mask, cache=cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)


class Transformer(Layer):
    """Encoder-decoder (Vaswani et al. 2017; the reference's defaults are
    Transformer-base): ``forward(src, tgt)`` returns the decoder's output
    over the encoded ``src``.  Built on the CPU from ``generator``."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, generator=generator),
                num_encoder_layers,
                LayerNorm(d_model) if normalize_before else None,
                generator=generator)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, generator=generator),
                num_decoder_layers,
                LayerNorm(d_model) if normalize_before else None,
                generator=generator)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, *, device=None):
        """Additive fp32 causal mask (length, length): 0 on and below the
        diagonal, -1e9 above, on ``device`` (default CUDA)."""
        dev = resolve_device(device)
        keep = torch.ones((length, length), dtype=torch.bool,
                          device=dev).tril()
        return torch.where(keep, 0.0, -1e9).to(torch.float32)


def _reinit(layer, generator=None):
    """Draw a deep-copied layer tree's parameters anew from each one's
    recorded initializer (so a ``weight_attr``'s distribution holds across
    the cloned stack); a parameter with none and two or more dimensions
    takes XavierUniform, as in the JAX package."""
    from .. import initializer as init

    with torch.no_grad():
        for m in layer.modules():
            for p in m.parameters(recurse=False):
                ini = getattr(p, "initializer", None)
                if ini is None and p.dim() >= 2:
                    ini = init.XavierUniform()
                if ini is not None:
                    p.copy_(ini(tuple(p.shape), p.dtype, generator=generator))
