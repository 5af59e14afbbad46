"""Static-op long tail, batch 3 (counterpart of
paddle_tpu/static/ops_tail3.py): the contrib / detection stragglers —
``attention_lstm``, ``prroi_pool``, ``tree_conv``, ``filter_by_instag``,
``pyramid_hash``, ``var_conv_2d``, ``bilateral_slice``, the padded
sequence ops ``sequence_reshape`` / ``sequence_scatter``,
``select_input`` / ``select_output``, ``fusion_seqexpand_concat_fc`` and
``chunk_eval``.  Everything is dense: LoD-dependent ops take padded
tensors and length vectors, as every sequence op of the port does."""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from .ops import _one
from .registry import register_op


def _hat_integral(a, b, i):
    """The integral of max(0, 1-|x-i|) over [a, b], closed form (PrRoI's
    bilinear weight)."""
    lo1, hi1 = torch.maximum(a, i - 1.0), torch.minimum(b, i)
    rise = 0.5 * ((hi1 - (i - 1.0)) ** 2 - (lo1 - (i - 1.0)) ** 2)
    rise = torch.where(hi1 - lo1 > 0, rise, torch.zeros_like(rise))
    lo2, hi2 = torch.maximum(a, i), torch.minimum(b, i + 1.0)
    fall = 0.5 * (((i + 1.0) - lo2) ** 2 - ((i + 1.0) - hi2) ** 2)
    fall = torch.where(hi2 - lo2 > 0, fall, torch.zeros_like(fall))
    return rise + fall


@register_op("prroi_pool")
def _prroi_pool(ins, attrs, op):
    """ref prroi_pool_op.h (PrRoI pooling): the exact integral of the
    bilinearly interpolated feature surface over each bin, over the bin's
    area; ``BatchRoINums`` holds per-image RoI counts."""
    x = _one(ins, "X")                       # (N, C, H, W)
    rois = _one(ins, "ROIs").float()         # (R, 4) x1 y1 x2 y2
    counts = _one(ins, "BatchRoINums")
    scale = attrs.get("spatial_scale", 1.0)
    ph, pw = attrs["pooled_height"], attrs["pooled_width"]
    N, C, H, W = x.shape
    R = rois.shape[0]
    dev = x.device
    if counts is None:
        roi_batch = torch.zeros((R,), dtype=torch.long, device=dev)
    else:
        roi_batch = torch.repeat_interleave(
            torch.arange(N, device=dev), counts.reshape(-1).long(),
            output_size=R)
    ii = torch.arange(H, dtype=torch.float32, device=dev)
    jj = torch.arange(W, dtype=torch.float32, device=dev)
    gy = torch.arange(ph, dtype=torch.float32, device=dev)
    gx = torch.arange(pw, dtype=torch.float32, device=dev)
    outs = []
    for r in range(R):
        x1, y1, x2, y2 = (rois[r] * scale).unbind()
        bw = torch.clamp_min((x2 - x1) / pw, 1e-9)
        bh = torch.clamp_min((y2 - y1) / ph, 1e-9)
        wy = _hat_integral((y1 + gy * bh)[:, None],
                           (y1 + (gy + 1) * bh)[:, None], ii[None, :])
        wx = _hat_integral((x1 + gx * bw)[:, None],
                           (x1 + (gx + 1) * bw)[:, None], jj[None, :])
        pooled = torch.einsum("ph,qw,chw->cpq", wy, wx, x[roi_batch[r]])
        outs.append(pooled / (bw * bh))
    return {"Out": [torch.stack(outs)]}


@register_op("filter_by_instag")
def _filter_by_instag(ins, attrs, op):
    """ref filter_by_instag_op.cc, dense: rows whose tags miss the filter
    tags are zeroed; LossWeight is the 0/1 keep mask, IndexMap the
    identity of the kept positions."""
    x = _one(ins, "Ins")          # (B, D)
    tags = _one(ins, "Ins_tag")   # (B, Lt) padded with -1
    ftags = _one(ins, "Filter_tag").reshape(-1)
    keep = ((tags[:, :, None] == ftags[None, None, :])
            & (tags[:, :, None] >= 0)).any(dim=2).any(dim=1)
    w = keep.to(x.dtype)
    idx = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    return {"Out": [x * w[:, None]], "LossWeight": [w[:, None]],
            "IndexMap": [torch.stack([idx, idx], dim=1)]}


@register_op("chunk_eval")
def _chunk_eval(ins, attrs, op):
    """ref metrics chunk_eval_op.h (IOB/IOE/IOBES/plain chunk P/R/F1)."""
    from ..ops.chunking import chunk_eval

    p, r, f1, ni, nl, nc = chunk_eval(
        _one(ins, "Inference"), _one(ins, "Label"), _one(ins, "SeqLength"),
        chunk_scheme=attrs.get("chunk_scheme", "IOB"),
        num_chunk_types=attrs.get("num_chunk_types", 1),
        excluded_chunk_types=attrs.get("excluded_chunk_types"))
    return {"Precision": [p], "Recall": [r], "F1-Score": [f1],
            "NumInferChunks": [ni], "NumLabelChunks": [nl],
            "NumCorrectChunks": [nc]}


@register_op("attention_lstm")
def _attention_lstm(ins, attrs, op):
    """ref attention_lstm_op.cc: per step, attention over the whole input
    sequence conditioned on the previous cell state pools x into one LSTM
    input; then an LSTM step.  X (B, T, M) + optional Mask (B, T);
    LSTMWeight ((M+D), 4D); AttentionWeight ((M+D), 1)."""
    x = _one(ins, "X")
    mask = _one(ins, "Mask")
    att_w, att_b = _one(ins, "AttentionWeight"), _one(ins, "AttentionBias")
    att_scalar = _one(ins, "AttentionScalar")
    att_scalar_b = _one(ins, "AttentionScalarBias")
    lstm_w, lstm_b = _one(ins, "LSTMWeight"), _one(ins, "LSTMBias")
    B, T, M = x.shape
    D = lstm_w.shape[1] // 4
    h, c = _one(ins, "H0"), _one(ins, "C0")
    if h is None:
        h = x.new_zeros((B, D))
    if c is None:
        c = x.new_zeros((B, D))
    m = mask if mask is not None else x.new_ones((B, T))
    neg_inf = torch.tensor(-1e30, dtype=x.dtype, device=x.device)
    hs, cs = [], []
    for _ in range(T):
        cat = torch.cat([x, c[:, None, :].expand(B, T, D)], dim=-1)
        fc = torch.einsum("btk,ko->bto", cat, att_w)[..., 0]
        if att_b is not None:
            fc = fc + att_b[0]
        fc = torch.relu(fc)
        if att_scalar is not None:
            fc = fc * att_scalar[0]
            if att_scalar_b is not None:
                fc = torch.relu(fc + att_scalar_b[0])
        fc = torch.where(m > 0, fc, neg_inf)
        attn = torch.softmax(fc, dim=-1)                   # (B, T)
        lstm_x = torch.einsum("bt,btm->bm", attn, x)       # (B, M)
        gates = torch.cat([lstm_x, h], dim=-1) @ lstm_w + lstm_b
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    return {"Hidden": [torch.stack(hs, 1)], "Cell": [torch.stack(cs, 1)]}


@register_op("tree_conv")
def _tree_conv(ins, attrs, op):
    """ref tree_conv_op.cc + math/tree2col.h (TBCNN): each root's patch is
    its descendants within max_depth, each node weighted by eta_t / eta_l
    / eta_r (continuous binary tree); the weights depend only on (depth,
    child index, sibling count), so the op is max_depth adjacency-power
    products.  NodesVector (B, N, F); EdgeSet (B, E, 2) parent->child
    pairs, -1-padded; Filter (F, 3, out, num_filters)."""
    nodes = _one(ins, "NodesVector").float()
    edges = _one(ins, "EdgeSet").long()
    filt = _one(ins, "Filter")
    max_depth = attrs.get("max_depth", 2)
    B, N, _F = nodes.shape
    dev = nodes.device
    outs = []
    for bi in range(B):
        x, es = nodes[bi], edges[bi]
        valid = (es[:, 0] >= 0) & (es[:, 1] >= 0)
        parent = torch.where(valid, es[:, 0], torch.full_like(es[:, 0], N))
        child = torch.where(valid, es[:, 1], torch.full_like(es[:, 1], N))
        adj = torch.zeros((N + 1, N + 1), device=dev)
        adj[parent, child] = 1.0
        adj = adj[:N, :N]
        same_parent = ((parent[:, None] == parent[None, :])
                       & valid[None, :] & valid[:, None])
        earlier = torch.tril(torch.ones_like(same_parent), diagonal=-1)
        rank = (same_parent & earlier).sum(1) + 1
        pclen_edge = same_parent.sum(1)
        idx_node = torch.zeros((N + 1,), device=dev)
        idx_node[child] = rank.float()
        pclen_node = torch.ones((N + 1,), device=dev)
        pclen_node[child] = pclen_edge.clamp_min(1).float()
        idx_node, pclen_node = idx_node[:N], pclen_node[:N]
        fd = float(max_depth)
        out = torch.zeros((N, filt.shape[2], filt.shape[3]), device=dev)
        reach = torch.eye(N, device=dev)
        for d in range(max_depth):
            if d == 0:
                idx_d = torch.ones((N,), device=dev)
                pclen_d = torch.ones((N,), device=dev)
            else:
                idx_d, pclen_d = idx_node, pclen_node
            eta_t = (fd - d) / fd
            temp = torch.where(pclen_d == 1, torch.full_like(idx_d, 0.5),
                               (idx_d - 1.0) / (pclen_d - 1.0).clamp_min(1))
            eta_l = (1.0 - eta_t) * temp
            eta_r = (1.0 - eta_t) * (1.0 - eta_l)
            contrib = (
                eta_t * torch.einsum("nf,fok->nok", x, filt[:, 0])
                + eta_l[:, None, None] * torch.einsum("nf,fok->nok", x,
                                                      filt[:, 1])
                + eta_r[:, None, None] * torch.einsum("nf,fok->nok", x,
                                                      filt[:, 2]))
            out = out + torch.einsum("rv,vok->rok", reach, contrib)
            reach = reach @ adj
        outs.append(out)
    return {"Out": [torch.stack(outs)]}


_FNV_PRIME = 16777619
_U32 = 0xFFFFFFFF


@register_op("pyramid_hash")
def _pyramid_hash(ins, attrs, op):
    """ref pyramid_hash_op.cc: the sum of hashed n-gram embeddings for
    window sizes 2..pyramid_layer.  X (B, L) int ids padded with -1; W
    (space_len, num_emb); the JAX package's FNV-style uint32 mix (in int64
    arithmetic, masked to 32 bits)."""
    x = _one(ins, "X").long()
    w = _one(ins, "W")
    space_len = attrs.get("space_len", w.shape[0])
    layers = attrs.get("pyramid_layer", 2)
    B, L = x.shape
    valid = x >= 0
    out = w.new_zeros((B, w.shape[1]))
    for win in range(2, layers + 1):
        if win > L:
            break
        P = L - win + 1
        h = torch.full((B, P), 2166136261, dtype=torch.int64,
                       device=x.device)
        ok = torch.ones((B, P), dtype=torch.bool, device=x.device)
        for o in range(win):
            seg = x[:, o:P + o] & _U32
            h = ((h ^ seg) * _FNV_PRIME) & _U32
            ok = ok & valid[:, o:P + o]
        rows = w[h % space_len]                          # (B, P, emb)
        out = out + (rows * ok[..., None]).sum(1)
    return {"Out": [out]}


@register_op("var_conv_2d")
def _var_conv_2d(ins, attrs, op):
    """ref var_conv_2d_op.cc: conv over per-sample variable-size images.
    X (B, C, Hmax, Wmax) + ROW / COLUMN (B,) valid sizes; positions out of
    a sample's extent are zeroed before and after the conv."""
    from ..nn import functional as F

    x = _one(ins, "X")
    rows = _one(ins, "ROW").reshape(-1)
    cols = _one(ins, "COLUMN").reshape(-1)
    w = _one(ins, "W")     # (out_c, in_c, kh, kw)
    sh, sw = attrs.get("StrideH", 1), attrs.get("StrideW", 1)
    _B, _C, H, Wd = x.shape
    dev = x.device
    hh = torch.arange(H, device=dev)[None, :, None]
    ww = torch.arange(Wd, device=dev)[None, None, :]
    in_mask = (hh < rows[:, None, None]) & (ww < cols[:, None, None])
    out = F.conv2d(x * in_mask[:, None].to(x.dtype), w, stride=(sh, sw),
                   padding=(w.shape[2] // 2, w.shape[3] // 2))
    Ho, Wo = out.shape[2], out.shape[3]
    oh = torch.arange(Ho, device=dev)[None, :, None]
    ow = torch.arange(Wo, device=dev)[None, None, :]
    out_mask = ((oh < ((rows + sh - 1) // sh)[:, None, None])
                & (ow < ((cols + sw - 1) // sw)[:, None, None]))
    return {"Out": [out * out_mask[:, None].to(out.dtype)]}


@register_op("bilateral_slice")
def _bilateral_slice(ins, attrs, op):
    """ref bilateral_slice_op.cu (HDRnet): trilinearly sample the bilateral
    grid at (x, y, guide(x, y)) per pixel and apply the coefficients as a
    per-pixel affine map of X (has_offset adds the bias column)."""
    x = _one(ins, "X")          # (N, C_in, H, W)
    grid = _one(ins, "Grid").float()    # (N, C_g, D, Hg, Wg)
    guide = _one(ins, "Guide").float()  # (N, H, W) in [0, 1]
    N, Cin, H, W = x.shape
    _, Cg, Dg, Hg, Wg = grid.shape
    dev = x.device
    gy = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) \
        * Hg / H - 0.5
    gx = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) \
        * Wg / W - 0.5
    y0 = torch.floor(gy).clamp(0, Hg - 1).long()
    x0 = torch.floor(gx).clamp(0, Wg - 1).long()
    y1, x1 = (y0 + 1).clamp(0, Hg - 1), (x0 + 1).clamp(0, Wg - 1)
    wy = (gy - y0).clamp(0.0, 1.0)[:, None]
    wx = (gx - x0).clamp(0.0, 1.0)[None, :]
    coeffs = []
    for n in range(N):
        g, gz = grid[n], guide[n] * Dg - 0.5
        z0 = torch.floor(gz).clamp(0, Dg - 1).long()
        z1 = (z0 + 1).clamp(0, Dg - 1)
        wz = (gz - z0).clamp(0.0, 1.0)
        out = 0.0
        for zi, wz_ in ((z0, 1 - wz), (z1, wz)):
            for yi, wy_ in ((y0, 1 - wy), (y1, wy)):
                for xi, wx_ in ((x0, 1 - wx), (x1, wx)):
                    v = g[:, zi, yi[:, None], xi[None, :]]    # (Cg, H, W)
                    out = out + v * (wz_ * wy_ * wx_)[None]
        coeffs.append(out)
    coeffs = torch.stack(coeffs)                          # (N, Cg, H, W)
    xf = x.float()
    if attrs.get("has_offset", False):
        co = coeffs.reshape(N, Cg // (Cin + 1), Cin + 1, H, W)
        out = torch.einsum("ncihw,nihw->nchw", co[:, :, :Cin], xf) \
            + co[:, :, Cin]
    else:
        co = coeffs.reshape(N, Cg // Cin, Cin, H, W)
        out = torch.einsum("ncihw,nihw->nchw", co, xf)
    return {"Out": [out.to(x.dtype)]}


@register_op("sequence_reshape")
def _sequence_reshape(ins, attrs, op):
    """ref sequence_reshape_op.cc: re-chunk each sequence's flattened
    values to a new feature dim; (B, T', new_dim)."""
    x = _one(ins, "X")
    new_dim = attrs["new_dim"]
    B, T, D = x.shape
    assert (T * D) % new_dim == 0, "sequence_reshape: indivisible new_dim"
    return {"Out": [x.reshape(B, (T * D) // new_dim, new_dim)]}


@register_op("sequence_scatter")
def _sequence_scatter(ins, attrs, op):
    """ref sequence_scatter_op.cc: add per-sequence updates into X at
    per-sequence positions (Ids (B, U), Updates (B, U[, D]))."""
    x = _one(ins, "X")
    ids = _one(ins, "Ids").long()
    b_idx = torch.arange(x.shape[0], device=x.device)[:, None].expand_as(ids)
    return {"Out": [x.index_put((b_idx, ids), _one(ins, "Updates"),
                                accumulate=True)]}


@register_op("select_input")
def _select_input(ins, attrs, op):
    """ref controlflow/select_input_op: one of N inputs, by Mask."""
    xs = ins["X"]
    mask = _one(ins, "Mask").reshape(()).to(torch.int32)
    out = xs[0]
    for i in range(1, len(xs)):
        out = torch.where(mask == i, xs[i], out)
    return {"Out": [out]}


@register_op("select_output")
def _select_output(ins, attrs, op):
    """ref controlflow/select_output_op: X to the Mask-selected output,
    zeros to the others (the paired select_input re-picks)."""
    x = _one(ins, "X")
    mask = _one(ins, "Mask").reshape(()).to(torch.int32)
    return {"Out": [torch.where(mask == i, x, torch.zeros_like(x))
                    for i in range(len(op.outputs["Out"]))]}


@register_op("fusion_seqexpand_concat_fc")
def _fusion_seqexpand_concat_fc(ins, attrs, op):
    """ref fused/fusion_seqexpand_concat_fc_op.cc: every input after the
    first is a per-sequence vector expanded along time; concat, fc,
    activation."""
    x = ins["X"][0]              # (B, T, D1)
    b = _one(ins, "FCBias")
    T = x.shape[1]
    parts = [x] + [r[:, None, :].expand(r.shape[0], T, r.shape[1])
                   for r in ins["X"][1:]]
    out = torch.einsum("btd,do->bto", torch.cat(parts, dim=-1),
                       _one(ins, "FCWeight"))
    if b is not None:
        out = out + b
    act = attrs.get("fc_activation", "identity")
    if act != "identity":
        out = getattr(torch, act)(out)
    return {"Out": [out]}
