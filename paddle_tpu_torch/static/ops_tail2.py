"""Static-op long tail, batch 2 (counterpart of
paddle_tpu/static/ops_tail2.py): collectives, RNN monoliths, fusion ops,
LoD-array / control ops, PS data-plane ops, host-IO ops and the int8
quantize / dequantize pair, with ``fsp``, ``inplace_abn``,
``cross_entropy2`` and ``sample_logits``.

- The ``c_*`` collectives reduce over the bound data-parallel group
  (``parallel.collective.bound_data_axis``): a sum honours the ambient
  comm options through ``compress.optimized_all_reduce``; with no group
  bound each is the identity, as on one device in the JAX package.  The
  communicator and stream ops are identities.
- The RNN monoliths run their recurrence as a Python loop over time.
- The port runs op by op, so the host-IO ops act when they run (the JAX
  package needs ordered host callbacks under its trace), ``load`` reads
  its file at run time, and a tensor-array index is read from its tensor.
- The PS data-plane ops call the registered table's client
  (``distributed/ps.py``) directly, where the JAX package crosses from its
  trace with a host callback.
- ``py_func`` calls its Python function on numpy copies of its inputs and
  moves the results to the device.  ``sample_logits`` draws from the
  Executor's per-op CPU generator: its draws repeat for a fixed seed but
  cannot match ``jax.random``.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as tF

from ..core import dtype as _dtype_mod
from ..core import random as _random
from ..nn import functional as F
from .ops import _one, current_device
from .registry import register_op


# =========================================================================
# collective ops (ref operators/collective/c_*.cc)
# =========================================================================

def _data_axis():
    from ..parallel import collective as _coll

    return _coll.bound_data_axis()


def _c_allreduce(op_name, summing=False):
    def rule(ins, attrs, op):
        from ..parallel import collective as _coll

        x = _one(ins, "X")
        axis = _data_axis()
        if axis is None:
            return {"Out": [x]}
        if summing:
            # a sum honours the ambient comm options (ShardingPlan /
            # comm_scope: quantized payload, hierarchical schedule) or an
            # explicit ``compress`` attr; other reductions stay exact
            from ..parallel import compress as _compress

            kind = attrs.get("compress") or None
            opts = _compress.current_comm()
            if kind is None and opts is not None:
                kind = opts.payload()
            if kind:
                return {"Out": [_compress.optimized_all_reduce(
                    x, axis, compress=kind,
                    block_size=opts.block_size if opts else 256,
                    hierarchy=opts.hierarchy if opts else "auto")]}
        # prod gathers and multiplies in rank order: negatives keep signs
        return {"Out": [_coll.all_reduce(x, op=op_name, group=axis,
                                         compress="none")]}

    return rule


for _name, _red, _sum in (("c_allreduce_sum", "sum", True),
                          ("c_allreduce_max", "max", False),
                          ("c_allreduce_min", "min", False),
                          ("c_allreduce_prod", "prod", False)):
    register_op(_name)(_c_allreduce(_red, summing=_sum))


@register_op("c_allgather")
def _c_allgather(ins, attrs, op):
    from ..parallel import collective as _coll

    x = _one(ins, "X")
    axis = _data_axis()
    if axis is None:
        return {"Out": [x]}
    return {"Out": [_coll.all_gather(x, group=axis, axis=0)]}


@register_op("c_reducescatter")
def _c_reducescatter(ins, attrs, op):
    from ..parallel import collective as _coll

    x = _one(ins, "X")
    axis = _data_axis()
    if axis is None:
        return {"Out": [x]}
    return {"Out": [_coll.reduce_scatter(x, group=axis, axis=0)]}


@register_op("c_broadcast")
def _c_broadcast(ins, attrs, op):
    from ..parallel import collective as _coll

    x = _one(ins, "X")
    axis = _data_axis()
    if axis is None:
        return {"Out": [x]}
    return {"Out": [_coll.broadcast(x, src=attrs.get("root", 0),
                                    group=axis)]}


def _comm_noop_rule(why):
    def rule(ins, attrs, op):
        # identity pass-through: the reference op manages NCCL
        # communicators / streams, which the process group and CUDA's
        # stream order own here
        del attrs, op
        xs = ins.get("X", [])
        return {"Out": list(xs)} if xs else {}

    rule.__doc__ = why
    return rule


for _name, _why in [
        ("c_comm_init", "communicator creation = the process group"),
        ("c_comm_init_all", "same; all-rank init is the mesh constructor"),
        ("c_gen_nccl_id", "the process group exchanges the NCCL id"),
        ("c_sync_calc_stream", "ops run in stream order"),
        ("c_sync_comm_stream", "collectives return their result"),
        ("gen_nccl_id", "legacy alias of c_gen_nccl_id")]:
    register_op(_name)(_comm_noop_rule(_why))


@register_op("sync_batch_norm")
def _sync_batch_norm(ins, attrs, op):
    """ref sync_batch_norm_op.cu: BN statistics averaged across the data
    group; plain BN with no group bound."""
    from ..parallel import collective as _coll

    x = _one(ins, "X")
    axis = _data_axis()
    training = not attrs.get("is_test", False)
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    if axis is None or not training:
        out, new_rm, new_rv = F.batch_norm(
            x, _one(ins, "Mean"), _one(ins, "Variance"),
            weight=_one(ins, "Scale"), bias=_one(ins, "Bias"),
            training=training, momentum=momentum, epsilon=eps)
        return {"Y": [out], "MeanOut": [new_rm], "VarianceOut": [new_rv]}
    red = (0,) + tuple(range(2, x.ndim))
    shape = [1, -1] + [1] * (x.ndim - 2)
    stats = torch.stack([x.mean(dim=red), (x * x).mean(dim=red)])
    stats = _coll.all_reduce(stats, op="avg", group=axis, compress="none")
    mean, mean_sq = stats[0], stats[1]
    var = mean_sq - mean * mean
    out = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
    scale, bias = _one(ins, "Scale"), _one(ins, "Bias")
    if scale is not None:
        out = out * scale.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    rm, rv = _one(ins, "Mean"), _one(ins, "Variance")
    return {"Y": [out],
            "MeanOut": [momentum * rm + (1 - momentum) * mean],
            "VarianceOut": [momentum * rv + (1 - momentum) * var]}


# =========================================================================
# RNN monolith ops (ref lstm_op.cc, gru_op.cc, lstmp_op.cc, cudnn_lstm,
# fused/fusion_lstm.cc, fusion_gru.cc, fused_embedding_fc_lstm_op.cc) —
# dense (B, T, ...) layout, a loop over time
# =========================================================================

def _lstm_scan(gates_x, w_h, bias, h0, c0, mask=None, proj=None):
    """gates_x: (B, T, 4H) pre-projected inputs; returns (h_seq, c_seq)."""
    T = gates_x.shape[1]
    h, c = h0, c0
    hs, cs = [], []
    for t in range(T):
        g = gates_x[:, t] + h @ w_h
        if bias is not None:
            g = g + bias
        i, f, gg, o = torch.chunk(g, 4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        if proj is not None:
            h_new = h_new @ proj
        if mask is not None:
            mt = mask[:, t, None].to(h_new.dtype)
            h_new = h_new * mt + h * (1 - mt)
            c_new = c_new * mt + c * (1 - mt)
        h, c = h_new, c_new
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, 1), torch.stack(cs, 1)


def _zeros(b, h, like):
    return torch.zeros((b, h), dtype=like.dtype, device=like.device)


@register_op("lstm")
def _lstm_op(ins, attrs, op):
    """ref lstm_op.cc (padded layout): Input (B,T,4H) pre-gates, Weight
    (H,4H), Bias (4H) [+ optional (B,T) Mask] -> Hidden/Cell (B,T,H)."""
    x = _one(ins, "Input")
    B, H = x.shape[0], x.shape[2] // 4
    h0, c0 = _one(ins, "H0"), _one(ins, "C0")
    hs, cs = _lstm_scan(x, _one(ins, "Weight"), _one(ins, "Bias"),
                        _zeros(B, H, x) if h0 is None else h0,
                        _zeros(B, H, x) if c0 is None else c0,
                        _one(ins, "Mask"))
    return {"Hidden": [hs], "Cell": [cs]}


@register_op("lstmp")
def _lstmp_op(ins, attrs, op):
    """ref lstmp_op.cc: LSTM with a recurrent projection — the projected
    state (B,T,P) is the recurrent input and the output."""
    x = _one(ins, "Input")          # (B, T, 4H)
    proj = _one(ins, "ProjWeight")  # (H, P)
    B, H = x.shape[0], x.shape[2] // 4
    hs, cs = _lstm_scan(x, _one(ins, "Weight"), _one(ins, "Bias"),
                        _zeros(B, proj.shape[1], x), _zeros(B, H, x),
                        _one(ins, "Mask"), proj=proj)
    return {"Projection": [hs], "Cell": [cs]}


@register_op("cudnn_lstm")
def _cudnn_lstm_op(ins, attrs, op):
    """ref cudnn_lstm_op.cu: time-major (T,B,I) input with packed weights,
    one layer, one direction.  W packs [Wx (I,4H); Wh (H,4H); b (4H)]."""
    x = _one(ins, "Input")   # (T, B, I)
    w = _one(ins, "W")
    H = attrs["hidden_size"]
    T, B, inp = x.shape
    wx = w[:inp * 4 * H].reshape(inp, 4 * H)
    wh = w[inp * 4 * H:(inp + H) * 4 * H].reshape(H, 4 * H)
    b = w[(inp + H) * 4 * H:(inp + H) * 4 * H + 4 * H]
    gates = torch.einsum("tbi,ih->tbh", x, wx)
    hs, cs = _lstm_scan(gates.transpose(0, 1), wh, b, _zeros(B, H, x),
                        _zeros(B, H, x))
    return {"Out": [hs.transpose(0, 1)],
            "LastH": [hs[:, -1]], "LastC": [cs[:, -1]]}


def _gru_scan(gates_x, w_h, h0, mask=None):
    """gates_x (B,T,3H) pre-projected; w_h (H,3H): [:, :2H] update/reset,
    [:, 2H:] candidate (ref gru_unit_op.h layout)."""
    H = gates_x.shape[2] // 3
    h, hs = h0, []
    for t in range(gates_x.shape[1]):
        xt = gates_x[:, t]
        uh = h @ w_h[:, :2 * H]
        r = torch.sigmoid(xt[:, :H] + uh[:, :H])
        z = torch.sigmoid(xt[:, H:2 * H] + uh[:, H:])
        c = torch.tanh(xt[:, 2 * H:] + (r * h) @ w_h[:, 2 * H:])
        h_new = z * h + (1 - z) * c
        if mask is not None:
            mt = mask[:, t, None].to(h_new.dtype)
            h_new = h_new * mt + h * (1 - mt)
        h = h_new
        hs.append(h)
    return torch.stack(hs, 1)


@register_op("gru")
def _gru_op(ins, attrs, op):
    """ref gru_op.cc (padded): Input (B,T,3H), Weight (H,3H), Bias (3H)."""
    x = _one(ins, "Input")
    b = _one(ins, "Bias")
    if b is not None:
        x = x + b
    h0 = _one(ins, "H0")
    if h0 is None:
        h0 = _zeros(x.shape[0], x.shape[2] // 3, x)
    return {"Hidden": [_gru_scan(x, _one(ins, "Weight"), h0,
                                 _one(ins, "Mask"))]}


@register_op("fusion_lstm")
def _fusion_lstm_op(ins, attrs, op):
    """ref fused/fusion_lstm_op.cc: X (B,T,M) @ WeightX (M,4H) + lstm."""
    x, wh = _one(ins, "X"), _one(ins, "WeightH")
    B, H = x.shape[0], wh.shape[0]
    gates = torch.einsum("btm,mh->bth", x, _one(ins, "WeightX"))
    hs, cs = _lstm_scan(gates, wh, _one(ins, "Bias"), _zeros(B, H, x),
                        _zeros(B, H, x), _one(ins, "Mask"))
    return {"Hidden": [hs], "Cell": [cs]}


@register_op("fusion_gru")
def _fusion_gru_op(ins, attrs, op):
    """ref fused/fusion_gru_op.cc: X @ WeightX then the GRU recurrence."""
    x, wh, b = _one(ins, "X"), _one(ins, "WeightH"), _one(ins, "Bias")
    gates = torch.einsum("btm,mh->bth", x, _one(ins, "WeightX"))
    if b is not None:
        gates = gates + b
    return {"Hidden": [_gru_scan(gates, wh, _zeros(x.shape[0], wh.shape[0],
                                                   x), _one(ins, "Mask"))]}


@register_op("fused_embedding_fc_lstm")
def _fused_embedding_fc_lstm_op(ins, attrs, op):
    """ref fused_embedding_fc_lstm_op.cc: ids -> embedding (the fc folded
    into the table) -> lstm."""
    ids = _one(ins, "Ids")          # (B, T) int
    emb = _one(ins, "Embeddings")   # (V, 4H) pre-projected rows
    wh = _one(ins, "WeightH")
    gates = emb[ids.long()]
    B, H = gates.shape[0], wh.shape[0]
    hs, cs = _lstm_scan(gates, wh, _one(ins, "Bias"), _zeros(B, H, gates),
                        _zeros(B, H, gates))
    return {"Hidden": [hs], "Cell": [cs]}


# =========================================================================
# fusion ops (ref operators/fused/)
# =========================================================================

@register_op("fusion_repeated_fc_relu")
def _fusion_repeated_fc_relu(ins, attrs, op):
    """ref fusion_repeated_fc_relu_op.cc: x -> [fc -> relu]*N."""
    x = _one(ins, "X")
    for w, b in zip(ins["W"], ins["Bias"]):
        x = torch.relu(x @ w + b)
    return {"Out": [x]}


@register_op("fusion_squared_mat_sub")
def _fusion_squared_mat_sub(ins, attrs, op):
    """ref fusion_squared_mat_sub_op.cc: scalar * ((x@y)^2 - x^2@y^2)."""
    x, y = _one(ins, "X"), _one(ins, "Y")
    xy = x @ y
    return {"Out": [attrs.get("scalar", 1.0)
                    * (xy * xy - (x * x) @ (y * y))]}


@register_op("fusion_seqpool_concat")
def _fusion_seqpool_concat(ins, attrs, op):
    """ref fusion_seqpool_concat_op.cc: per-input sequence_pool (padded
    (B,T,D) + shared Length) then feature concat."""
    from ..ops import sequence as S

    length = _one(ins, "Length")
    ptype = attrs.get("pooltype", "SUM").lower()
    return {"Out": [torch.cat([S.sequence_pool(x, length, pool_type=ptype)
                               for x in ins["X"]], dim=-1)]}


@register_op("fusion_seqconv_eltadd_relu")
def _fusion_seqconv_eltadd_relu(ins, attrs, op):
    """ref fusion_seqconv_eltadd_relu_op.cc: sequence_conv + bias + relu
    over the padded layout."""
    from ..ops import misc as M

    out = M.sequence_conv(_one(ins, "X"), _one(ins, "Filter"),
                          lengths=_one(ins, "Length"),
                          context_length=attrs["contextLength"],
                          context_start=attrs.get("contextStart"))
    return {"Out": [torch.relu(out + _one(ins, "Bias"))]}


@register_op("fsp")
def _fsp(ins, attrs, op):
    """ref fsp_op.cc (knowledge distillation): the normalized gram matrix
    of two feature maps, (B, C1, C2)."""
    x, y = _one(ins, "X"), _one(ins, "Y")
    hw = x.shape[2] * x.shape[3]
    return {"Out": [torch.einsum("bchw,bdhw->bcd", x, y) / hw]}


@register_op("inplace_abn")
def _inplace_abn(ins, attrs, op):
    """ref inplace_abn_op.cc: batch_norm + activation."""
    out, new_rm, new_rv = F.batch_norm(
        _one(ins, "X"), _one(ins, "Mean"), _one(ins, "Variance"),
        weight=_one(ins, "Scale"), bias=_one(ins, "Bias"),
        training=not attrs.get("is_test", False),
        momentum=attrs.get("momentum", 0.9),
        epsilon=attrs.get("epsilon", 1e-5))
    act = attrs.get("activation", "identity")
    if act == "leaky_relu":
        out = tF.leaky_relu(out, attrs.get("alpha", 0.01))
    elif act == "elu":
        out = tF.elu(out, attrs.get("alpha", 1.0))
    elif act != "identity":
        out = getattr(torch, act)(out)
    return {"Y": [out], "MeanOut": [new_rm], "VarianceOut": [new_rv]}


# -- host-IO ops (ref save_op.cc, load_op.cc, save_combine_op.cc,
#    load_combine_op.cc, py_func_op.cc) --------------------------------------

def _host(t) -> np.ndarray:
    from .io import _to_saved

    return _to_saved(t)


def _device(arr, like_device):
    from .io import _from_saved

    v = _from_saved(np.asarray(arr))
    return torch.as_tensor(v).to(like_device)


def _open_for_write(path):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return open(path, "wb")  # the exact path: np.save(str) appends .npy


@register_op("save")
def _save_op(ins, attrs, op):
    with _open_for_write(attrs["file_path"]) as f:
        np.save(f, _host(_one(ins, "X")))
    return {}


@register_op("save_combine")
def _save_combine_op(ins, attrs, op):
    with _open_for_write(attrs["file_path"]) as f:
        np.savez(f, **{str(n): _host(v)
                       for n, v in zip(op.inputs["X"], ins["X"])})
    return {}


@register_op("load")
def _load_op(ins, attrs, op):
    from .ops import current_device

    return {"Out": [_device(np.load(attrs["file_path"]), current_device())]}


@register_op("load_combine")
def _load_combine_op(ins, attrs, op):
    from .ops import current_device

    data = np.load(attrs["file_path"])
    return {"Out": [_device(data[str(n)], current_device())
                    for n in op.outputs["Out"]]}


_PY_FUNCS = {}


def register_py_func(fid: int, fn) -> None:
    """ref py_func_op.cc's python-callable registry."""
    _PY_FUNCS[int(fid)] = fn


@register_op("py_func")
def _py_func_op(ins, attrs, op):
    from .ops import current_device

    fn = _PY_FUNCS[int(attrs["forward_callable_id"])]
    out_dtypes = attrs.get("out_dtypes",
                           ["float32"] * len(attrs["out_shapes"]))
    r = fn(*[_host(x) for x in ins.get("X", [])])
    if not isinstance(r, (tuple, list)):
        r = (r,)
    return {"Out": [torch.as_tensor(np.asarray(v)).to(
        device=current_device(), dtype=_dtype_mod.convert_dtype(d))
        for v, d in zip(r, out_dtypes)]}


@register_op("cross_entropy2")
def _cross_entropy2(ins, attrs, op):
    """ref cross_entropy_op2.cc: hard-label CE over probabilities with the
    MatchX / XShape outputs of the paired grad kernel."""
    x = _one(ins, "X")
    label = _one(ins, "Label").reshape(x.shape[:-1]).long()
    match = torch.gather(x, -1, label[..., None])
    loss = -torch.log(torch.clamp_min(match, 1e-12))
    ignore = attrs.get("ignore_index", -100)
    loss = torch.where(label[..., None] == ignore, torch.zeros_like(loss),
                       loss)
    return {"Y": [loss], "MatchX": [match], "XShape": [x]}


@register_op("sample_logits")
def _sample_logits(ins, attrs, op):
    """ref sample_logits_op.cc (sampled softmax): the true-label logit plus
    ``num_samples`` uniform negatives, with the log-q correction."""
    logits = _one(ins, "Logits")   # (B, C)
    labels = _one(ins, "Labels").reshape(-1).long()
    n = attrs["num_samples"]
    B, C = logits.shape
    samples = torch.randint(0, C, (B, n),
                            generator=_random.current_generator())
    idx = torch.cat([labels[:, None], samples.to(labels.device)], dim=1)
    sampled = torch.gather(logits, 1, idx)
    out = sampled - float(np.log(np.float32(n / C)))
    out = torch.cat([sampled[:, :1], out[:, 1:]], dim=1)
    return {"SampledLogits": [out], "Samples": [idx.to(torch.int32)],
            "SampledLabels": [torch.zeros((B,), dtype=torch.int32,
                                          device=logits.device)]}


# =========================================================================
# pooling tails: max_pool3d_with_index, unpool
# =========================================================================

@register_op("max_pool3d_with_index")
def _max_pool3d_with_index(ins, attrs, op):
    """Max over each window and its flat D*H*W index in the volume."""
    x = _one(ins, "X")
    kd, kh, kw = tuple(attrs["ksize"])
    sd, sh, sw = tuple(attrs.get("strides", attrs["ksize"]))
    N, C, D, H, W = x.shape
    od, oh, ow = (D - kd) // sd + 1, (H - kh) // sh + 1, (W - kw) // sw + 1
    patches = (x.unfold(2, kd, sd).unfold(3, kh, sh).unfold(4, kw, sw)
               .reshape(N, C, od, oh, ow, kd * kh * kw))
    out, arg = patches.max(dim=-1)
    dev = x.device
    li = (torch.arange(od, device=dev) * sd)[:, None, None]
    lj = (torch.arange(oh, device=dev) * sh)[None, :, None]
    lk = (torch.arange(ow, device=dev) * sw)[None, None, :]
    wd, wh_, wk = arg // (kh * kw), (arg // kw) % kh, arg % kw
    gidx = ((li + wd) * H + (lj + wh_)) * W + (lk + wk)
    return {"Out": [out], "Mask": [gidx.to(torch.int32)]}


@register_op("unpool")
def _unpool(ins, attrs, op):
    """ref unpool_op.cc: scatter pooled values back to the argmax
    positions max_pool2d_with_index recorded."""
    x = _one(ins, "X")          # (N, C, oh, ow)
    idx = _one(ins, "Indices")  # flat H*W indices
    H, W = attrs["unpool_size"] if "unpool_size" in attrs else (
        attrs["output_size"][0], attrs["output_size"][1])
    N, C = x.shape[0], x.shape[1]
    flat = torch.zeros((N, C, H * W), dtype=x.dtype, device=x.device)
    flat.scatter_add_(2, idx.reshape(N, C, -1).long(), x.reshape(N, C, -1))
    return {"Out": [flat.reshape(N, C, H, W)]}


# =========================================================================
# tensor-array / LoD control ops (ref tensor_array_read_write_op.cc,
# array_to_lod_tensor_op.cc, shrink_rnn_memory_op.cc,
# merge/split_lod_tensor_op.cc).  A tensor array is a Python list in the
# Executor's environment.
# =========================================================================

def _index(i, attrs):
    """The array index: an explicit ``index`` attr, else the value of I
    (read on the host)."""
    if "index" in attrs:
        return int(attrs["index"])
    return int(torch.as_tensor(i).reshape(-1)[0].item())


@register_op("write_to_array")
def _write_to_array(ins, attrs, op):
    i = _index(_one(ins, "I"), attrs)
    arr = list(ins["Array"][0] or []) if ins.get("Array") else []
    while len(arr) <= i:
        arr.append(None)
    arr[i] = _one(ins, "X")
    return {"Out": [arr]}


@register_op("read_from_array")
def _read_from_array(ins, attrs, op):
    return {"Out": [_one(ins, "X")[_index(_one(ins, "I"), attrs)]]}


@register_op("array_to_lod_tensor")
def _array_to_lod_tensor(ins, attrs, op):
    """Stack the time-step list back into a padded (T, ...) tensor."""
    return {"Out": [torch.stack(list(_one(ins, "X")), dim=0)]}


@register_op("lod_tensor_to_array")
def _lod_tensor_to_array(ins, attrs, op):
    x = _one(ins, "X")
    return {"Out": [[x[t] for t in range(x.shape[0])]]}


@register_op("shrink_rnn_memory")
def _shrink_rnn_memory(ins, attrs, op):
    """ref shrink_rnn_memory_op.cc: in the dense layout every sequence is
    padded to one length, so the memory never shrinks — identity."""
    return {"Out": [_one(ins, "X")]}


def _row_mask(mask, like):
    return mask.reshape(-1).bool().reshape((-1,) + (1,) * (like.ndim - 1))


@register_op("merge_lod_tensor")
def _merge_lod_tensor(ins, attrs, op):
    """ref merge_lod_tensor_op.cc (IfElse runtime): rows from InTrue where
    Mask else InFalse."""
    t, f = _one(ins, "InTrue"), _one(ins, "InFalse")
    return {"Out": [torch.where(_row_mask(_one(ins, "Mask"), t), t, f)]}


@register_op("split_lod_tensor")
def _split_lod_tensor(ins, attrs, op):
    """ref split_lod_tensor_op.cc, dense: both branches get the whole
    batch with the rows of the other branch zeroed."""
    x = _one(ins, "X")
    m = _row_mask(_one(ins, "Mask"), x)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return {"OutTrue": [torch.where(m, x, zero)],
            "OutFalse": [torch.where(m, zero, x)]}


# =========================================================================
# PS data-plane ops (ref distributed_lookup_table_op.cc, pscore
# pull_sparse / push_sparse): the registered table's client, called as the
# op runs
# =========================================================================

_PS_TABLES = {}


def register_ps_table(name: str, table) -> None:
    """Bind a ``distributed.ps`` SparseTable / RemoteSparseTable for the
    PS data-plane ops."""
    _PS_TABLES[name] = table


def _table(attrs):
    name = attrs.get("table_name", attrs.get("table_id", "default"))
    try:
        return _PS_TABLES[str(name)]
    except KeyError:
        raise ValueError(
            f"PS table {name!r} not registered; call "
            "static.ops_tail2.register_ps_table(name, table) first"
        ) from None


def _pull_rule(ins, attrs, op):
    """Embedding rows pulled from the host / remote table (the
    reference's RPC pull)."""
    ids = _one(ins, "Ids")
    table = _table(attrs)
    rows = table.pull(_host(ids).reshape(-1)).astype(np.float32)
    out = torch.from_numpy(rows).to(ids.device).reshape(
        tuple(ids.shape) + (int(table.dim),))
    return {"Outputs" if "Outputs" in op.outputs else "Out": [out]}


def _push_rule(ins, attrs, op):
    ids = _one(ins, "Ids")
    grads = _one(ins, "Grads" if ins.get("Grads") else "X")
    _table(attrs).push(_host(ids).reshape(-1),
                       _host(grads).astype(np.float32).reshape(
                           -1, grads.shape[-1]),
                       float(attrs.get("lr", 0.1)))
    if "Out" in op.outputs:
        return {"Out": [torch.zeros((), dtype=torch.int32,
                                    device=ids.device)]}
    return {}


for _name in ("distributed_lookup_table", "pull_sparse", "pull_sparse_v2"):
    register_op(_name)(_pull_rule)
for _name in ("push_sparse", "push_sparse_v2"):
    register_op(_name)(_push_rule)


@register_op("c_embedding")
def _c_embedding(ins, attrs, op):
    """ref collective c_embedding_op.cc: W is one vocab partition starting
    at ``start_index``; ids outside it give zero rows (the caller
    all-reduces the partial results over the model group)."""
    ids, w = _one(ins, "Ids"), _one(ins, "W")
    rows_per = int(w.shape[0])
    local = ids.reshape(-1).long() - int(attrs.get("start_index", 0))
    mine = (local >= 0) & (local < rows_per)
    rows = w[local.clamp(0, rows_per - 1)]
    rows = torch.where(mine[:, None], rows, torch.zeros((), dtype=w.dtype,
                                                        device=w.device))
    return {"Out": [rows.reshape(tuple(ids.shape) + (int(w.shape[-1]),))]}


@register_op("merge_ids")
def _merge_ids(ins, attrs, op):
    """ref merge_ids_op.cc, dense: every shard carries the whole
    position-aligned vector with -1 where it does not own the slot; the
    merge selects per position."""
    out = torch.zeros_like(ins["X"][0])
    for ids_s, rows_s in zip(ins["Ids"], ins["X"]):
        mask = (ids_s.reshape(-1) >= 0).reshape(
            (-1,) + (1,) * (out.ndim - 1))
        out = torch.where(mask, rows_s, out)
    return {"Out": [out]}


@register_op("split_ids")
def _split_ids(ins, attrs, op):
    """ref split_ids_op.cc: ids routed to N shards by id % N, each shard
    the whole vector with -1 in the slots it does not own."""
    ids = _one(ins, "Ids").reshape(-1)
    n = len(op.outputs["Out"])
    neg = torch.full_like(ids, -1)
    return {"Out": [torch.where(ids % n == s, ids, neg) for s in range(n)]}


@register_op("split_selected_rows")
def _split_selected_rows(ins, attrs, op):
    """Dense SelectedRows split: rows routed by height_sections."""
    x = _one(ins, "X")
    outs, start = [], 0
    for h in attrs["height_sections"]:
        outs.append(x[start:start + h])
        start += h
    return {"Out": outs}


@register_op("split_byref")
def _split_byref(ins, attrs, op):
    x = _one(ins, "X")
    return {"Out": list(torch.chunk(x, len(op.outputs["Out"]), dim=0))}


@register_op("lookup_sparse_table_merge")
def _lookup_sparse_table_merge(ins, attrs, op):
    """ref lookup_sparse_table_merge_op.cc: the union of the id sets
    (sorted, repeats as -1)."""
    s = torch.sort(torch.cat([x.reshape(-1) for x in ins["X"]])).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    return {"Out": [torch.where(first, s, torch.full_like(s, -1))]}


@register_op("print")
def _print_op(ins, attrs, op):
    """ref print_op.cc: prints ``message`` and the value as the op runs."""
    x = _one(ins, "In")
    print(f"{attrs.get('message', '')}{_host(x)}")
    return {"Out": [x]}


# =========================================================================
# int8 quantize / dequantize pair (ref mkldnn quantize_op.cc; requantize
# rescales between int8 domains)
# =========================================================================

@register_op("quantize")
def _quantize_op(ins, attrs, op):
    x = _one(ins, "Input")
    scale = attrs.get("Scale", attrs.get("scale", 1.0))
    return {"Output": [torch.clamp(torch.round(x * scale), -128, 127)
                       .to(torch.int8)]}


@register_op("dequantize")
def _dequantize_op(ins, attrs, op):
    x = _one(ins, "Input")
    return {"Output": [x.to(torch.float32)
                       / attrs.get("Scale", attrs.get("scale", 1.0))]}


@register_op("requantize")
def _requantize_op(ins, attrs, op):
    x = _one(ins, "Input")
    s_in, s_out = attrs.get("Scale_in", 1.0), attrs.get("Scale_out", 1.0)
    return {"Output": [torch.clamp(
        torch.round(x.to(torch.float32) / s_in * s_out), -128, 127)
        .to(torch.int8)]}
