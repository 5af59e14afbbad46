"""Static-op long tail, batch 4 (counterpart of
paddle_tpu/static/ops_tail4.py): the audited registry stragglers —
``unique`` / ``unique_with_counts``, ``where_index``, ``hash``,
``sequence_enumerate`` / ``sequence_erase``, the proximal optimizers,
``positive_negative_pair``, the DGC family and the root collectives
``c_reduce_*`` / ``c_scatter`` / ``barrier``.

The contracts are the JAX package's:

- **Padded dynamic outputs**: ops whose reference output shape depends on
  the data (``unique``, ``where_index``, ``sequence_erase``) emit a
  fixed-shape tensor padded at the tail plus a valid count under an extra
  optional slot (``ValidCount`` / ``Length``); valid entries come first in
  reference order, pad entries are zeros.
- **unique** keeps first-appearance order (not sorted).
- **hash** is the JAX package's uint32 FNV-1a / avalanche family (not
  XXH64), computed in int64 arithmetic masked to 32 bits.
- **DGC top-k** is a magnitude-quantile threshold mask over the dense
  velocity buffer.
- **c_reduce_* / c_scatter** keep root semantics over the bound data
  group, non-root members passing their input through; with no group
  bound each is the identity.  ``barrier`` is a rendezvous (a zero
  all-reduce) under a bound group and the identity otherwise.
"""
from __future__ import annotations

import torch

from ..core import dtype as _dtype_mod
from .ops import _one
from .registry import get_lowering, register_op

_U32 = 0xFFFFFFFF


# =========================================================================
# unique / unique_with_counts (ref unique_op.cc UniqueOpFunctor)
# =========================================================================

def _unique_parts(x, index_dtype):
    """First-appearance unique of a 1-D tensor with static shapes:
    (out_padded, inverse_index, counts_padded, valid_count)."""
    n = x.shape[0]
    eq = x[:, None] == x[None, :]
    firstpos = eq.to(torch.int8).argmax(dim=1)       # first j with x[j]==x[i]
    is_first = firstpos == torch.arange(n, device=x.device)
    rank = torch.cumsum(is_first.long(), 0) - 1
    index = rank[firstpos]
    out = torch.zeros_like(x)
    out[rank[is_first]] = x[is_first]
    counts = torch.zeros((n,), dtype=torch.int64, device=x.device)
    counts.index_add_(0, index, torch.ones_like(index))
    valid = is_first.sum()
    return (out, index.to(index_dtype), counts.to(index_dtype),
            valid.to(index_dtype))


def _index_dtype(attrs):
    d = attrs.get("dtype", "int64")
    return _dtype_mod.convert_dtype(d if d is not None else "int64")


@register_op("unique")
def _unique(ins, attrs, op):
    """ref unique_op.cc (is_sorted=False): distinct values in
    first-appearance order + the inverse Index (padded contract)."""
    out, index, counts, valid = _unique_parts(_one(ins, "X"),
                                              _index_dtype(attrs))
    return {"Out": [out], "Index": [index], "Counts": [counts],
            "ValidCount": [valid]}


@register_op("unique_with_counts")
def _unique_with_counts(ins, attrs, op):
    """ref unique_with_counts_op.cc: unique + per-value Count (padded)."""
    out, index, counts, valid = _unique_parts(_one(ins, "X"),
                                              _index_dtype(attrs))
    return {"Out": [out], "Index": [index], "Count": [counts],
            "ValidCount": [valid]}


@register_op("where_index")
def _where_index(ins, attrs, op):
    """ref where_index_op.cc: coordinates of the nonzero elements in
    row-major order, (numel, rank), zero rows past ValidCount."""
    x = _one(ins, "Condition")
    if x is None:
        x = _one(ins, "X")
    mask = (x != 0).reshape(-1)
    n = mask.shape[0]
    coords = torch.stack(torch.unravel_index(
        torch.arange(n, device=x.device), tuple(x.shape)), dim=1)
    out = torch.zeros((n, x.ndim), dtype=torch.int64, device=x.device)
    tgt = torch.cumsum(mask.long(), 0) - 1
    out[tgt[mask]] = coords[mask]
    return {"Out": [out], "ValidCount": [mask.sum()]}


# =========================================================================
# hash (ref hash_op.h HashKernel)
# =========================================================================

@register_op("hash")
def _hash(ins, attrs, op):
    """ref hash_op.h: Out[..., i, 0] = H_i(row) % mod_by for num_hash
    seeds i (the JAX package's uint32 FNV-1a + avalanche family)."""
    x = _one(ins, "X")
    num_hash = int(attrs.get("num_hash", 1))
    mod_by = int(attrs.get("mod_by", 1))
    rows = x.reshape((-1, x.shape[-1])).long() & _U32
    seeds = torch.arange(num_hash, dtype=torch.int64, device=x.device)
    h = (2166136261 ^ ((seeds * 0x9E3779B9) & _U32)) & _U32
    h = h[None, :].expand(rows.shape[0], num_hash)
    for k in range(rows.shape[1]):
        h = ((h ^ rows[:, k, None]) * 16777619) & _U32     # FNV-1a round
        h = h ^ (h >> 15)
        h = (h * 0x85EBCA6B) & _U32                       # avalanche
        h = h ^ (h >> 13)
    out = h % mod_by
    return {"Out": [out.reshape(tuple(x.shape[:-1]) + (num_hash, 1))]}


# =========================================================================
# sequence_enumerate / sequence_erase (dense (B, T) + Length layout)
# =========================================================================

def _lengths(lengths, B, T, device):
    if lengths is None:
        return torch.full((B,), T, dtype=torch.int64, device=device)
    return lengths.reshape(-1).long()


@register_op("sequence_enumerate")
def _sequence_enumerate(ins, attrs, op):
    """ref sequence_enumerate_op.h: per position t the window
    [x[t], ..., x[t+win-1]], positions past the sequence end pad_value.
    X (B, T) ids + Length (B,) -> Out (B, T, win_size)."""
    x = _one(ins, "X")
    if x.ndim == 3 and x.shape[-1] == 1:
        x = x[..., 0]
    B, T = x.shape
    lengths = _lengths(_one(ins, "Length"), B, T, x.device)
    win = int(attrs["win_size"])
    pos = (torch.arange(T, device=x.device)[:, None]
           + torch.arange(win, device=x.device)[None, :])
    gathered = x[:, pos.clamp_max(T - 1)]
    valid = pos[None] < lengths[:, None, None]
    pad = torch.full((), attrs.get("pad_value", 0), dtype=x.dtype,
                     device=x.device)
    return {"Out": [torch.where(valid, gathered, pad)]}


@register_op("sequence_erase")
def _sequence_erase(ins, attrs, op):
    """ref sequence_erase_op.h: drop every occurrence of attr ``tokens``
    from each sequence, left-compacting survivors.  X (B, T) + Length (B,)
    -> Out (B, T) zero-padded + the new lengths under Length."""
    x = _one(ins, "X")
    squeeze = x.ndim == 3 and x.shape[-1] == 1
    if squeeze:
        x = x[..., 0]
    B, T = x.shape
    lengths = _lengths(_one(ins, "Length"), B, T, x.device)
    in_len = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
    hit = torch.zeros_like(x, dtype=torch.bool)
    for t in attrs.get("tokens", []):
        hit = hit | (x == int(t))
    keep = in_len & ~hit
    tgt = torch.cumsum(keep.long(), 1) - 1
    out = torch.zeros_like(x)
    rows = torch.arange(B, device=x.device)[:, None].expand(B, T)
    out[rows[keep], tgt[keep]] = x[keep]
    if squeeze:
        out = out[..., None]
    return {"Out": [out], "Length": [keep.sum(1)]}


# =========================================================================
# proximal optimizers (ref optimizers/proximal_{adagrad,gd}_op.h)
# =========================================================================

def _prox(prox_param, lr, l1, l2):
    """Soft-threshold by lr*l1, then shrink by 1/(1+lr*l2)."""
    if l1 > 0:
        return (torch.sign(prox_param)
                * torch.clamp_min(prox_param.abs() - lr * l1, 0.0)
                / (1.0 + lr * l2))
    return prox_param / (1.0 + lr * l2)


def _lr(ins, p):
    return _one(ins, "LearningRate").to(p.dtype).reshape(())


@register_op("proximal_adagrad")
def _proximal_adagrad(ins, attrs, op):
    """ref proximal_adagrad_op.h: m += g^2; prox(p - lr*g/sqrt(m))."""
    p, g, m = _one(ins, "Param"), _one(ins, "Grad"), _one(ins, "Moment")
    lr = _lr(ins, p)
    m_out = m + g * g
    return {"ParamOut": [_prox(p - lr * g / torch.sqrt(m_out), lr,
                               float(attrs.get("l1", 0.0)),
                               float(attrs.get("l2", 0.0)))],
            "MomentOut": [m_out]}


@register_op("proximal_gd")
def _proximal_gd(ins, attrs, op):
    """ref proximal_gd_op.h: prox(p - lr*g)."""
    p, g = _one(ins, "Param"), _one(ins, "Grad")
    lr = _lr(ins, p)
    return {"ParamOut": [_prox(p - lr * g, lr, float(attrs.get("l1", 0.0)),
                               float(attrs.get("l2", 0.0)))]}


# =========================================================================
# positive_negative_pair (ref positive_negative_pair_op.h)
# =========================================================================

@register_op("positive_negative_pair")
def _positive_negative_pair(ins, attrs, op):
    """ref positive_negative_pair_op.h: over every same-query pair with
    differing labels, positive when score and label order agree, else
    negative; equal scores also count as neutral (the reference adds the
    pair to both)."""
    score = _one(ins, "Score")
    label = _one(ins, "Label").reshape(-1).to(score.dtype)
    query = _one(ins, "QueryID").reshape(-1)
    weight = _one(ins, "Weight")
    w = (weight.reshape(-1).to(score.dtype) if weight is not None
         else torch.ones_like(label))
    s = score[:, int(attrs.get("column", -1))]
    i = torch.arange(s.shape[0], device=s.device)
    pair = ((i[:, None] < i[None, :]) & (query[:, None] == query[None, :])
            & (label[:, None] != label[None, :]))
    wij = (w[:, None] + w[None, :]) * 0.5
    agree = (s[:, None] - s[None, :]) * (label[:, None] - label[None, :]) > 0
    tie = s[:, None] == s[None, :]
    zero = torch.zeros((), dtype=score.dtype, device=score.device)
    sums = {"AccumulatePositivePair": torch.where(pair & agree, wij,
                                                  zero).sum(),
            "AccumulateNegativePair": torch.where(pair & ~agree, wij,
                                                  zero).sum(),
            "AccumulateNeutralPair": torch.where(pair & tie, wij,
                                                 zero).sum()}
    for slot in sums:
        a = _one(ins, slot)
        if a is not None:
            sums[slot] = sums[slot] + a.reshape(())
    return {"PositivePair": [sums["AccumulatePositivePair"].reshape(1)],
            "NegativePair": [sums["AccumulateNegativePair"].reshape(1)],
            "NeutralPair": [sums["AccumulateNeutralPair"].reshape(1)]}


# =========================================================================
# DGC op family (ref dgc_op.h, optimizers/dgc_momentum_op.h,
# dgc_clip_by_norm_op.h)
# =========================================================================

def _scalar(v, like, default=0.0):
    if v is None:
        return torch.tensor(default, dtype=torch.float32, device=like.device)
    return v.reshape(()).float()


@register_op("dgc")
def _dgc(ins, attrs, op):
    """ref dgc_op.h DGCOpKernel: regularize grad (x nranks), momentum
    correction into U/V, magnitude top-k of V as the sparse gradient,
    residual left in V; before current_step reaches rampup_begin_step a
    plain pass-through (Grad_out still regularized)."""
    u, v, g, p = (_one(ins, "U"), _one(ins, "V"), _one(ins, "Grad"),
                  _one(ins, "Param"))
    step = _scalar(_one(ins, "current_step"), g)
    nranks = _scalar(_one(ins, "nranks"), g, 1.0).to(g.dtype)
    m = float(attrs.get("m", 0.9))
    sparsity = [float(s) for s in attrs.get("sparsity", [0.999])]
    rampup_begin = float(attrs.get("rampup_begin_step", 0.0))
    rampup_step = float(attrs.get("rampup_step", 1.0))
    coeff = float(attrs.get("regular_coeff", 0.0))
    rtype = int(attrs.get("regular_type", 0))

    grad_out = nranks * g
    if rtype == 1:
        grad_out = grad_out + coeff * torch.sign(p)
    elif rtype == 2:
        grad_out = grad_out + coeff * p
    cur = torch.clamp_min(step - rampup_begin, 0.0)
    tbl = torch.tensor(sparsity, dtype=torch.float32, device=g.device)
    idx = torch.clamp_max((cur * len(sparsity) / rampup_step).to(
        torch.int32), len(sparsity) - 1)
    ratio = 1.0 - tbl[idx.long()]
    if attrs.get("use_nesterov", False):
        u_new = m * (u + grad_out)
        v_new = u_new + v + grad_out
    else:
        u_new = m * u + grad_out
        v_new = v + u_new
    thr = torch.quantile(v_new.abs().reshape(-1).float(),
                         torch.clamp(1.0 - ratio, 0.0, 1.0))
    encode = torch.where(v_new.abs() >= thr.to(v_new.dtype), v_new,
                         torch.zeros_like(v_new))
    use_dgc = step >= rampup_begin
    k = torch.where(use_dgc, ratio * v_new.numel(),
                    torch.tensor(float(v_new.numel()), device=g.device))
    return {"U_out": [torch.where(use_dgc, u_new, u)],
            "V_out": [torch.where(use_dgc, v_new - encode, v)],
            "EncodeGrad": [torch.where(use_dgc, encode, grad_out)],
            "Grad_out": [grad_out],
            "k": [k.float().reshape(1)],
            "GatherBuff": [torch.zeros_like(g)]}


@register_op("dgc_momentum")
def _dgc_momentum(ins, attrs, op):
    """ref dgc_momentum_op.h: Grad_out = g/nranks; before the rampup gate
    the momentum update, after it plain SGD (both on the original Grad)."""
    g, v = _one(ins, "Grad"), _one(ins, "Velocity")
    step = _scalar(_one(ins, "current_step"), g)
    nranks = _scalar(_one(ins, "nranks"), g, 1.0).to(g.dtype)
    mom = get_lowering("momentum")(ins, attrs, op)
    sgd = get_lowering("sgd")(ins, attrs, op)
    use_sgd = step >= float(attrs.get("rampup_begin_step", 0.0))
    return {"ParamOut": [torch.where(use_sgd, sgd["ParamOut"][0],
                                     mom["ParamOut"][0])],
            "VelocityOut": [torch.where(use_sgd, v,
                                        mom["VelocityOut"][0])],
            "Grad_out": [g / nranks]}


@register_op("dgc_clip_by_norm")
def _dgc_clip_by_norm(ins, attrs, op):
    """ref dgc_clip_by_norm_op.h: clip_by_norm once current_step reaches
    rampup_begin_step."""
    x = _one(ins, "X")
    step = _scalar(_one(ins, "current_step"), x)
    clipped = get_lowering("clip_by_norm")(ins, attrs, op)["Out"][0]
    return {"Out": [torch.where(
        step >= float(attrs.get("rampup_begin_step", 0.0)), clipped, x)]}


# =========================================================================
# root collectives (ref collective/c_reduce_op.h, c_scatter_op.cc,
# collective/barrier_op.cc)
# =========================================================================

def _data_axis():
    from ..parallel import collective as _coll

    return _coll.bound_data_axis()


def _c_reduce(op_name):
    def rule(ins, attrs, op):
        from ..parallel import collective as _coll

        x = _one(ins, "X")
        axis = _data_axis()
        if axis is None:
            return {"Out": [x]}
        root = int(attrs.get("root_id", attrs.get("root", 0)))
        red = _coll.all_reduce(x, op=op_name, group=axis, compress="none")
        # non-root members keep their input (c_reduce_op.h writes only the
        # root's receive buffer)
        return {"Out": [red if _coll.axis_index(axis) == root else x]}

    return rule


for _name, _red in (("c_reduce_sum", "sum"), ("c_reduce_max", "max"),
                    ("c_reduce_min", "min"), ("c_reduce_prod", "prod")):
    register_op(_name)(_c_reduce(_red))


@register_op("c_scatter")
def _c_scatter(ins, attrs, op):
    """ref c_scatter_op.cc: the root's (nranks*per, ...) buffer split along
    dim 0; member i receives slice i."""
    from ..parallel import collective as _coll

    x = _one(ins, "X")
    axis = _data_axis()
    if axis is None:
        return {"Out": [x]}
    root = int(attrs.get("root", attrs.get("root_id", 0)))
    xroot = _coll.broadcast(x, src=root, group=axis)
    n = int(attrs.get("nranks", 0)) or _coll.Group((axis,)).nranks
    per = x.shape[0] // n
    idx = _coll.axis_index(axis)
    return {"Out": [xroot[idx * per:(idx + 1) * per]]}


@register_op("barrier")
def _barrier(ins, attrs, op):
    """ref collective/barrier_op.cc: a rendezvous of the bound group (a
    zero all-reduce each input then adds); the identity with none."""
    from ..parallel import collective as _coll

    xs = ins.get("X", [])
    if not xs:
        return {}
    axis = _data_axis()
    if axis is None:
        return {"Out": list(xs)}
    token = _coll.all_reduce(torch.zeros((), dtype=xs[0].dtype,
                                         device=xs[0].device),
                             group=axis, compress="none")
    return {"Out": [x + token.to(x.dtype) for x in xs]}
