"""Hybrid-parallel ERNIE/BERT pretraining trainer (counterpart of
paddle_tpu/text/pretrainer.py).

The JAX package runs one pjit'd step over a dp x pp x ep x sp x tp mesh
and lets GSPMD insert the collectives.  In the port each rank is a
process holding its slices (``param_shardings`` / ``place_params``), and
the step writes the collectives out:

  dp, ep -- the batch dim is split over both (ep doubles as a batch dim
            outside the experts); gradients of parameters these ranks
            hold whole are summed over them, the loss's normaliser is
            the whole batch's;
  tp     -- Megatron: q/k/v and linear1 column-parallel, out_proj and
            linear2 row-parallel (``parallel.sharding.shard_layer`` over
            ``TRANSFORMER_RULES``), attention on the local heads; the
            word embedding and the tied MLM decoder split over the
            vocabulary, the MLM loss taken over logits split the same
            way;
  sp     -- the sequence dim is split; attention sees the whole sequence
            through Ulysses and runs the port's attention kernel, the
            MoE gating sees it through an all-gather, and the MLM head's
            rows (the first token, the masked positions, which index the
            whole sequence) are gathered from their ranks; gradients of
            the embeddings and blocks are summed over sp;
  pp     -- the blocks' parameters are stacked [L, ...] and split over pp;
            the encoder runs the GPipe schedule (``parallel.pipeline``) or,
            with fleet's ``pipeline_configs.schedule = "1f1b"``, the 1F1B
            one; embeddings and heads run on every stage;
  ep     -- with ``moe_experts`` > 0 every block is attention +
            ``nn.MoEFFN``, its experts split over ep (tokens reach them
            by all-to-all).

Fleet's ``sharding`` is ZeRO-1: each dp rank keeps and updates 1/dp of
every fp32 moment (the largest divisible dim of each parameter slice,
``sharding.zero_spec``), the gradients reduce-scattered to it and the
updated slices all-gathered back.
"""
from __future__ import annotations

import copy
from collections import defaultdict
from typing import Any, Dict, Optional

import torch

from .. import nn
from ..autograd import recompute as _recompute
from ..core import random as _random
from ..core.device import resolve_device
from ..parallel import collective as _coll
from ..parallel import mesh as _mesh
from ..parallel.pipeline import (
    blockwise_stage_fn,
    microbatch,
    pipeline_apply,
    pipeline_train_1f1b,
    stack_block_params,
    unmicrobatch,
)
from ..parallel.sharding import (
    PartitionSpec,
    TRANSFORMER_RULES,
    infer_sharding,
    place,
    shard_layer,
    unshard,
    zero_spec,
)
from .ernie import (
    ErnieConfig,
    ErnieEmbeddings,
    ErniePooler,
    ErniePretrainingCriterion,
    ErniePretrainingHeads,
)

__all__ = ["HybridPretrainer"]


class _MoEBlock(nn.Layer):
    """Encoder block whose FFN is expert-parallel (attention + MoEFFN)."""

    def __init__(self, cfg: ErnieConfig, num_experts: int, generator=None):
        super().__init__()
        self.self_attn = nn.MultiHeadAttention(
            cfg.hidden_size, cfg.num_attention_heads,
            dropout=cfg.attention_probs_dropout_prob, generator=generator)
        self.norm1 = nn.LayerNorm(cfg.hidden_size)
        self.norm2 = nn.LayerNorm(cfg.hidden_size)
        self.moe = nn.MoEFFN(cfg.hidden_size, cfg.intermediate_size,
                             num_experts=num_experts, top_k=2,
                             capacity_factor=2.0, generator=generator)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, x):
        x = self.norm1(x + self.dropout(self.self_attn(x)))
        x = self.norm2(x + self.dropout(self.moe(x)))
        return x


class _PretrainHead(nn.Layer):
    """Pooler + MLM / NSP heads (kept off the block stack).  ``forward``
    takes the rows the heads read: the first token, then the masked
    positions.  With ``vocab_axis`` set the decoder is this rank's slice
    of the vocabulary and the logits are split the same way."""

    def __init__(self, cfg: ErnieConfig, embedding_weight, generator=None):
        super().__init__()
        self.pooler = ErniePooler(cfg.hidden_size, generator)
        self.cls = ErniePretrainingHeads(cfg, embedding_weight, generator)
        self.vocab_axis = None

    def forward(self, rows):
        pooled = torch.tanh(self.pooler.dense(rows[:, 0]))
        pred = self.cls.predictions
        x = pred.layer_norm(pred.activation(pred.transform(rows[:, 1:])))
        w, bias = pred.decoder_weight, pred.decoder_bias
        if self.vocab_axis is not None:
            x = _coll.copy_to_group(x, self.vocab_axis)
            start = _coll.axis_index(self.vocab_axis) * w.shape[0]
            bias = bias[start:start + w.shape[0]]
        logits = torch.matmul(x, w.t()) + bias
        return logits, self.cls.seq_relationship(pooled)


class _CloneList(nn.Layer):
    """``num_layers`` copies of a block, each drawn anew."""

    def __init__(self, block, num_layers, generator=None):
        super().__init__()
        from ..nn.layer.transformer import _reinit

        clones = []
        for _ in range(num_layers):
            c = copy.deepcopy(block)
            _reinit(c, generator)
            clones.append(c)
        self.layers = nn.LayerList(clones)


def _params(layer) -> Dict[str, torch.Tensor]:
    return {k: p.detach() for k, p in layer.named_parameters()}


def _find_param(layer, name: str):
    return dict(layer.named_parameters()).get(name)


def _clean(spec, mesh, shape) -> PartitionSpec:
    out = []
    for i, a in enumerate(spec):
        if a is None or a not in mesh.axis_names or shape[i] % mesh.shape[a]:
            out.append(None)
        else:
            out.append(a)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def _size(axis, mesh) -> int:
    return _mesh.mesh_axis_size(axis, mesh)


def _vocab_parallel_ce(logits, labels, axis, start):
    """Per-row cross-entropy over logits split on the vocabulary over
    ``axis`` (this rank's columns start at ``start``; no split when
    ``axis`` is None): max and normaliser summed over the members, the
    label's logit taken on the member holding it."""
    with torch.no_grad():
        top = logits.amax(dim=-1)
        if axis is not None:
            top = _coll.all_reduce(top, op="max", group=axis)
    shifted = logits - top[:, None]
    total = shifted.exp().sum(dim=-1)
    cols = logits.shape[-1]
    local = labels.long() - start
    mine = (local >= 0) & (local < cols)
    picked = shifted.gather(1, local.clamp(0, cols - 1)[:, None])[:, 0]
    picked = picked * mine.to(picked.dtype)
    if axis is not None:
        total = _coll.all_reduce(total, group=axis)
        picked = _coll.all_reduce(picked, group=axis)
    return torch.log(total) - picked


class HybridPretrainer:
    """Parameters, their placement and a train step for ERNIE pretraining
    on the current hybrid mesh.

    The encoder stack is uniform: embeddings, pooler and heads live
    outside the pipeline (on every pp stage) and the blocks' parameters
    are stacked [L, ...] with the block dim split over pp.  Parameters are
    drawn on the CPU from ``generator``; the step runs on the mesh's
    device (``device`` when the mesh has none; the card by default).
    ``make_train_step``'s ``batch`` is this rank's (``place_batch``)."""

    _TIED = "cls.predictions.decoder_weight"
    _EMB = "word_embeddings.weight"

    def __init__(self, config: Optional[ErnieConfig] = None, *,
                 mesh=None, num_micro: int = 1, moe_experts: int = 0,
                 rules=TRANSFORMER_RULES, recompute: bool = False,
                 recompute_policy: Optional[str] = None, strategy=None,
                 device=None, generator: Optional[torch.Generator] = None):
        self.cfg = config or ErnieConfig()
        self.mesh = mesh or _mesh.current_mesh()
        self.num_micro = num_micro
        self.rules = rules
        self.moe_experts = moe_experts
        # fleet wiring: recompute(_configs) recomputes each block in the
        # backward (ref RecomputeOptimizer optimizer.py:4513)
        if strategy is not None and getattr(strategy, "recompute", False):
            recompute = True
            recompute_policy = strategy.recompute_configs.policy
        self.recompute = recompute or getattr(self.cfg, "enable_recompute",
                                              False)
        self.recompute_policy = recompute_policy
        # fleet wiring: PipelineConfig.schedule picks the pp schedule (ref
        # device_worker.h:415 SectionWorker's 1F1B vs GPipe)
        self.pp_schedule = "gpipe"
        if strategy is not None and getattr(strategy, "pipeline", False):
            sched = strategy.pipeline_configs.schedule
            if sched not in ("gpipe", "1f1b"):
                raise ValueError(
                    f"unknown pipeline schedule {sched!r}: use 'gpipe' or "
                    "'1f1b'")
            self.pp_schedule = sched
            if num_micro == 1:
                self.num_micro = strategy.pipeline_configs.micro_batch
        # fleet wiring: sequence_parallel needs an sp dim (> 1) to split
        # the sequence over; True without one would do nothing
        if strategy is not None and getattr(strategy, "sequence_parallel",
                                            False):
            if _size(_mesh.SP_AXIS, self.mesh) <= 1:
                raise ValueError(
                    "DistributedStrategy.sequence_parallel=True but the "
                    "mesh has no sp axis (>1); build the mesh with "
                    "sp_degree > 1 (hybrid_configs)")
        # fleet wiring: sharding (ZeRO-1) splits the fp32 optimizer state
        # over dp
        self.zero_sharding = bool(strategy is not None
                                  and getattr(strategy, "sharding", False))
        cfg = self.cfg
        gen = generator
        self.embeddings = ErnieEmbeddings(cfg, gen)
        if moe_experts:
            block = _MoEBlock(cfg, moe_experts, gen)
            self._stack = _CloneList(block, cfg.num_hidden_layers, gen)
        else:
            block = nn.TransformerEncoderLayer(
                cfg.hidden_size, cfg.num_attention_heads,
                cfg.intermediate_size, dropout=cfg.hidden_dropout_prob,
                activation=cfg.hidden_act,
                attn_dropout=cfg.attention_probs_dropout_prob,
                act_dropout=0.0, generator=gen)
            self._stack = nn.TransformerEncoder(block, cfg.num_hidden_layers,
                                                generator=gen)
        self.block_template = self._stack.layers[0]
        self.head = _PretrainHead(cfg, self.embeddings.word_embeddings.weight,
                                  gen)
        self.criterion = ErniePretrainingCriterion(cfg.vocab_size)
        self.device = self.mesh.device or resolve_device(device)
        self._local = None

    # -- parameters ---------------------------------------------------------
    def init_params(self) -> Dict[str, Any]:
        """{"embed", "blocks" (stacked [L, ...]), "head"}: whole fp32
        tensors on the CPU.  The MLM decoder is tied to the word embedding
        and kept once, under "embed"."""
        head = {k: v for k, v in _params(self.head).items()
                if k != self._TIED}
        return {"embed": _params(self.embeddings),
                "blocks": stack_block_params(
                    [_params(l) for l in self._stack.layers]),
                "head": head}

    def param_shardings(self, params) -> Dict[str, Any]:
        """The spec of every leaf, as the JAX package's
        ``param_shardings`` (annotation > rule; the blocks' leading dim
        over pp)."""
        m = self.mesh
        out = {"embed": infer_sharding(params["embed"], m, self.rules),
               "head": infer_sharding(params["head"], m, self.rules)}
        blk = {}
        for name, v in params["blocks"].items():
            p = _find_param(self.block_template, name)
            ann = getattr(p, "sharding_axes", None)
            ann = None if ann is None else tuple(ann)
            if ann is None:
                match = self.rules.match(name, v.dim() - 1)
                ann = match if match is not None else (None,) * (v.dim() - 1)
            blk[name] = _clean((_mesh.PP_AXIS,) + tuple(ann), m,
                               tuple(v.shape))
        out["blocks"] = blk
        return out

    def place_params(self, params):
        """This rank's slices of ``params`` on its device."""
        sh = self.param_shardings(params)
        return {g: {k: place(v, sh[g][k], self.mesh).to(self.device)
                    for k, v in params[g].items()} for g in params}

    def unshard_params(self, params):
        """The whole tensors from this rank's slices (on every rank)."""
        sh = self.param_shardings(self.init_params_shapes())
        return {g: unshard(params[g], sh[g], self.mesh) for g in params}

    def data_shardings(self, mesh=None) -> Dict[str, tuple]:
        """The spec of each batch leaf: tokens split over the batch dims
        (dp and ep) and the sequence over sp; the (b, n_mask) labels and
        indices and the (b,) NSP labels over the batch dims only (the
        masked positions index the whole sequence).  The JAX package
        splits the batch over dp alone (GSPMD runs the experts on every
        token there); the loss is the whole batch's either way."""
        m = mesh or self.mesh
        tok = _mesh.data_sharding(m, self._batch_axes(m), _mesh.SP_AXIS)
        rows = _mesh.data_sharding(m, self._batch_axes(m))
        return {"input_ids": tok, "token_type_ids": tok, "mlm_labels": rows,
                "nsp_labels": rows, "masked_positions": rows}

    def place_batch(self, batch):
        """This rank's slice of a whole batch, on its device."""
        sh = self.data_shardings()
        return {k: place(v, sh[k], self.mesh).to(self.device)
                for k, v in batch.items()}

    @staticmethod
    def _batch_axes(m):
        return tuple(a for a in (_mesh.DP_AXIS, _mesh.EP_AXIS)
                     if _size(a, m) > 1)

    # -- the rank's modules --------------------------------------------------
    def _modules(self):
        """This rank's embeddings, block and head: tensor-parallel layers
        under tp, the sequence dim named under sp; their own parameters
        are not used (the step binds the placed ones)."""
        if self._local is None:
            m, sp = self.mesh, _size(_mesh.SP_AXIS, self.mesh)
            embed = shard_layer(copy.deepcopy(self.embeddings), m, self.rules)
            block = shard_layer(copy.deepcopy(self.block_template), m,
                                self.rules)
            for mod in block.modules():
                if hasattr(mod, "seq_axis") and sp > 1:
                    mod.seq_axis = _mesh.SP_AXIS
            head = copy.deepcopy(self.head)
            tied = self.param_shardings(self.init_params_shapes())["embed"][
                self._EMB]
            if tuple(tied) and tied[0] is not None:
                head.vocab_axis = tied[0]
            self._local = tuple(x.to(self.device)
                                for x in (embed, block, head))
        return self._local

    def init_params_shapes(self):
        """Zero-size stand-ins with the whole shapes (for spec lookups)."""
        return {"embed": {k: torch.empty(v.shape, device="meta")
                          for k, v in _params(self.embeddings).items()},
                "blocks": {k: torch.empty(
                    (self.cfg.num_hidden_layers,) + tuple(v.shape),
                    device="meta")
                    for k, v in _params(self.block_template).items()},
                "head": {k: torch.empty(v.shape, device="meta")
                         for k, v in _params(self.head).items()
                         if k != self._TIED}}

    # -- forward ------------------------------------------------------------
    def _block_fn(self):
        _, block, _ = self._modules()

        def block_fn(blk, x):
            return torch.func.functional_call(block, blk, (x,))

        if not self.recompute:
            return block_fn

        def remat(blk, x):
            names = list(blk)

            def run(x, *bound):
                return block_fn(dict(zip(names, bound)), x)

            return _recompute(run, x, *[blk[k] for k in names],
                              policy=self.recompute_policy)

        return remat

    def _embed(self, embed_params, batch):
        embed, _, _ = self._modules()
        ids = batch["input_ids"]
        b, s = ids.shape
        start = _coll.axis_index(_mesh.SP_AXIS) * s \
            if _size(_mesh.SP_AXIS, self.mesh) > 1 else 0
        pos = (start + torch.arange(s, device=ids.device)).expand(b, s)
        return torch.func.functional_call(
            embed, embed_params, (ids, batch["token_type_ids"], pos))

    def _encode(self, blocks, h):
        """The encoder stack: the GPipe schedule over pp when pp > 1."""
        stage = blockwise_stage_fn(self._block_fn())
        if _size(_mesh.PP_AXIS, self.mesh) == 1:
            return stage(blocks, h)
        ys = pipeline_apply(stage, blocks, microbatch(h, self.num_micro),
                            axis=_mesh.PP_AXIS)
        return unmicrobatch(ys)

    def _head_rows(self, h, positions):
        """[b, 1 + n_mask, hidden]: the first token's row, then the masked
        positions' (whole-sequence indices), each from the sp rank that
        holds it, on every sp rank."""
        b, s, d = h.shape
        if positions is None:
            positions = torch.arange(s * _size(_mesh.SP_AXIS, self.mesh),
                                     device=h.device).expand(b, -1)
        idx = torch.cat([positions.new_zeros((b, 1)), positions.long()], 1)
        if _size(_mesh.SP_AXIS, self.mesh) == 1:
            return torch.gather(h, 1, idx[..., None].expand(-1, -1, d))
        idx = idx - _coll.axis_index(_mesh.SP_AXIS) * s
        mine = (idx >= 0) & (idx < s)
        rows = torch.gather(h, 1, idx.clamp(0, s - 1)[..., None].expand(
            -1, -1, d)) * mine[..., None].to(h.dtype)
        return _coll.all_reduce(rows, group=_mesh.SP_AXIS)

    def _criterion(self, logits, nsp, mlm_labels, nsp_labels):
        """MLM cross-entropy (labels of -1 ignored) + NSP cross-entropy,
        each the mean over the whole batch; every rank holds the loss, its
        backward this rank's part."""
        _, _, head = self._modules()
        axes = self._batch_axes(self.mesh)
        axis = head.vocab_axis
        start = 0 if axis is None else \
            _coll.axis_index(axis) * logits.shape[-1]
        labels = mlm_labels.reshape(-1)
        valid = labels != -1
        mlm = _vocab_parallel_ce(logits.reshape(-1, logits.shape[-1]),
                                 labels.clamp_min(0), axis, start)
        count = valid.sum().float()
        rows = torch.tensor(float(nsp.shape[0]), device=nsp.device)
        if axes:
            with torch.no_grad():
                count = _coll.all_reduce(count, group=axes)
                rows = _coll.all_reduce(rows, group=axes)
        nsp_ce = _vocab_parallel_ce(nsp, nsp_labels.reshape(-1), None, 0)
        loss = (mlm * valid).sum() / count + nsp_ce.sum() / rows
        return _coll.all_reduce(loss, group=axes) if axes else loss

    def _heads(self, head_params, h, batch):
        _, _, head = self._modules()
        rows = self._head_rows(h, batch.get("masked_positions"))
        logits, nsp = torch.func.functional_call(head, head_params, (rows,))
        return self._criterion(logits.float(), nsp.float(),
                               batch["mlm_labels"], batch["nsp_labels"])

    def _forward(self, params, batch, tied):
        """The loss, the MLM decoder bound to ``tied``."""
        h = self._embed(params["embed"], batch)
        h = self._encode(params["blocks"], h)
        return self._heads(dict(params["head"], **{self._TIED: tied}), h,
                           batch)

    def loss_fn(self, params, batch, generator: torch.Generator):
        """The whole batch's pretraining loss from this rank's parameter
        and batch slices (GPipe over pp)."""
        with _random.rng_scope(generator):
            return self._forward(params, batch, params["embed"][self._EMB])

    # -- gradients ----------------------------------------------------------
    def _reduce_axes(self, params):
        """{(group, name): the mesh dims its gradient is summed over}: the
        batch dims for every leaf, sp for the embeddings and blocks (the
        heads run on every sp rank), tp for the decoder bias (each tp rank
        adds its slice), less the dims splitting the leaf."""
        m = self.mesh
        batch = self._batch_axes(m)
        seq = (_mesh.SP_AXIS,) if _size(_mesh.SP_AXIS, m) > 1 else ()
        sh = self.param_shardings(self.init_params_shapes())
        out = {("head", self._TIED): batch}
        for g, leaves in params.items():
            for k in leaves:
                if (g, k) in out:
                    continue
                axes = batch + (seq if g != "head" else ())
                if g == "head" and k == "cls.predictions.decoder_bias" and \
                        self._modules()[2].vocab_axis is not None:
                    axes = axes + (self._modules()[2].vocab_axis,)
                split = {x for a in sh[g][k] if a is not None
                         for x in (a if isinstance(a, tuple) else (a,))}
                out[(g, k)] = tuple(a for a in _mesh._CANONICAL_ORDER
                                    if a in axes and a not in split)
        return out

    def _zero_dims(self, params):
        """{(group, name): the dim of this rank's slice that ZeRO-1 splits
        over dp, or None}."""
        if not self.zero_sharding or _size(_mesh.DP_AXIS, self.mesh) <= 1:
            return {}
        out = {}
        for g, leaves in params.items():
            for k, v in leaves.items():
                spec = zero_spec(tuple(v.shape), self.mesh, _mesh.DP_AXIS)
                out[(g, k)] = next((i for i, a in enumerate(spec)
                                    if a is not None), None)
        return out

    @torch.no_grad()
    def _sync(self, grads, zero_dims):
        """Sum each gradient over its dims (one flat all-reduce per set of
        dims); a ZeRO-1 leaf's dp sum is a reduce-scatter to this rank's
        slice."""
        if not hasattr(self, "_axes"):
            self._axes = self._reduce_axes(grads)
        sets = defaultdict(list)
        for g, leaves in grads.items():
            for k in leaves:
                axes = self._axes[(g, k)]
                if zero_dims.get((g, k)) is not None:
                    axes = tuple(a for a in axes if a != _mesh.DP_AXIS)
                sets[axes].append((g, k))
        out = {g: dict(v) for g, v in grads.items()}
        for axes, keys in sets.items():
            if not axes:
                continue
            flat = torch.cat([grads[g][k].reshape(-1) for g, k in keys])
            flat = _coll.all_reduce(flat, group=axes)
            at = 0
            for g, k in keys:
                n = grads[g][k].numel()
                out[g][k] = flat[at:at + n].view_as(grads[g][k])
                at += n
        for (g, k), dim in zero_dims.items():
            if dim is not None:
                out[g][k] = _coll.reduce_scatter(out[g][k],
                                                 group=_mesh.DP_AXIS, axis=dim)
        return out

    # -- train step ---------------------------------------------------------
    def init_opt_state(self, optimizer, params):
        """``optimizer.init`` over this rank's parameter slices (their
        dp slices under ZeRO-1), keyed "<group>/<name>"."""
        zero = self._zero_dims(params)
        flat = {}
        for g, leaves in params.items():
            for k, v in leaves.items():
                dim = zero.get((g, k))
                if dim is not None:
                    v = place(v, (None,) * dim + (_mesh.DP_AXIS,), self.mesh)
                flat[f"{g}/{k}"] = v
        return optimizer.init(flat)

    def _update(self, optimizer, grads, opt_state, params, zero):
        flat_g, flat_p = {}, {}
        for g, leaves in params.items():
            for k, v in leaves.items():
                dim = zero.get((g, k))
                grad = grads[g][k].to(v.dtype)
                if dim is not None:
                    v = place(v, (None,) * dim + (_mesh.DP_AXIS,),
                              self.mesh).clone()
                flat_g[f"{g}/{k}"], flat_p[f"{g}/{k}"] = grad, v
        new_flat, new_state = optimizer.update(flat_g, opt_state, flat_p)
        out = {}
        for g, leaves in params.items():
            out[g] = {}
            for k, v in leaves.items():
                new = new_flat[f"{g}/{k}"]
                dim = zero.get((g, k))
                if dim is not None:
                    with torch.no_grad():
                        new = _coll.all_gather(new, group=_mesh.DP_AXIS,
                                               axis=dim)
                if new is not v:
                    with torch.no_grad():
                        v.copy_(new)
                out[g][k] = v
        return out, new_state

    def _cast(self, params, compute_dtype):
        if compute_dtype == torch.float32:
            return params
        return {g: {k: v.to(compute_dtype) if v.is_floating_point() else v
                    for k, v in leaves.items()}
                for g, leaves in params.items()}

    def make_train_step(self, optimizer, compute_dtype=torch.float32):
        """``train_step(params, opt_state, batch, generator) -> (params,
        opt_state, loss)``: ``params`` this rank's fp32 slices
        (``place_params``), ``opt_state`` from ``init_opt_state``,
        ``batch`` this rank's (``place_batch``), ``generator`` a CPU
        ``torch.Generator`` for the dropout draws.  The loss is the whole
        batch's (a detached fp32 scalar); the parameters are updated in
        place and returned."""
        if self.pp_schedule == "1f1b" and \
                _size(_mesh.PP_AXIS, self.mesh) > 1:
            grads_of = self._grads_1f1b
        else:
            grads_of = self._grads_gpipe

        def train_step(params, opt_state, batch, generator):
            zero = self._zero_dims(params)
            loss, grads = grads_of(params, batch, generator, compute_dtype)
            grads = self._sync(grads, zero)
            tied = grads["head"].pop(self._TIED)
            grads["embed"][self._EMB] = grads["embed"][self._EMB] + (
                tied if zero.get(("embed", self._EMB)) is None else
                place(tied, (None,) * zero[("embed", self._EMB)]
                      + (_mesh.DP_AXIS,), self.mesh))
            new_params, new_state = self._update(optimizer, grads, opt_state,
                                                 params, zero)
            return new_params, new_state, loss.detach().float()

        return train_step

    def _leaves(self, params):
        return {g: {k: v.detach().requires_grad_(v.is_floating_point())
                    for k, v in leaves.items()}
                for g, leaves in params.items()}

    def _grads_gpipe(self, params, batch, generator, compute_dtype):
        """The loss and every leaf's gradient (the tied decoder's under
        ("head", _TIED), before the sums over ranks)."""
        leaves = self._leaves(params)
        p = self._cast(leaves, compute_dtype)
        # the decoder's use of the tied weight is its own leaf: its
        # gradient is summed over other mesh dims than the lookup's
        tied = p["embed"][self._EMB].detach().requires_grad_(True)
        with _random.rng_scope(generator):
            loss = self._forward(p, batch, tied)
        order = [(g, k) for g in leaves for k in leaves[g]]
        got = torch.autograd.grad(
            loss, [leaves[g][k] for g, k in order] + [tied],
            allow_unused=True)
        grads = {g: {} for g in leaves}
        for (g, k), gr in zip(order, got):
            grads[g][k] = torch.zeros_like(leaves[g][k]) if gr is None \
                else gr
        grads["head"][self._TIED] = got[-1].float()
        return loss, grads

    def _grads_1f1b(self, params, batch, generator, compute_dtype):
        """1F1B (ref SectionWorker device_worker.h:415): per-micro-batch
        loss on the last stage inside the pipeline, each micro-batch's
        backward as soon as its cotangent arrives.  A stage's forward and
        its replay in the backward draw the same dropout masks: both run
        under a generator seeded from the step's generator and the
        micro-batch index alone."""
        leaves = self._leaves(params)
        p = self._cast(leaves, compute_dtype)
        base = int(torch.randint(0, 2 ** 62, (1,), generator=generator))

        def gen(salt):
            return torch.Generator().manual_seed(base + salt)

        stage = blockwise_stage_fn(self._block_fn())

        def stage_fn(blk, x, b):
            with _random.rng_scope(gen(2 * b + 2)):
                return stage(blk, x)

        def loss_fn(hp, y, tgt, b):
            with _random.rng_scope(gen(2 * b + 3)):
                return self._heads(hp, y, tgt)

        with _random.rng_scope(gen(0)):
            h = self._embed(p["embed"], batch)
        xs = microbatch(h.detach(), self.num_micro)
        targets = {k: microbatch(batch[k], self.num_micro)
                   for k in ("masked_positions", "mlm_labels", "nsp_labels")
                   if batch.get(k) is not None}
        head_params = dict(p["head"])
        head_params[self._TIED] = p["embed"][self._EMB].detach()
        loss, sgrads, hgrads, dxs = pipeline_train_1f1b(
            stage_fn, loss_fn, {k: v.detach() for k, v in
                                p["blocks"].items()},
            {k: v.detach() for k, v in head_params.items()}, xs, targets,
            axis=_mesh.PP_AXIS)
        names = list(leaves["embed"])
        got = torch.autograd.grad(h, [leaves["embed"][k] for k in names],
                                  unmicrobatch(dxs).to(h.dtype))
        grads = {"embed": dict(zip(names, got)),
                 "blocks": {k: g.float() for k, g in sgrads.items()},
                 "head": {k: g.float() for k, g in hgrads.items()}}
        return loss, grads
