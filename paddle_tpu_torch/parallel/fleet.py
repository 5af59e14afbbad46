"""Fleet: the unified distributed-training facade (counterpart of
paddle_tpu/parallel/fleet.py).

Reference parity: python/paddle/distributed/fleet/base/fleet_base.py:41
(``Fleet.init`` :103, ``distributed_optimizer`` :540), the protobuf
``DistributedStrategy`` (framework/distributed_strategy.proto:94) and the
meta-optimizer chain (meta_optimizers/: amp, gradient_merge, lars, lamb,
localsgd, dgc).

The JAX package's design, kept: ``DistributedStrategy`` is a typed
dataclass tree; ``init`` builds the mesh; ``distributed_optimizer``
composes the strategy into a ``DistributedOptimizer`` with the port's
functional ``init`` / ``update`` contract (``optimizer/optimizer.py``:
in-place updates of a {name: tensor} dict), so the meta-optimizer chain is
function composition inside one eager step:

  - comm_quantize  -> the optimizer owns a bucketed (optionally quantized)
                      gradient sync over dp (parallel/compress.py)
  - amp            -> dynamic loss scale: unscale, skip the step on a
                      non-finite gradient (amp_configs)
  - gradient_merge -> k-step gradient accumulation carried in the state
  - localsgd       -> every k steps the parameters are averaged over dp
  - lars/lamb      -> swap the inner optimizer rule
  - dgc            -> top-k sparsify + momentum correction + error
                      feedback per replica, the sparse tensor averaged over
                      dp, applied as SGD (ref dgc_op.cc +
                      sparse_all_reduce_op_handle.cc)

The hybrid switches are read by ``text.pretrainer.HybridPretrainer``:
``hybrid_configs`` degrees build the mesh in ``init``; ``pipeline``
(``pipeline_configs.schedule`` "gpipe" or "1f1b", ``micro_batch``),
``sequence_parallel`` (the mesh must carry ``sp`` > 1), ``sharding``
(ZeRO-1: each dp rank keeps and updates 1/dp of every fp32 moment) and
``recompute``.

``elastic`` with ``elastic_configs`` (``ElasticConfig``) sets the
``elastic_*`` flags in ``init``, so ``hapi.Model.fit`` writes periodic
elastic checkpoints (elastic/checkpoint.py).

Not in the port yet, each raising ``NotImplementedError``:
``embedding_plan_kwargs`` and ``auto_shard_plan``, which price and lower
static programs (ROADMAP.md Queue 1 item 9b).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..distributed import env as _env
from . import collective as _coll
from . import compress as _compress
from . import mesh as _mesh


@dataclasses.dataclass
class RecomputeConfig:  # proto :25 RecomputeConfig
    checkpoints: tuple = ()
    policy: str = "dots_saveable"


@dataclasses.dataclass
class GradientMergeConfig:  # proto GradientMergeConfig
    k_steps: int = 1
    avg: bool = True


@dataclasses.dataclass
class LocalSGDConfig:  # proto :39 LocalSGDConfig
    k_steps: int = 1


@dataclasses.dataclass
class AMPConfig:  # contrib/mixed_precision decorator.py:218 knobs
    dtype: str = "bfloat16"
    init_loss_scaling: float = 1.0  # bf16 needs no scaling; >1 enables it
    incr_every_n_steps: int = 1000
    decr_every_n_nan_or_inf: int = 2
    incr_ratio: float = 2.0
    decr_ratio: float = 0.5
    use_dynamic_loss_scaling: bool = False


@dataclasses.dataclass
class PipelineConfig:  # proto :92 PipelineConfig
    micro_batch: int = 1
    schedule: str = "gpipe"  # or "1f1b"


@dataclasses.dataclass
class HybridConfig:
    dp_degree: int = -1
    mp_degree: int = 1   # tensor parallel ("mp" in fleet naming)
    pp_degree: int = 1
    sp_degree: int = 1   # sequence/context parallel
    ep_degree: int = 1


@dataclasses.dataclass
class ShardingConfig:  # ZeRO; fleet "sharding" strategy
    stage: int = 1


@dataclasses.dataclass
class DGCConfig:  # proto :47 DGCConfig
    rampup_begin_step: int = 0
    sparsity: float = 0.999
    momentum: float = 0.9


@dataclasses.dataclass
class ElasticConfig:
    """Elastic fault-tolerance knobs (ref: the fleet elastic manager + the
    incubate checkpoint saver; paddle_tpu_torch/elastic/).  ``save_every``
    > 0 with a ``ckpt_dir`` turns on periodic elastic checkpoints inside
    hapi ``Model.fit`` (through the elastic_* flags); ``heartbeat_s`` /
    ``dead_after_s`` size an ``elastic.ElasticMember``."""
    ckpt_dir: str = ""
    save_every: int = 0
    keep_last: int = 2
    heartbeat_s: float = 0.5
    dead_after_s: float = 3.0


@dataclasses.dataclass
class CommConfig:
    """Gradient-sync communication knobs (parallel/compress.py): bucket
    size (the reducer.cc ``comm_buffer_size`` analogue), quantized payload
    block size, and hierarchical (intra-host/inter-host) scheduling
    ("auto" factors by the ranks of a host; "off" forces flat; an int is
    the intra-group size)."""
    block_size: int = 256
    buffer_size_mb: float = 25.0
    hierarchical: Any = "auto"


@dataclasses.dataclass
class EmbeddingConfig:
    """Vocab-sharded embedding knobs (ROADMAP.md Queue 1 item 9b)."""
    axis: str = _mesh.TP_AXIS
    capacity_factor: Any = None
    quantize: str = ""


class DistributedStrategy:
    """Typed strategy object (ref proto distributed_strategy.proto:94)."""

    def __init__(self):
        self.amp = False
        self.amp_configs = AMPConfig()
        self.recompute = False
        self.recompute_configs = RecomputeConfig()
        self.gradient_merge = False
        self.gradient_merge_configs = GradientMergeConfig()
        self.localsgd = False
        self.localsgd_configs = LocalSGDConfig()
        self.lars = False
        self.lamb = False
        self.dgc = False
        self.dgc_configs = DGCConfig()
        self.sharding = False
        self.sharding_configs = ShardingConfig()
        self.pipeline = False
        self.pipeline_configs = PipelineConfig()
        self.hybrid_configs = HybridConfig()
        self.elastic = False
        self.elastic_configs = ElasticConfig()
        self.sequence_parallel = False
        # Gradient-sync ownership: "" leaves sync to the train-step builder
        # (DataParallel); "none" makes update() own a bucketed
        # full-precision sync; "int8"/"fp8" additionally quantize the wire
        # payload (EQuARX-style, parallel/compress.py).
        self.comm_quantize = ""
        self.comm_configs = CommConfig()
        self.sharded_embedding = False
        self.embedding_configs = EmbeddingConfig()
        self.auto_shard = False
        self.find_unused_parameters = False  # parity no-op
        self.fuse_all_reduce_ops = True      # parity no-op (buckets fuse)
        self.nccl_comm_num = 1               # parity no-op

    def __repr__(self):
        on = [k for k, v in self.__dict__.items() if v is True]
        return f"DistributedStrategy(enabled={on})"


def embedding_plan_kwargs(strategy: DistributedStrategy) -> Dict[str, Any]:
    """``ShardingPlan`` kwargs for a strategy's sharded-embedding knobs:
    empty when ``strategy.sharded_embedding`` is off; the sharded
    embedding and ``ShardingPlan`` come with ROADMAP.md Queue 1 item 9b."""
    if not getattr(strategy, "sharded_embedding", False):
        return {}
    raise NotImplementedError(
        "sharded embeddings and ShardingPlan come with ROADMAP.md Queue 1 "
        "item 9b")


def auto_shard_plan(program, strategy: Optional[DistributedStrategy] = None,
                    mesh=None, feed=None, fetch_names=()):
    """None when ``strategy.auto_shard`` is off (callers fall through to
    hand-written knobs); the plan search comes with ROADMAP.md Queue 1
    item 9b."""
    if strategy is not None and not getattr(strategy, "auto_shard", False):
        return None
    raise NotImplementedError(
        "the auto-sharding plan search comes with ROADMAP.md Queue 1 "
        "item 9b")


class _RoleMaker:
    """Env-var role maker (ref: fleet/base/role_maker.py:220
    PaddleCloudRoleMaker -- the PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM
    contract, read through distributed/env.py)."""

    def worker_index(self) -> int:
        return _env.get_rank()

    def worker_num(self) -> int:
        return _env.get_world_size()

    def is_first_worker(self) -> bool:
        return self.worker_index() == 0

    def is_worker(self) -> bool:
        return True

    def is_server(self) -> bool:
        # the parameter server is host tables served over TCP
        # (distributed/ps_server.py), not a fleet role
        return False


class Fleet:
    """ref: fleet_base.py:41.  Singleton: paddle_tpu_torch.distributed.fleet."""

    def __init__(self):
        self._role_maker: Optional[_RoleMaker] = None
        self._strategy: Optional[DistributedStrategy] = None
        self._mesh = None

    # -- lifecycle -----------------------------------------------------------
    def init(self, role_maker=None, is_collective: bool = True,
             strategy: Optional[DistributedStrategy] = None) -> "Fleet":
        self._role_maker = role_maker or _RoleMaker()
        self._strategy = strategy or DistributedStrategy()
        hc = self._strategy.hybrid_configs
        if not isinstance(hc, HybridConfig):  # allow dict like fleet does
            hc = HybridConfig(**{k: v for k, v in dict(hc).items()
                                 if k in HybridConfig.__dataclass_fields__})
            self._strategy.hybrid_configs = hc
        self._mesh = _mesh.init_parallel_env(
            dp=None if hc.dp_degree == -1 else hc.dp_degree,
            pp=hc.pp_degree, tp=hc.mp_degree, sp=hc.sp_degree,
            ep=hc.ep_degree)
        ec = self._strategy.elastic_configs
        if self._strategy.elastic and ec.save_every > 0 and ec.ckpt_dir:
            # surface the cadence through the flags Model.fit reads, so
            # strategy-driven jobs get periodic elastic checkpoints without
            # touching their fit() call
            from ..core import flags as _flags

            _flags.set_flags({"elastic_save_every": int(ec.save_every),
                              "elastic_ckpt_dir": ec.ckpt_dir,
                              "elastic_keep_last": int(ec.keep_last)})
        return self

    @property
    def mesh(self):
        return self._mesh or _mesh.current_mesh()

    @property
    def strategy(self):
        return self._strategy

    # -- role queries (ref fleet_base worker_* API) ---------------------------
    def worker_index(self):
        return self._role().worker_index()

    def worker_num(self):
        return self._role().worker_num()

    def is_first_worker(self):
        return self._role().is_first_worker()

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def barrier_worker(self):
        _coll.barrier()

    def _role(self):
        if self._role_maker is None:
            self.init()
        return self._role_maker

    # -- optimizer -----------------------------------------------------------
    def distributed_optimizer(self, optimizer, strategy=None):
        strategy = strategy or self._strategy or DistributedStrategy()
        self._strategy = strategy
        return DistributedOptimizer(optimizer, strategy)


def _zeros32(tree):
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in tree.items()}


class DistributedOptimizer:
    """Strategy-composed optimizer (the meta-optimizer chain as function
    composition) with the port's ``init`` / ``update`` contract over a
    {name: tensor} dict: ``update`` changes the parameters (and the inner
    optimizer's slots) in place and returns them with the new state."""

    def __init__(self, inner, strategy: DistributedStrategy):
        from ..optimizer.optimizers import SGD, Lamb, LarsMomentum
        self.strategy = strategy
        cq = getattr(strategy, "comm_quantize", "")
        if cq not in ("", "none") and cq not in _compress.COMPRESS_KINDS:
            raise ValueError(
                f"DistributedStrategy.comm_quantize={cq!r}; expected '' "
                f"(builder-owned sync), 'none', or one of "
                f"{_compress.COMPRESS_KINDS}")
        # Pass the raw _lr through so an LRScheduler keeps scheduling.
        if strategy.lamb and not isinstance(inner, Lamb):
            inner = Lamb(learning_rate=inner._lr,
                         parameters=inner._parameters)
        elif strategy.lars and not isinstance(inner, LarsMomentum):
            inner = LarsMomentum(learning_rate=inner._lr,
                                 parameters=inner._parameters)
        if strategy.dgc:
            # DGC's momentum correction folds momentum into the compressed
            # velocity (ref DGCMomentumOptimizer, fluid/optimizer.py:1176):
            # the inner update must be plain SGD or momentum compounds.
            self._dgc_momentum = getattr(
                inner, "momentum", strategy.dgc_configs.momentum)
            if not isinstance(inner, SGD):
                inner = SGD(learning_rate=inner._lr,
                            parameters=inner._parameters)
        self.inner = inner
        self._state = None

    # passthrough niceties
    def get_lr(self, step=None):
        return self.inner.get_lr(step)

    @property
    def _parameters(self):
        return self.inner._parameters

    def init(self, params) -> Dict[str, Any]:
        state = {"inner": self.inner.init(params)}
        if self.strategy.dgc:
            state["dgc"] = {"velocity": _zeros32(params),
                            "error": _zeros32(params)}
        gm = self.strategy.gradient_merge_configs
        if self.strategy.gradient_merge and gm.k_steps > 1:
            state["acc"] = _zeros32(params)
            state["acc_count"] = 0
        if (self.strategy.amp and
                self.strategy.amp_configs.use_dynamic_loss_scaling):
            state["loss_scale"] = torch.tensor(
                self.strategy.amp_configs.init_loss_scaling,
                dtype=torch.float32)
            state["good_steps"] = 0
        return state

    @torch.no_grad()
    def update(self, grads, state, params, lr=None):
        """Composes: [owned sync] -> [unscale + skip on non-finite] ->
        [dgc] -> [k-step merge] -> inner update -> [localsgd average]."""
        new_state = dict(state)
        cfg = self.strategy

        if getattr(cfg, "comm_quantize", "") and not cfg.dgc:
            # Owned gradient sync: bucketed, optionally quantized mean
            # all-reduce over dp, on the still-scaled grads (blockwise
            # quantization is loss-scale invariant, and a non-finite grad on
            # any replica reaches every replica through the mean, so all
            # take the same skip below).  One member: nothing to sync.
            axis = _coll.bound_data_axis()
            if axis is not None:
                cc = cfg.comm_configs
                grads = _compress.sync_gradients(
                    grads, axis,
                    compress=None if cfg.comm_quantize == "none"
                    else cfg.comm_quantize,
                    block_size=cc.block_size, buffer_mb=cc.buffer_size_mb,
                    hierarchy=cc.hierarchical)

        if "loss_scale" in state:
            scale = state["loss_scale"]
            grads = {k: g.to(torch.promote_types(g.dtype, torch.float32))
                     / scale.to(g.device) for k, g in grads.items()}
            finite = all(bool(torch.isfinite(g).all())
                         for g in grads.values())
            ac = cfg.amp_configs
            good = state["good_steps"] + 1 if finite else 0
            if finite and good >= ac.incr_every_n_steps:
                scale = scale * ac.incr_ratio
            elif not finite:
                scale = scale * ac.decr_ratio
            new_state["loss_scale"] = scale
            new_state["good_steps"] = 0 if good >= ac.incr_every_n_steps \
                else good
            if not finite:
                # Skip-step semantics of update_loss_scaling
                # (mixed_precision/decorator.py:169): parameters and every
                # other slot stay as they were (zeroed grads would still
                # move them through weight decay or momentum).
                return params, new_state

        if cfg.dgc and "dgc" in state:
            grads = self._dgc(grads, state, new_state)

        if cfg.gradient_merge and "acc" in state:
            k = cfg.gradient_merge_configs.k_steps
            acc = {n: a + grads[n].float() for n, a in state["acc"].items()}
            count = state["acc_count"] + 1
            if count >= k:
                merged = ({n: a / k for n, a in acc.items()}
                          if cfg.gradient_merge_configs.avg else acc)
                params, new_state["inner"] = self.inner.update(
                    merged, state["inner"], params, lr=lr)
                new_state["acc"] = {n: torch.zeros_like(a)
                                    for n, a in acc.items()}
                new_state["acc_count"] = 0
            else:
                new_state["acc"] = acc
                new_state["acc_count"] = count
        else:
            params, new_state["inner"] = self.inner.update(
                grads, state["inner"], params, lr=lr)

        if cfg.localsgd:
            axis = _coll.bound_data_axis()
            step = new_state["inner"].get("step")
            if axis is not None and step is not None \
                    and step % cfg.localsgd_configs.k_steps == 0:
                for p in params.values():
                    p.copy_(_compress.optimized_all_reduce(
                        p, axis, hierarchy="off", mean=True))
        return params, new_state

    def _dgc(self, grads, state, new_state):
        """ref dgc_op.cc + sparse_all_reduce_op_handle.cc: each replica
        compresses its LOCAL gradient (momentum correction + error feedback
        + top-k), only the sparse tensor is averaged over dp, and it is the
        update (the inner optimizer is SGD; momentum is folded in).  Before
        ``rampup_begin_step`` (counted in inner steps): plain momentum SGD
        on the same velocity slot."""
        from ..optimizer.extras import dgc_compress

        dc = self.strategy.dgc_configs
        step = state["inner"].get("step", 0)
        rampup = int(dc.rampup_begin_step)
        mom = self._dgc_momentum
        sparse, velocity, error = {}, {}, {}
        for k, g in grads.items():
            g32, v, e = (g.float(), state["dgc"]["velocity"][k],
                         state["dgc"]["error"][k])
            if rampup <= 0 or step >= rampup:
                sparse[k], velocity[k], error[k] = dgc_compress(
                    g32, v, e, dc.sparsity, mom)
            else:
                v_warm = mom * v + g32
                sparse[k], velocity[k], error[k] = v_warm, v_warm, e
        new_state["dgc"] = {"velocity": velocity, "error": error}
        axis = _coll.bound_data_axis()
        if axis is None:
            return sparse
        cq = getattr(self.strategy, "comm_quantize", "")
        cc = self.strategy.comm_configs
        if cq in _compress.COMPRESS_KINDS:
            return {k: _compress.optimized_all_reduce(
                s, axis, compress=cq, block_size=cc.block_size,
                hierarchy=cc.hierarchical, mean=True)
                for k, s in sparse.items()}
        return {k: _compress.optimized_all_reduce(s, axis, hierarchy="off",
                                                  mean=True)
                for k, s in sparse.items()}

    # Stateful facade (dygraph-style step) mirrors Optimizer.step.
    def step(self, grads=None):
        """Apply ``grads`` (a list aligned with the bound parameters, or a
        dict in that order; default: their ``.grad`` from
        ``loss.backward()``) to the bound parameters in place."""
        params = self.inner._param_list()
        if grads is None:
            if all(p.grad is None for p in params):
                raise ValueError("no parameter has a gradient; call "
                                 "loss.backward() first (or pass grads)")
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
        elif isinstance(grads, dict):
            grads = list(grads.values())
        named = {str(i): p for i, p in enumerate(params)}
        if self._state is None:
            self._state = self.init(named)
        _, self._state = self.update(
            {str(i): g for i, g in enumerate(grads)}, self._state, named)

    def clear_grad(self):
        self.inner.clear_grad()

    def state_dict(self):
        return {"state": self._state}


fleet = Fleet()
