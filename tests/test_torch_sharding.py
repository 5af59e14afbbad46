"""Sharding specs of the port against the JAX package's.

For each mesh (sizes only here: no process group), the spec the port
derives for a name and shape equals the ``PartitionSpec`` the JAX function
returns for it, with the same precedence (annotation > rule > ZeRO):
``infer_sharding`` over an ERNIE block's, embeddings' and an MoE FFN's
parameters with ``TRANSFORMER_RULES`` (zero stages 0 and 3),
``zero_spec``, ``layer_annotations``, and ``HybridPretrainer.
param_shardings`` on the five meshes the hybrid tests run.  Plus the rule
table's axis-name check, ``place`` and the tensor-parallel layer swap of
``shard_layer`` (exact).
"""
import jax
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.parallel import mesh as JM
from paddle_tpu.parallel import sharding as JS
from paddle_tpu.text.ernie import ErnieConfig as JErnieConfig
from paddle_tpu.text.pretrainer import HybridPretrainer as JTrainer
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.parallel import mesh as TM
from paddle_tpu_torch.parallel import sharding as TS
from paddle_tpu_torch.text.ernie import ErnieConfig
from paddle_tpu_torch.text.pretrainer import HybridPretrainer
import torch_parallel_job as J

MESHES = [dict(dp=2, tp=4), dict(pp=2, tp=2, dp=2), dict(dp=8),
          dict(ep=2, sp=2, tp=2), dict(tp=8), dict(dp=-1, tp=3, devices=6)]


def _meshes(degrees):
    degrees = dict(degrees)
    n = degrees.pop("devices", 8)
    return (TM.build_mesh(TM.MeshConfig(devices=list(range(n)), **degrees)),
            JM.build_mesh(JM.MeshConfig(devices=jax.devices()[:n],
                                        **degrees)))


@pytest.fixture(autouse=True)
def _no_mesh():
    yield
    TM.set_mesh(None)
    JM.set_mesh(None)


SHAPES = {
    "word_embeddings.weight": (96, 48), "position_embeddings.weight": (32, 48),
    "self_attn.q_proj.weight": (48, 48), "self_attn.q_proj.bias": (48,),
    "self_attn.k_proj.weight": (48, 48), "self_attn.v_proj.bias": (48,),
    "self_attn.out_proj.weight": (48, 48), "self_attn.out_proj.bias": (48,),
    "linear1.weight": (48, 192), "linear1.bias": (192,),
    "linear2.weight": (192, 48), "linear2.bias": (48,),
    "norm1.weight": (48,), "moe.wi": (4, 48, 192), "moe.wo": (4, 192, 48),
    "moe.gate_weight": (48, 4), "odd.weight": (7, 5), "scalar": (),
}
ANNOTATIONS = {"moe.wi": ("ep", None, "tp"), "moe.wo": ("ep", "tp", None)}


def _spec(s):
    return tuple(s.spec) if hasattr(s, "spec") else tuple(s)


@pytest.mark.parametrize("degrees", MESHES,
                         ids=["-".join(f"{k}{v}" for k, v in d.items())
                              for d in MESHES])
@pytest.mark.parametrize("zero_stage", [0, 3])
def test_infer_sharding_matches_jax(degrees, zero_stage):
    tm, jm = _meshes(degrees)
    params = {k: np.zeros(v, np.float32) for k, v in SHAPES.items()}
    want = JS.infer_sharding(params, jm, JS.TRANSFORMER_RULES, ANNOTATIONS,
                             zero_stage)
    got = TS.infer_sharding({k: torch.from_numpy(v)
                             for k, v in params.items()}, tm,
                            TS.TRANSFORMER_RULES, ANNOTATIONS, zero_stage)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: _spec(v) for k, v in want.items()}
    for shape in list(SHAPES.values()) + [(3, 8, 16), (1,), (6, 6)]:
        assert tuple(TS.zero_spec(shape, tm)) == _spec(JS.zero_spec(shape,
                                                                    jm))


def test_layer_annotations_match_jax():
    t = tnn.MoEFFN(8, 16, 4)
    j = jnn.MoEFFN(8, 16, 4)
    assert TS.layer_annotations(t) == JS.layer_annotations(j) == {
        "wi": ("ep", None, "tp"), "wo": ("ep", "tp", None)}
    assert TS.layer_annotations(tnn.TransformerEncoderLayer(8, 2, 16)) == \
        JS.layer_annotations(jnn.TransformerEncoderLayer(8, 2, 16)) == {}


@pytest.mark.parametrize("name", list(J.HYBRID_MESHES))
def test_hybrid_param_shardings_match_jax(name):
    degrees, num_micro, _, experts, _ = J.HYBRID_MESHES[name]
    tm, jm = _meshes(dict(degrees, devices=4))
    jt = JTrainer(JErnieConfig(**J.HYBRID), mesh=jm, num_micro=num_micro,
                  moe_experts=experts)
    tt = HybridPretrainer(ErnieConfig(**J.HYBRID), mesh=tm,
                          num_micro=num_micro, moe_experts=experts,
                          device="cpu")
    want = jt.param_shardings(jt.init_params())
    got = tt.param_shardings(tt.init_params())
    assert set(got) == set(want)
    for g in got:
        assert {k: tuple(v) for k, v in got[g].items()} == \
            {k: _spec(v) for k, v in want[g].items()}, g


def test_rules_reject_an_unknown_axis_as_jax_does():
    tm, jm = _meshes(dict(dp=2, tp=4))
    TM.set_mesh(tm)
    JM.set_mesh(jm)
    with pytest.raises(ValueError, match="tp"):
        TS.ShardingRules([(r"w$", ("tpp",))])
    with pytest.raises(ValueError, match="tp"):
        JS.ShardingRules([(r"w$", ("tpp",))])
    assert TS.ShardingRules([(r"w$", ("sp",))]).match("a.w", 1) == ("sp",)


def test_place_takes_this_ranks_slice_and_shard_layer_swaps_layers():
    tm, _ = _meshes(dict(dp=2, tp=4))
    x = torch.arange(64.0).reshape(8, 8)
    # no process group: this process is rank 0 of every dim
    assert torch.equal(TS.place(x, TS.PartitionSpec("tp"), tm), x[:2])
    assert torch.equal(TS.place(x, TS.PartitionSpec(None, ("dp", "tp")), tm),
                       x[:, :1])
    layer = tnn.TransformerEncoderLayer(16, 4, 32)
    TS.shard_layer(layer, tm, TS.TRANSFORMER_RULES)
    assert isinstance(layer.self_attn.q_proj, TS.ColumnParallelLinear)
    assert isinstance(layer.self_attn.out_proj, TS.RowParallelLinear)
    assert isinstance(layer.linear1, TS.ColumnParallelLinear)
    assert isinstance(layer.linear2, TS.RowParallelLinear)
    assert layer.self_attn.num_heads == 1
    assert tuple(layer.linear1.weight.shape) == (16, 8)
    assert tuple(layer.linear2.weight.shape) == (8, 16)
    assert tuple(layer.linear2.bias.shape) == (16,)
    with pytest.raises(NotImplementedError, match="ZeRO-1"):
        TS.shard_layer(layer, tm, zero_stage=3)
