"""The port's ``ShardingPlan`` (paddle_tpu_torch/parallel/sharding.py, its
placement half) against the JAX package's, on the CPU.

For the same mesh shape (the JAX plan on virtual CPU devices, the port's
on a sizes-only mesh of CPU ranks) and the same knobs, every leaf's spec
from ``state_shardings`` (with and without ZeRO-1/2 optimizer slots),
``placement_spec`` / ``placement_divisor``, the feed specs and the batch
divisor equal the JAX plan's, and ``fingerprint()`` is the JAX string.
The knobs the port does not take yet raise: ``embedding_*`` naming
ROADMAP.md Queue 1 item 9b.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from paddle_tpu.parallel import sharding as js
from paddle_tpu_torch.parallel import sharding as ts
from paddle_tpu_torch.parallel.mesh import Mesh

MESHES = {
    "dp4": {"dp": 4},
    "dp2tp2": {"dp": 2, "tp": 2},
    "dp2sp2": {"dp": 2, "sp": 2},
    "dp8": {"dp": 8},
}

STATE_SHAPES = {
    "embeddings.word_embeddings.weight": (128, 64),
    "encoder.layers.0.self_attn.q_proj.weight": (64, 64),
    "encoder.layers.0.self_attn.q_proj.bias": (64,),
    "encoder.layers.0.self_attn.out_proj.weight": (64, 64),
    "encoder.layers.0.linear1.weight": (64, 256),
    "encoder.layers.0.linear1.bias": (256,),
    "encoder.layers.0.linear2.weight": (256, 64),
    "encoder.layers.0.norm1.weight": (64,),
    "moment.linear1.weight": (64, 256),
    "moment.norm1.weight": (64,),
    "odd": (6, 3),
    "scalar": (),
}
SLOTS = ("moment.linear1.weight", "moment.norm1.weight", "odd")


def _meshes(name):
    shape = MESHES[name]
    n = int(np.prod(list(shape.values())))
    jm = JMesh(np.asarray(jax.devices()[:n]).reshape(tuple(shape.values())),
               tuple(shape))
    tm = Mesh(tuple(shape), shape, device=torch.device("cpu"))
    return jm, tm


KNOBS = {
    "zero0": dict(),
    "zero1": dict(zero_stage=1),
    "zero2": dict(zero_stage=2, batch_axes=("dp", "sp")),
    "zero3": dict(zero_stage=3, donate=False),
    "rules": dict(rules="transformer", zero_stage=1),
    "annotated": dict(annotations={"odd": (None, "tp"),
                                   "encoder.layers.0.norm1.weight": ("tp",)},
                      rules="transformer", seq_axis="sp"),
    "comm": dict(comm_quantize="int8", comm_block_size=128,
                 comm_buffer_mb=4.0, comm_hierarchy="off"),
}


def _plans(mesh_name, knob):
    jm, tm = _meshes(mesh_name)
    kw = dict(KNOBS[knob])
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("rules") == "transformer":
        jkw["rules"], tkw["rules"] = js.TRANSFORMER_RULES, ts.TRANSFORMER_RULES
    return js.ShardingPlan(mesh=jm, **jkw), ts.ShardingPlan(mesh=tm, **tkw)


def _jspec(ns):
    return tuple(ns.spec)


@pytest.mark.parametrize("knob", sorted(KNOBS))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_state_shardings_match_jax(mesh_name, knob):
    jp, tp = _plans(mesh_name, knob)
    state = {k: np.zeros(s, np.float32) for k, s in STATE_SHAPES.items()}
    for slots in (None, SLOTS):
        want = {k: _jspec(v) for k, v in
                jp.state_shardings(state, optimizer_slots=slots).items()}
        got = {k: tuple(v) for k, v in
               tp.state_shardings({k: torch.from_numpy(v)
                                   for k, v in state.items()},
                                  optimizer_slots=slots).items()}
        assert got == want, slots
    for name, shape in STATE_SHAPES.items():
        assert tuple(tp.placement_spec(name, shape)) == \
            tuple(jp.placement_spec(name, shape)), name
        assert tp.placement_divisor(name, shape) == \
            jp.placement_divisor(name, shape), name


@pytest.mark.parametrize("knob", sorted(KNOBS))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_fingerprint_and_feeds_match_jax(mesh_name, knob):
    jp, tp = _plans(mesh_name, knob)
    assert tp.fingerprint() == jp.fingerprint()
    assert tp.num_devices() == jp.num_devices()
    assert tp.batch_divisor() == jp.batch_divisor()
    feed = {"ids": np.zeros((8, 12), np.int64), "label": np.zeros((8,)),
            "one": np.zeros((1, 12)), "s": np.float32(1.0),
            "odd_seq": np.zeros((8, 5))}
    want = {k: _jspec(v) for k, v in jp.feed_shardings(feed).items()}
    got = {k: tuple(v) for k, v in tp.feed_shardings(feed).items()}
    assert got == want
    if tp.batch_divisor() > 1:
        for plan in (jp, tp):
            with pytest.raises(ValueError, match="does not divide"):
                plan.feed_sharding("bad", np.zeros((tp.batch_divisor() + 1,
                                                    2)))


def test_a_marked_slice_counts_at_its_whole_shape():
    _, tm = _meshes("dp4")
    plan = ts.ShardingPlan(mesh=tm, zero_stage=3)
    whole = torch.arange(64.0).reshape(16, 4)
    local = ts.mark_slice(whole[4:8].clone(), ("dp",), (16, 4))
    assert ts.slice_spec(local) == (("dp",), (16, 4))
    assert tuple(plan.state_shardings({"w": local})["w"]) == ("dp",)
    assert ts.spec_index(("dp",), (16, 4), tm, {"dp": 1}) == [[4, 8], [0, 4]]


def test_plan_errors():
    jm, tm = _meshes("dp2tp2")
    with pytest.raises(ValueError, match="either mesh or devices"):
        ts.ShardingPlan(mesh=tm, devices=[0, 1])
    with pytest.raises(ValueError, match="neither in the mesh"):
        ts.ShardingPlan(mesh=tm, batch_axes=("dpp",))
    with pytest.raises(ValueError, match="comm_quantize"):
        ts.ShardingPlan(mesh=tm, comm_quantize="int4")
    for kw in (dict(embedding_shard="tp"), dict(embedding_capacity=2.0),
               dict(embedding_quantize="int8")):
        with pytest.raises(NotImplementedError, match="9b"):
            ts.ShardingPlan(mesh=tm, **kw)
    plan = ts.ShardingPlan(mesh=tm)
    for call in (lambda: plan.embedding_axis_for("w"),
                 lambda: plan.bind_embedding_tables(None),
                 lambda: plan.embedding_scope()):
        with pytest.raises(NotImplementedError, match="9b"):
            call()
    with plan.comm_scope() as opts:
        assert opts is None
