"""The port's static op registry against the JAX package's: the same op
types (the list that waited for a later slice is empty), every one of them
with a case in the op table (tests/torch_static_cases.py), and every op
type a builder of the layers DSL emits registered."""
import re
from pathlib import Path

import numpy as np

import paddle_tpu.static.executor  # noqa: F401 — registers the JAX ops
import paddle_tpu_torch.static.executor  # noqa: F401 — registers the port's
from paddle_tpu.static.registry import registered_ops as jax_ops
from paddle_tpu_torch.static.registry import registered_ops as port_ops
from tests import torch_static_cases as T

ROOT = Path(__file__).resolve().parent.parent


def test_port_registry_is_the_jax_registry_less_the_later_slice():
    jax, port = set(jax_ops()), set(port_ops())
    assert T.LATER == frozenset()
    assert port == jax - T.LATER
    assert len(port) == 467
    # the op tail's 130 types, all of them registered now
    assert len(T.TAIL_9C) == 130 and T.TAIL_9C <= port


def test_every_registered_op_type_has_a_case():
    port = set(port_ops())
    covered = {c.op_type for c in T.cases(port)}
    assert port - covered == T.STRUCTURAL & port
    assert len(T.cases(port)) >= len(port - T.STRUCTURAL)


def test_every_random_case_is_held_beyond_its_shape():
    """A random case's values go unchecked by ``assert_same``: each has a
    ``verify`` of what it computes from its draw, or draws at least 1000
    values, enough for the moments check against the JAX draw."""
    for c in T.cases(set(port_ops())):
        if c.random and c.verify is None:
            assert c.inputs == {} and \
                int(np.prod(c.attrs["shape"])) >= 1000, c.id


def test_every_op_type_the_dsl_emits_is_registered():
    jax, port = set(jax_ops()), set(port_ops())
    literals = set()
    for name in ("layers", "layers_tail", "control_flow", "nets"):
        src = (ROOT / "paddle_tpu" / "static" / f"{name}.py").read_text()
        literals |= set(re.findall(r'"([a-z0-9_]+)"', src))
    emitted = {t for t in literals if t in jax}
    assert emitted - port == set()
    assert {"linear_chain_crf", "crf_decoding", "lookup_table_v2",
            "sequence_pool", "cross_entropy2", "fc"} <= port
    # the Executors dispatch the sub-block ops and the backward region
    # themselves, in both packages
    assert not T.STRUCTURAL & (jax | port)


def test_depthwise_conv2d_transpose_defaults_to_2d_dilations(tmp_path):
    """The JAX lowering's conv helper defaults ``dilations`` and
    ``output_padding`` to 1-tuples, so a 2-D transposed depthwise conv
    without them raises in the JAX Executor (ROADMAP Queue 3); the port
    pairs the defaults and runs it, agreeing with the JAX lowering given
    the 2-D defaults explicitly."""
    import numpy as np
    import pytest

    import paddle_tpu.static as jstatic
    import paddle_tpu_torch.static as tstatic

    x = np.random.default_rng(0).normal(0, 1, (1, 2, 3, 3)).astype("float32")
    w = np.random.default_rng(1).normal(0, 1, (2, 1, 3, 3)).astype("float32")
    attrs = {"strides": [2, 2], "paddings": [1, 1]}
    bare = T.Case("depthwise_conv2d_transpose", {"Input": x, "Filter": w},
                  attrs, outs=("Output",))
    with pytest.raises(IndexError):
        T.run(bare, jstatic, tmp_path / "jax")
    got, _ = T.run(bare, tstatic, tmp_path / "torch", place="cpu")
    full = T.Case("depthwise_conv2d_transpose", {"Input": x, "Filter": w},
                  {**attrs, "dilations": [1, 1], "output_padding": [0, 0]},
                  outs=("Output",))
    want, _ = T.run(full, jstatic, tmp_path / "jax2")
    T.assert_same(full, got, want)
