"""The port's dygraph QAT / PTQ (paddle_tpu_torch.slim) against the JAX
package's, on the CPU.

* ``QuantizedLinear`` / ``QuantizedConv2D``: three training steps on inputs
  that grow, each the loss, every parameter's gradient and the
  ``in_scale`` moving average against the JAX layer's (loss rel 1e-6,
  gradients within 1e-6 of their largest value, scale rel 1e-6); in eval mode the scale holds.
* ``ImperativeQuantAware.quantize``: the same layers swapped in both
  packages, the same parameter and buffer names, weights and scales
  carried by ``convert.from_jax_params(..., buffers=...)``.
* ``PostTrainingQuantization``: calibration, conversion to ``Int8Linear``,
  the int8 weights, scales and the int32 accumulator exactly equal to the
  JAX package's, the fp32 rescaled output within 1e-6 relative; an
  uncalibrated layer raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import nn as jnn
from paddle_tpu import slim as jslim
from paddle_tpu.autograd import buffers_dict, functional_call, parameters_dict
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import slim as tslim
from paddle_tpu_torch.slim import quant as tquant


def _np(d):
    return {k: np.array(v) for k, v in d.items()}


class _JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.conv = jnn.Conv2D(3, 8, 3, padding=1)
        self.fc1 = jnn.Linear(8 * 6 * 6, 32)
        self.fc2 = jnn.Linear(32, 16)

    def forward(self, x):
        h = jnp.maximum(self.conv(x), 0.0).reshape(x.shape[0], -1)
        return self.fc2(jnp.tanh(self.fc1(h)))


class _TNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = tnn.Conv2D(3, 8, 3, padding=1)
        self.fc1 = tnn.Linear(8 * 6 * 6, 32)
        self.fc2 = tnn.Linear(32, 16)

    def forward(self, x):
        h = torch.relu(self.conv(x)).reshape(x.shape[0], -1)
        return self.fc2(torch.tanh(self.fc1(h)))


def _layers(kind):
    paddle_tpu.seed(5)
    if kind == "linear":
        j, t = jnn.Linear(12, 8), tnn.Linear(12, 8)
        shape = (6, 12)
    else:
        j = jnn.Conv2D(3, 4, 3, padding=1)
        t = tnn.Conv2D(3, 4, 3, padding=1)
        shape = (2, 3, 6, 6)
    convert.from_jax_params(_np(parameters_dict(j)), t)
    wrap = {"linear": (jslim.QuantizedLinear, tslim.QuantizedLinear),
            "conv": (jslim.QuantizedConv2D, tslim.QuantizedConv2D)}[kind]
    return wrap[0](j), wrap[1](t), shape


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_quantized_layer_three_steps_match_jax(kind):
    jq, tq, shape = _layers(kind)
    jq.train()
    tq.train()
    rng = np.random.default_rng(0)
    for step in range(3):
        x = rng.normal(0, 1 + step, shape).astype(np.float32)

        def loss(p):
            return jnp.sum(jnp.square(functional_call(jq, p,
                                                      (jnp.asarray(x),))))

        jl, jg = jax.value_and_grad(loss)(parameters_dict(jq))
        tq.zero_grad()
        tl = tq(torch.from_numpy(x)).square().sum()
        tl.backward()
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
        tp = dict(tq.named_parameters())
        assert set(tp) == set(jg)
        for k, g in jg.items():
            ref = np.asarray(g)
            np.testing.assert_allclose(tp[k].grad.numpy(), ref, rtol=0,
                                       atol=1e-6 * np.abs(ref).max(),
                                       err_msg=k)
        np.testing.assert_allclose(
            float(tq.in_scale), float(jq._buffers["in_scale"].value),
            rtol=1e-6)
    before = float(tq.in_scale)
    tq.eval()
    tq(torch.from_numpy(x * 10))
    assert float(tq.in_scale) == before > 0


def test_quantize_swaps_the_same_layers_and_names():
    paddle_tpu.seed(9)
    jnet, tnet = _JNet(), _TNet()
    jslim.ImperativeQuantAware().quantize(jnet)
    tslim.ImperativeQuantAware().quantize(tnet)
    assert type(tnet.conv).__name__ == "QuantizedConv2D"
    assert type(tnet.fc1).__name__ == type(tnet.fc2).__name__ \
        == "QuantizedLinear"
    x = np.random.default_rng(1).normal(0, 1, (4, 3, 6, 6)).astype(np.float32)
    jnet.train()
    jnet(jnp.asarray(x))                       # eager: scales learned
    convert.from_jax_params(_np(parameters_dict(jnet)), tnet,
                            buffers=_np(buffers_dict(jnet)))
    assert set(dict(tnet.named_buffers())) == set(buffers_dict(jnet))
    assert float(tnet.fc1.in_scale) == float(
        jnet.fc1._buffers["in_scale"].value) > 0
    jnet.eval()
    tnet.eval()
    np.testing.assert_allclose(tnet(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jnet(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-5)
    only_linear = tslim.ImperativeQuantAware(
        quantizable_layer_type=("Linear",)).quantize(_TNet())
    assert type(only_linear.conv).__name__ == "Conv2D"


def test_ptq_int8_linear_matches_jax_exactly():
    paddle_tpu.seed(11)
    jnet, tnet = _JNet(), _TNet()
    convert.from_jax_params(_np(parameters_dict(jnet)), tnet)
    jnet.eval()
    tnet.eval()
    rng = np.random.default_rng(2)
    calib = [rng.normal(0, 1, (4, 3, 6, 6)).astype(np.float32)
             for _ in range(3)]
    jptq = jslim.PostTrainingQuantization(jnet)
    tptq = tslim.PostTrainingQuantization(tnet)
    for c in calib:
        jptq.sample(jnp.asarray(c))
        tptq.sample(torch.from_numpy(c))
    for name in ("fc1", "fc2"):
        assert getattr(tnet, name).abs_max == pytest.approx(
            getattr(jnet, name).abs_max, rel=1e-6)
    jptq.convert()
    tptq.convert()
    for name in ("fc1", "fc2"):
        jl, tl = getattr(jnet, name), getattr(tnet, name)
        assert type(tl).__name__ == "Int8Linear"
        assert tl.w_int8.dtype == torch.int8
        np.testing.assert_array_equal(tl.w_int8.numpy(),
                                      np.asarray(jl._buffers["w_int8"].value))
        np.testing.assert_array_equal(
            tl.w_scale.numpy(), np.asarray(jl._buffers["w_scale"].value))
    x = rng.normal(0, 1, (5, 3, 6, 6)).astype(np.float32)
    # the int32 accumulator of fc1, exactly
    h = np.asarray(jnp.maximum(jnet.conv(jnp.asarray(x)), 0.0)).reshape(5, -1)
    jl, tl = jnet.fc1, tnet.fc1
    s_in = jl.in_scale / jl.qmax
    xq = np.clip(np.round(h / np.float32(s_in)), -128, 127).astype(np.int8)
    tq = tl.quantize_input(torch.from_numpy(h))
    np.testing.assert_array_equal(tq.numpy(), xq)
    acc = tquant.int8_matmul(tq, tl.w_int8)
    ref = xq.astype(np.int64) @ np.asarray(
        jl._buffers["w_int8"].value).astype(np.int64)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy().astype(np.int64), ref)
    ref_out = np.asarray(jnet(jnp.asarray(x)))
    got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref_out, rtol=1e-6,
                               atol=1e-6 * np.abs(ref_out).max())


def test_int8_matmul_is_exact_at_the_extremes():
    a = torch.full((3, 40), -128, dtype=torch.int8)
    w = torch.full((40, 5), -128, dtype=torch.int8)
    acc = tquant.int8_matmul(a, w)
    assert acc.dtype == torch.int32 and int(acc[0, 0]) == 40 * 128 * 128
    x = torch.randint(-128, 128, (2, 3, 24), dtype=torch.int8)
    w = torch.randint(-128, 128, (24, 6), dtype=torch.int8)
    ref = x.to(torch.int64) @ w.to(torch.int64)
    assert torch.equal(tquant.int8_matmul(x, w).to(torch.int64), ref)


def test_ptq_requires_calibration():
    tptq = tslim.PostTrainingQuantization(_TNet())
    with pytest.raises(RuntimeError, match="calibration"):
        tptq.convert()


def test_quantized_layers_refuse_a_recompute_replay():
    from paddle_tpu_torch.autograd import recompute

    q = tslim.QuantizedLinear(tnn.Linear(4, 4))
    q.train()
    x = torch.randn(2, 4, requires_grad=True)
    out = recompute(q, x)
    with pytest.raises(NotImplementedError):
        out.sum().backward()
