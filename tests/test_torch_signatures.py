"""Public signatures of the port that bind positional arguments as the JAX
package's do, each called positionally in both packages.

* ``nn.functional.cross_entropy(input, label, weight, ignore_index,
  reduction, soft_label, axis)`` and ``softmax_with_cross_entropy(logits,
  label, soft_label, ignore_index, axis)``: class weights and soft labels
  included, values at rtol 1e-6.
* ``nn.Embedding(num_embeddings, embedding_dim, padding_idx, sparse,
  weight_attr, name)`` and ``nn.functional.embedding(x, weight,
  padding_idx)``: the padding row's output (and gradient) is zero; the
  port's initialisation arguments are keyword-only; what is not ported
  raises.
* ``PagedDecoder(model, cache, max_seqs, max_blocks_per_seq,
  prefill_chunk, donate, tenant)``: ``donate`` is accepted and ignored.
* ``static.passes.Diagnostic(code, severity, message, block, op_index,
  op_type, var, hint)``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu.serving import paged as JPG
from paddle_tpu.static import analysis as janalysis
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import initializer as tinit
from paddle_tpu_torch.serving import paged as TPG
from paddle_tpu_torch.static import passes as TP

RTOL = 1e-6


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(ref),
                               rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_positional_weight_and_ignore_index(reduction):
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 2, (7, 5)).astype(np.float32)
    label = np.array([1, 4, -1, 0, 3, -1, 2], np.int32)
    weight = rng.uniform(0.2, 2.0, (5,)).astype(np.float32)
    ref = JF.cross_entropy(jnp.asarray(logits), jnp.asarray(label),
                           jnp.asarray(weight), -1, reduction)
    got = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(label),
                           torch.from_numpy(weight), -1, reduction)
    _close(got, ref)
    # no weight: the fourth positional is still ignore_index
    ref = JF.cross_entropy(jnp.asarray(logits), jnp.asarray(label), None, -1,
                           reduction)
    got = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(label),
                           None, -1, reduction)
    _close(got, ref)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_cross_entropy_positional_soft_label(reduction):
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 2, (6, 4)).astype(np.float32)
    soft = rng.dirichlet(np.ones(4), 6).astype(np.float32)
    ref = JF.cross_entropy(jnp.asarray(logits), jnp.asarray(soft), None,
                           -100, reduction, True)
    got = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(soft),
                           None, -100, reduction, True)
    _close(got, ref)


def test_softmax_with_cross_entropy_positional_soft_label_then_ignore():
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 2, (5, 6)).astype(np.float32)
    soft = rng.dirichlet(np.ones(6), 5).astype(np.float32)
    ref = JF.softmax_with_cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(soft), True)
    got = TF.softmax_with_cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(soft), True)
    _close(got, ref)
    hard = np.array([[2], [0], [5], [5], [1]], np.int32)
    ref = JF.softmax_with_cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(hard), False, 5)
    got = TF.softmax_with_cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(hard), False, 5)
    _close(got, ref)
    assert float(got[2]) == float(got[3]) == 0.0


def test_embedding_positional_padding_idx():
    ids = np.array([[0, 3, 2], [2, 2, 1]], np.int32)
    jemb = jnn.Embedding(5, 4, 2)
    temb = tnn.Embedding(5, 4, 2)
    assert temb.padding_idx == jemb.padding_idx == 2
    w = np.array(jemb.weight.value)
    with torch.no_grad():
        temb.weight.copy_(torch.from_numpy(w))
    ref = np.asarray(jemb(jnp.asarray(ids)))
    got = temb(torch.from_numpy(ids))
    _close(got, ref)
    assert float(got.detach()[ids == 2].abs().max()) == 0.0
    got.sum().backward()
    assert float(temb.weight.grad[2].abs().max()) == 0.0   # padding row
    assert float(temb.weight.grad[3].abs().min()) == 1.0
    # the functional form, positionally
    _close(TF.embedding(torch.from_numpy(ids), torch.from_numpy(w), 3),
           JF.embedding(jnp.asarray(ids), jnp.asarray(w), 3))


def test_embedding_port_arguments_are_keyword_only_and_unported_raise():
    gen = torch.Generator().manual_seed(0)
    emb = tnn.Embedding(6, 3, std=0.5, generator=gen)
    assert emb.padding_idx is None and emb.weight.abs().max() > 0
    with pytest.raises(TypeError):
        tnn.Embedding(6, 3, None, False, None, None, 0.5)
    # sparse=True is the fourth positional
    assert tnn.Embedding(6, 3, None, True).sparse
    # a weight_attr is read as the JAX package reads it: its .initializer
    # when it has one, else the default
    attr = type("A", (), {"initializer": tinit.Constant(0.25)})()
    assert float(tnn.Embedding(6, 3, None, False, attr).weight.min()) == 0.25
    assert tnn.Embedding(6, 3, None, False, object(), std=0.5,
                         generator=torch.Generator().manual_seed(0)
                         ).weight.abs().max() > 0
    out = TF.embedding(torch.zeros(2, dtype=torch.int32), emb.weight, None,
                       True)
    out.sum().backward()
    assert emb.weight.grad.layout == torch.strided       # a dense gradient


def test_paged_decoder_positional_donate_then_tenant():
    cfg = dict(vocab=64, hidden=32, max_positions=256, seed=3)
    jmodel = JPG.make_paged_toy_lm(**cfg)
    keys = ("emb", "pe", "wq", "wk", "wv", "wo")
    tmodel = convert.paged_toy_lm_from_jax(
        {k: np.asarray(getattr(jmodel, k)) for k in keys}, **cfg,
        device="cpu")
    jdec = JPG.PagedDecoder(jmodel, JPG.PagedKVCache(jmodel, 64, 8), 4, 16,
                            8, False, "tenant-a")
    tdec = TPG.PagedDecoder(tmodel, TPG.PagedKVCache(tmodel, 64, 8), 4, 16,
                            8, False, "tenant-a")
    for d in (jdec, tdec):
        assert (d.max_seqs, d.max_blocks_per_seq, d.prefill_chunk,
                d.tenant) == (4, 16, 8, "tenant-a")
    out = tdec.decode([[1, 2, 3]], 6)
    assert out[0] == JPG.dense_reference_decode(jmodel, [1, 2, 3], 6)


def test_diagnostic_fields_in_the_reference_order():
    args = ("PV011", "error", "msg", 1, 7, "conv2d", "x", "fix it")
    j = janalysis.Diagnostic(*args)
    t = TP.Diagnostic(*args)
    jf = [f.name for f in dataclasses.fields(j)]
    tf = [f.name for f in dataclasses.fields(t)]
    assert tf == jf
    assert [getattr(t, n) for n in tf] == [getattr(j, n) for n in jf]
    assert TP.Diagnostic("PV011", "error", "m", var="v").block == 0


# -- the dygraph-training slice: every class and function it adds or
# touches binds positional arguments as the reference does ----------------

import inspect  # noqa: E402

from paddle_tpu import amp as jamp  # noqa: E402
from paddle_tpu import autograd as jautograd  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu import slim as jslim  # noqa: E402
from paddle_tpu.nn import initializer as jinit  # noqa: E402
from paddle_tpu.text import ernie as jernie  # noqa: E402
from paddle_tpu_torch import amp as tamp  # noqa: E402
from paddle_tpu_torch import autograd as tautograd  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch import slim as tslim  # noqa: E402
from paddle_tpu_torch.text import ernie as ternie  # noqa: E402

_NN_CLASSES = ["Linear", "Embedding", "Dropout", "LayerNorm",
               "MultiHeadAttention", "TransformerEncoderLayer",
               "TransformerEncoder", "TransformerDecoderLayer",
               "TransformerDecoder", "Transformer", "Conv2D",
               "CrossEntropyLoss", "MSELoss", "L1Loss", "SmoothL1Loss",
               "BCELoss", "BCEWithLogitsLoss", "NLLLoss", "KLDivLoss",
               "MarginRankingLoss"]
_LOSS_FUNCTIONS = ["nll_loss", "mse_loss", "square_error_cost", "l1_loss",
                   "smooth_l1_loss", "binary_cross_entropy",
                   "binary_cross_entropy_with_logits", "kl_div", "log_loss",
                   "hinge_loss", "margin_ranking_loss"]
_INITIALIZERS = ["Constant", "Uniform", "Normal", "TruncatedNormal",
                 "XavierUniform", "XavierNormal", "KaimingUniform",
                 "KaimingNormal", "Assign", "Bilinear"]
_OPTIMIZERS = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
               "Adagrad", "Adadelta", "RMSProp", "Lamb", "LarsMomentum"]
_OPTIMIZER_METHODS = ["init", "update", "step", "get_lr", "set_lr",
                      "state_dict", "set_state_dict", "clear_grad",
                      "clear_gradients", "minimize"]
_SCHEDULERS = ["LRScheduler", "NoamDecay", "ExponentialDecay",
               "NaturalExpDecay", "InverseTimeDecay", "PolynomialDecay",
               "PiecewiseDecay", "CosineAnnealingDecay", "LinearWarmup",
               "StepDecay", "MultiStepDecay", "LambdaDecay",
               "ReduceOnPlateau"]
_SCHEDULER_METHODS = ["get_lr_at", "get_lr", "step", "state_dict",
                      "set_state_dict"]
_CLIPS = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
          "GradientClipByValue", "GradientClipByNorm",
          "GradientClipByGlobalNorm"]
_SCALER_METHODS = ["scale", "unscale_", "update", "step", "minimize",
                   "state_dict", "load_state_dict", "get_scale",
                   "is_enable"]
_QUANT = ["QuantizedLinear", "QuantizedConv2D", "ImperativeQuantAware",
          "PostTrainingQuantization", "Int8Linear"]


def _callables():
    """(label, reference callable, port callable) for every class (its
    constructor), method and function of the slice."""
    pairs = []
    for n in _NN_CLASSES:
        pairs.append((f"nn.{n}", getattr(jnn, n), getattr(tnn, n)))
    pairs.append(("Transformer.generate_square_subsequent_mask",
                  jnn.Transformer.generate_square_subsequent_mask,
                  tnn.Transformer.generate_square_subsequent_mask))
    for n in ("forward", "gen_cache"):
        pairs.append((f"TransformerEncoder.{n}",
                      getattr(jnn.TransformerEncoder, n),
                      getattr(tnn.TransformerEncoder, n)))
    for c in ("TransformerDecoderLayer", "TransformerDecoder", "Transformer"):
        pairs.append((f"{c}.forward", getattr(jnn, c).forward,
                      getattr(tnn, c).forward))
    for n in _LOSS_FUNCTIONS:
        pairs.append((f"F.{n}", getattr(JF, n), getattr(TF, n)))
    for n in _INITIALIZERS:
        pairs.append((f"initializer.{n}", getattr(jinit, n),
                      getattr(tinit, n)))
        pairs.append((f"initializer.{n}.__call__",
                      getattr(jinit, n).__call__, getattr(tinit, n).__call__))
    for n in _OPTIMIZERS:
        pairs.append((f"optimizer.{n}", getattr(jopt, n), getattr(topt, n)))
    for m in _OPTIMIZER_METHODS:
        pairs.append((f"Optimizer.{m}", getattr(jopt.Optimizer, m),
                      getattr(topt.Optimizer, m)))
    for n in _SCHEDULERS:
        pairs.append((f"lr.{n}", getattr(jopt.lr, n), getattr(topt.lr, n)))
        for m in _SCHEDULER_METHODS:
            pairs.append((f"lr.{n}.{m}", getattr(getattr(jopt.lr, n), m),
                          getattr(getattr(topt.lr, n), m)))
    for n in _CLIPS:
        pairs.append((f"optimizer.{n}", getattr(jopt, n), getattr(topt, n)))
    for n in ("auto_cast", "amp_guard", "amp_cast", "decorate",
              "GradScaler", "AmpScaler"):
        pairs.append((f"amp.{n}", getattr(jamp, n), getattr(tamp, n)))
    for m in _SCALER_METHODS:
        pairs.append((f"GradScaler.{m}", getattr(jamp.GradScaler, m),
                      getattr(tamp.GradScaler, m)))
    for n in ("recompute", "checkpoint_policy"):
        pairs.append((f"autograd.{n}", getattr(jautograd, n),
                      getattr(tautograd, n)))
    for n in _QUANT:
        pairs.append((f"slim.{n}", getattr(jslim.quant, n),
                      getattr(tslim.quant, n)))
    pairs.append(("slim._CalibHook", jslim.quant._CalibHook,
                  tslim.quant._CalibHook))
    for m in ("quantize",):
        pairs.append((f"ImperativeQuantAware.{m}",
                      jslim.ImperativeQuantAware.quantize,
                      tslim.ImperativeQuantAware.quantize))
    for m in ("sample", "convert"):
        pairs.append((f"PostTrainingQuantization.{m}",
                      getattr(jslim.PostTrainingQuantization, m),
                      getattr(tslim.PostTrainingQuantization, m)))
    pairs.append(("ErnieConfig", jernie.ErnieConfig, ternie.ErnieConfig))
    return pairs


_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _positional(fn):
    sig = inspect.signature(fn)
    return [(p.name, p.default) for p in sig.parameters.values()
            if p.kind in _POSITIONAL and p.name != "self"], \
        [p.kind for p in sig.parameters.values()
         if p.kind in (inspect.Parameter.VAR_POSITIONAL,
                       inspect.Parameter.VAR_KEYWORD)]


def _plain(v):
    return v is None or isinstance(v, (bool, int, float, str, tuple))


@pytest.mark.parametrize("label,ref,port", _callables(),
                         ids=[c[0] for c in _callables()])
def test_positional_parameters_match_the_reference(label, ref, port):
    """The same positional parameter names in the same order (extras of
    the port are keyword-only), the same variadic parameters, and the same
    defaults where both are plain values (dtypes and arrays aside)."""
    (rp, rv), (pp, pv) = _positional(ref), _positional(port)
    assert [n for n, _ in pp] == [n for n, _ in rp], label
    assert pv == rv, label
    for (name, rd), (_, pd) in zip(rp, pp):
        if _plain(rd) and _plain(pd) and rd is not inspect.Parameter.empty:
            assert pd == rd, (label, name, pd, rd)


def test_repaired_constructors_called_positionally_in_both_packages():
    jattr = type("A", (), {"initializer": jinit.Constant(0.5)})()
    tattr = type("A", (), {"initializer": tinit.Constant(0.5)})()
    # Linear(in, out, weight_attr, bias_attr, name)
    jl, tl = jnn.Linear(4, 3, jattr, False, "n"), tnn.Linear(4, 3, tattr,
                                                             False, "n")
    assert jl.bias is None and tl.bias is None
    np.testing.assert_array_equal(tl.weight.detach().numpy(),
                                  np.asarray(jl.weight.value))
    # MultiHeadAttention(..., need_weights, weight_attr, bias_attr)
    jm = jnn.MultiHeadAttention(8, 2, 0.0, None, None, False, jattr, False)
    tm = tnn.MultiHeadAttention(8, 2, 0.0, None, None, False, tattr, False)
    for j, t in ((jm.q_proj, tm.q_proj), (jm.out_proj, tm.out_proj)):
        assert j.bias is None and t.bias is None
        np.testing.assert_array_equal(t.weight.detach().numpy(),
                                      np.asarray(j.weight.value))
    # TransformerEncoderLayer(..., normalize_before, weight_attr, bias_attr)
    jel = jnn.TransformerEncoderLayer(8, 2, 16, 0.0, "relu", None, None,
                                      True, jattr, False)
    tel = tnn.TransformerEncoderLayer(8, 2, 16, 0.0, "relu", None, None,
                                      True, tattr, False)
    assert jel.normalize_before and tel.normalize_before
    assert tel.linear1.bias is None and jel.linear1.bias is None
    assert float(tel.linear2.weight.min()) == 0.5
    # TransformerEncoder(encoder_layer, num_layers, norm, enable_recompute,
    #                    recompute_policy)
    je = jnn.TransformerEncoder(jel, 2, None, True, "dots_saveable")
    te = tnn.TransformerEncoder(tel, 2, None, True, "dots_saveable")
    for e in (je, te):
        assert e.enable_recompute is True
        assert e.recompute_policy == "dots_saveable"
        assert e.norm is None and e.num_layers == 2
    # LayerNorm(normalized_shape, epsilon, weight_attr, bias_attr)
    jn, tn = jnn.LayerNorm(8, 1e-6, False, None), tnn.LayerNorm(8, 1e-6,
                                                              False, None)
    assert jn.weight is None and tn.weight is None
    assert tn.bias is not None and tn.epsilon == jn.epsilon == 1e-6
    x = np.random.default_rng(0).normal(0, 1, (3, 8)).astype(np.float32)
    np.testing.assert_allclose(tn(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jn(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-6)
    # Dropout(p, mode)
    jd = jnn.Dropout(0.25, "downgrade_in_infer")
    td = tnn.Dropout(0.25, "downgrade_in_infer")
    jd.eval()
    td.eval()
    assert td.mode == jd.mode == "downgrade_in_infer"
    np.testing.assert_allclose(td(torch.from_numpy(x)).numpy(),
                               np.asarray(jd(jnp.asarray(x))), rtol=1e-6)


def test_generator_is_keyword_only_on_the_repaired_constructors():
    gen = torch.Generator().manual_seed(0)
    for cls, args in ((tnn.Linear, (4, 3)),
                      (tnn.MultiHeadAttention, (8, 2)),
                      (tnn.TransformerEncoderLayer, (8, 2, 16)),
                      (tnn.TransformerDecoderLayer, (8, 2, 16))):
        cls(*args, generator=gen)
        p = inspect.signature(cls).parameters["generator"]
        assert p.kind is inspect.Parameter.KEYWORD_ONLY, cls
    layer = tnn.TransformerEncoderLayer(8, 2, 16)
    p = inspect.signature(tnn.TransformerEncoder).parameters["generator"]
    assert p.kind is inspect.Parameter.KEYWORD_ONLY
    with pytest.raises(TypeError):
        tnn.TransformerEncoder(layer, 2, None, False, None, gen)


@pytest.mark.parametrize("name", ["Constant", "Assign", "Bilinear"])
def test_fixed_initializers_equal_the_reference(name):
    shape = (2, 3, 4, 4)
    args = {"Constant": (0.75,),
            "Assign": (np.arange(96, dtype=np.float32).reshape(shape),),
            "Bilinear": ()}[name]
    ref = np.asarray(getattr(jinit, name)(*args)(shape))
    got = getattr(tinit, name)(*args)(shape, torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("name,args,check", [
    ("Uniform", (-0.3, 0.2), ("range", -0.3, 0.2)),
    ("Normal", (0.5, 2.0), ("moments", 0.5, 2.0)),
    ("TruncatedNormal", (0.0, 1.0), ("range", -2.0, 2.0)),
    ("XavierUniform", (), ("range", -np.sqrt(6 / 1000), np.sqrt(6 / 1000))),
    ("XavierNormal", (), ("moments", 0.0, np.sqrt(2 / 1000))),
    ("KaimingUniform", (), ("range", -np.sqrt(6 / 400), np.sqrt(6 / 400))),
    ("KaimingNormal", (), ("moments", 0.0, np.sqrt(2 / 400))),
])
def test_random_initializers_draw_the_reference_distribution(name, args,
                                                             check):
    """(400, 600) draws: the reference's bounds, or its mean and standard
    deviation within 5 %; one generator seed gives one draw."""
    shape = (400, 600)
    init = getattr(tinit, name)(*args)
    a = init(shape, generator=torch.Generator().manual_seed(1))
    b = init(shape, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.dtype == torch.float32
    ref = np.asarray(getattr(jinit, name)(*args)(shape))
    for x in (a.numpy(), ref):
        if check[0] == "range":
            assert x.min() >= check[1] - 1e-6 and x.max() <= check[2] + 1e-6
            assert x.max() - x.min() > 0.99 * (check[2] - check[1])
        else:
            assert abs(x.mean() - check[1]) < 0.05 * check[2] + 1e-3
            assert abs(x.std() - check[2]) < 0.05 * check[2]


# -- the op library and the dygraph core: every function and class the
# slice adds or rebases binds positional arguments as the reference does --

import paddle_tpu as jtop  # noqa: E402
import paddle_tpu.dygraph as jdygraph  # noqa: E402
import paddle_tpu.ops as jops  # noqa: E402
import paddle_tpu_torch as ttop  # noqa: E402
import paddle_tpu_torch.dygraph as tdygraph  # noqa: E402

_LAYER_METHODS = ["add_parameter", "add_sublayer", "register_buffer",
                  "create_parameter", "named_parameters", "parameters",
                  "named_sublayers", "sublayers", "named_buffers",
                  "clear_gradients", "state_dict", "set_state_dict",
                  "load_dict", "register_forward_pre_hook",
                  "register_forward_post_hook", "apply"]
_REBASED = ["Linear", "Embedding", "Dropout", "LayerNorm", "Conv2D",
            "MultiHeadAttention", "TransformerEncoderLayer",
            "TransformerEncoder", "TransformerDecoderLayer",
            "TransformerDecoder", "Transformer"]
_ACT_LAYERS = ["ReLU", "ReLU6", "Sigmoid", "Tanh", "GELU", "SiLU", "Mish",
               "Hardswish", "Hardsigmoid", "Hardtanh", "ELU", "CELU", "SELU",
               "Softplus", "Softsign", "Softshrink", "Hardshrink",
               "Tanhshrink", "LogSigmoid", "LeakyReLU", "PReLU", "Softmax",
               "LogSoftmax"]


def _ops():
    return sorted(n for n in ttop.ops.__all__
                  if callable(getattr(ttop.ops, n)))


def _slice_callables():
    pairs = []
    for n in _ops():
        ref = jops.manipulation.chunk if n == "chunk" else getattr(jops, n)
        pairs.append((f"ops.{n}", ref, getattr(ttop.ops, n)))
    for n in ("set_device", "get_device", "device_guard", "seed",
              "get_flags", "set_flags", "set_default_dtype",
              "get_default_dtype", "is_tensor", "CPUPlace", "CUDAPlace",
              "TPUPlace"):
        pairs.append((n, getattr(jtop, n), getattr(ttop, n)))
    for n in ("guard", "to_variable", "grad", "backward", "enable_tape",
              "disable_tape", "enable_dygraph", "disable_dygraph"):
        pairs.append((f"dygraph.{n}", getattr(jdygraph, n),
                      getattr(tdygraph, n)))
    for n in ("parameters_dict", "buffers_dict", "load_parameters",
              "load_buffers", "functional_call", "value_and_grad", "grad",
              "partial_grad", "backward"):
        pairs.append((f"autograd.{n}", getattr(jautograd, n),
                      getattr(tautograd, n)))
    for m in _LAYER_METHODS:
        pairs.append((f"Layer.{m}", getattr(jnn.Layer, m),
                      getattr(tnn.Layer, m)))
    for c in ("Parameter", "LayerList", "Sequential", "ParameterList"):
        pairs.append((f"nn.{c}", getattr(jnn, c), getattr(tnn, c)))
    for m in ("set_value", "numpy", "clear_grad", "clear_gradient"):
        pairs.append((f"Parameter.{m}", getattr(jnn.Parameter, m),
                      getattr(tnn.Parameter, m)))
    for c in _REBASED:
        pairs.append((f"{c}.forward", getattr(jnn, c).forward,
                      getattr(tnn, c).forward))
    for n in TF.__all__:
        if getattr(TF, n).__module__.endswith("activation") and n != "tanh":
            pairs.append((f"F.{n}", getattr(JF, n), getattr(TF, n)))
    for c in _ACT_LAYERS:
        pairs.append((f"nn.{c}", getattr(jnn, c), getattr(tnn, c)))
        pairs.append((f"nn.{c}.forward", getattr(jnn, c).forward,
                      getattr(tnn, c).forward))
    for c in ("ErnieModel", "ErnieForPretraining", "ErniePooler",
              "ErnieForSequenceClassification"):
        pairs.append((f"{c}.forward", getattr(jernie, c).forward,
                      getattr(ternie, c).forward))
    pairs.append(("ErnieForSequenceClassification",
                  jernie.ErnieForSequenceClassification,
                  ternie.ErnieForSequenceClassification))
    return pairs


def _public(params):
    """The reference's positional parameters without its private ones
    (``named_parameters``' ``_memo`` recursion slot)."""
    return [(n, d) for n, d in params if not n.startswith("_")]


@pytest.mark.parametrize("label,ref,port", _slice_callables(),
                         ids=[c[0] for c in _slice_callables()])
def test_slice_positional_parameters_match_the_reference(label, ref, port):
    """As ``test_positional_parameters_match_the_reference``, for the op
    library, the places and flags, ``dygraph``, ``autograd``, the Layer
    API, the activations and the sentence classifier; extras of the port
    are keyword-only."""
    (rp, rv), (pp, pv) = _positional(ref), _positional(port)
    rp = _public(rp)
    assert [n for n, _ in pp] == [n for n, _ in rp], label
    assert pv == rv, label
    for (name, rd), (_, pd) in zip(rp, pp):
        if _plain(rd) and _plain(pd) and rd is not inspect.Parameter.empty:
            assert pd == rd, (label, name, pd, rd)


def test_slice_signature_list_covers_every_exported_op():
    labels = {c[0] for c in _slice_callables()}
    assert len(_ops()) == 304
    assert all(f"ops.{n}" in labels for n in _ops())


# -- the LoD / recurrent / nn-tail slice: every class, method and function
# it adds binds positional arguments as the reference does ------------------

from paddle_tpu import core as jcore  # noqa: E402
from paddle_tpu.nn import decode as jdecode  # noqa: E402
from paddle_tpu.ops import crf as jcrf  # noqa: E402
from paddle_tpu_torch import core as tcore  # noqa: E402
from paddle_tpu_torch.nn import decode as tdecode  # noqa: E402
from paddle_tpu_torch.ops import crf as tcrf  # noqa: E402

_SLICE_NN = ["Dropout2D", "Flatten", "Pad2D", "Upsample", "BatchNorm",
             "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm",
             "RMSNorm", "GroupNorm", "InstanceNorm2D", "MaxPool1D",
             "MaxPool2D", "AvgPool1D", "AvgPool2D", "AdaptiveAvgPool2D",
             "AdaptiveMaxPool2D", "Identity", "CTCLoss", "Bilinear",
             "BilinearTensorProduct", "CosineSimilarity", "PairwiseDistance",
             "AlphaDropout", "Dropout3D", "Pad1D", "Pad3D", "ZeroPad2D",
             "PixelShuffle", "SpectralNorm", "LocalResponseNorm", "RowConv",
             "InstanceNorm1D", "InstanceNorm3D", "Unfold", "RNNCellBase",
             "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "BiRNN",
             "SimpleRNN", "LSTM", "GRU", "BeamSearchDecoder"]
_SLICE_FUNCTIONAL = ["dropout2d", "pad", "interpolate", "upsample",
                     "cosine_similarity", "unfold", "rms_norm", "group_norm",
                     "instance_norm", "normalize", "one_hot", "ctc_loss",
                     "rnn", "birnn", "embedding"]
_SLICE_OPTIMIZERS = ["Ftrl", "Dpsgd", "DGCMomentum", "dgc_compress",
                     "ExponentialMovingAverage", "ModelAverage", "Lookahead"]


def _lod_rnn_callables():
    pairs = [(f"nn.{n}", getattr(jnn, n), getattr(tnn, n))
             for n in _SLICE_NN]
    for n in ("RNN", "BiRNN", "SimpleRNN", "LSTM", "GRU", "SimpleRNNCell",
              "LSTMCell", "GRUCell"):
        pairs.append((f"nn.{n}.forward", getattr(jnn, n).forward,
                      getattr(tnn, n).forward))
    pairs.append(("RNNCellBase.get_initial_states",
                  jnn.RNNCellBase.get_initial_states,
                  tnn.RNNCellBase.get_initial_states))
    pairs.append(("SyncBatchNorm.convert_sync_batchnorm",
                  jnn.SyncBatchNorm.convert_sync_batchnorm,
                  tnn.SyncBatchNorm.convert_sync_batchnorm))
    for n in ("gather_tree", "dynamic_decode"):
        pairs.append((f"nn.{n}", getattr(jnn, n), getattr(tnn, n)))
    for m in ("tile_beam_merge_with_batch", "initialize", "step"):
        pairs.append((f"BeamSearchDecoder.{m}",
                      getattr(jdecode.BeamSearchDecoder, m),
                      getattr(tdecode.BeamSearchDecoder, m)))
    for n in ("split_states", "concat_states"):
        pairs.append((f"rnn.{n}", getattr(jrnn_mod, n), getattr(trnn_mod, n)))
    for n in _SLICE_FUNCTIONAL:
        pairs.append((f"F.{n}", getattr(JF, n), getattr(TF, n)))
    # the 45 new top-level ops are in the op slice's list above
    for n in ("linear_chain_crf", "crf_decoding"):
        pairs.append((f"crf.{n}", getattr(jcrf, n), getattr(tcrf, n)))
    for n in _SLICE_OPTIMIZERS:
        pairs.append((f"optimizer.{n}", getattr(jopt, n), getattr(topt, n)))
    for m in ("update", "apply", "state_dict", "set_state_dict"):
        pairs.append((f"ExponentialMovingAverage.{m}",
                      getattr(jopt.ExponentialMovingAverage, m),
                      getattr(topt.ExponentialMovingAverage, m)))
    for m in ("init", "update", "get_lr"):
        pairs.append((f"Lookahead.{m}", getattr(jopt.Lookahead, m),
                      getattr(topt.Lookahead, m)))
    for c in ("LoDTensor", "SelectedRows"):
        jc, tc = getattr(jcore, c), getattr(tcore, c)
        for m in [m for m, v in vars(jc).items()
                  if (not m.startswith("__") or m == "__init__")
                  and not isinstance(v, property)]:
            pairs.append((f"core.{c}.{m}", getattr(jc, m), getattr(tc, m)))
    return pairs


from paddle_tpu.nn.layer import rnn as jrnn_mod  # noqa: E402
from paddle_tpu_torch.nn.layer import rnn as trnn_mod  # noqa: E402


@pytest.mark.parametrize("label,ref,port", _lod_rnn_callables(),
                         ids=[c[0] for c in _lod_rnn_callables()])
def test_lod_rnn_positional_parameters_match_the_reference(label, ref,
                                                          port):
    test_positional_parameters_match_the_reference(label, ref, port)


def test_slice_constructors_called_positionally_in_both_packages():
    # GRU(input_size, hidden_size, num_layers, direction, dropout,
    # time_major, weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr)
    j = jnn.GRU(4, 3, 2, "bidirect", 0.0, True, None, None, False, None)
    t = tnn.GRU(4, 3, 2, "bidirect", 0.0, True, None, None, False, None)
    assert set(dict(t.named_parameters())) == set(parameters_dict_j(j))
    assert t.time_major and t[0].cell_fw.bias_ih is None
    # BatchNorm(num_features, momentum, epsilon, weight_attr, bias_attr,
    # data_format)
    jb = jnn.BatchNorm2D(3, 0.5, 1e-3, None, False, "NHWC")
    tb = tnn.BatchNorm2D(3, 0.5, 1e-3, None, False, "NHWC")
    assert tb.bias is None and jb.bias is None and tb.data_format == "NHWC"
    # Dpsgd(learning_rate, clip, batch_size, sigma)
    jd, td = jopt.Dpsgd(0.1, 2.0, 8, 0.5), topt.Dpsgd(0.1, 2.0, 8, 0.5)
    assert (td.clip, td.batch_size, td.sigma) == (jd.clip, jd.batch_size,
                                                  jd.sigma)


def parameters_dict_j(layer):
    return jautograd.parameters_dict(layer)
