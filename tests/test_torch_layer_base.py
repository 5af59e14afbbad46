"""The ``Layer`` API of the port against the JAX package's, on the CPU.

Held: the registries (parameters, sublayers, buffers, persistable or
not), ``create_parameter`` / ``add_parameter`` / ``add_sublayer``,
``state_dict`` (a tied parameter once, under its first name) and
``set_state_dict`` both ways with equal outputs, forward pre / post
hooks, ``train`` / ``eval``, ``to("bfloat16")``, ``LayerList`` /
``Sequential`` / ``ParameterList``, ``clear_gradients``, ``Parameter``'s
fields, and that torch's machinery still binds through the overrides
(``torch.func.functional_call``, ``load_state_dict``, deep copies,
pickling).  Outputs agree at rtol 1e-5 / atol 1e-6 (fp32, the same
arithmetic in another order).
"""
import copy
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpd
import paddle_tpu.nn as jnn
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.text import ernie as JE
import paddle_tpu_torch as pd
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.nn import initializer as tinit
from paddle_tpu_torch.text import ernie as TE

SMALL = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=1, intermediate_size=128,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True)
def _cpu():
    with pd.device_guard("cpu"):
        yield


def _np_state(layer):
    return {k: np.asarray(v) for k, v in layer.state_dict().items()}


def _block(pkg, init):
    """The same small layer written against each package."""

    class Block(pkg.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pkg.Linear(4, 3)
            self.scale = self.create_parameter(
                [3], default_initializer=init.Constant(2.0))
            self.add_parameter("shift", self.create_parameter(
                [3], is_bias=True))
            self.register_buffer("count", np.zeros((1,), np.float32))
            self.register_buffer("scratch", np.ones((2,), np.float32),
                                 persistable=False)
            self.add_sublayer("act", pkg.ReLU())

        def forward(self, x):
            return self.act(self.fc(x)) * self.scale + self.shift

    return Block()


def test_layer_registries_match_the_reference():
    j, t = _block(jnn, jinit), _block(nn, tinit)
    assert [n for n, _ in t.named_parameters()] \
        == [n for n, _ in j.named_parameters()]
    assert [n for n, _ in t.named_parameters(include_sublayers=False)] \
        == [n for n, _ in j.named_parameters(include_sublayers=False)]
    assert [n for n, _ in t.named_sublayers()] \
        == [n for n, _ in j.named_sublayers()]
    assert len(t.sublayers(include_self=True)) \
        == len(j.sublayers(include_self=True)) == 3
    assert [n for n, _ in t.named_buffers()] \
        == [n for n, _ in j.named_buffers()]
    assert [n for n, _ in t.named_buffers(persistable_only=True)] \
        == [n for n, _ in j.named_buffers(persistable_only=True)] == ["count"]
    assert list(t.state_dict()) == list(j.state_dict())
    assert list(t.state_dict(include_non_persistable_buffer=True)) \
        == list(j.state_dict(include_non_persistable_buffer=True))
    assert isinstance(t.scale, nn.Parameter) and t.scale.trainable
    assert float(t.scale.min()) == 2.0 and float(t.shift.abs().max()) == 0.0
    assert isinstance(t.parameters(), list) and len(t.parameters()) == 4
    # the same function of the same weights
    missing, unexpected = t.set_state_dict(_np_state(j))
    assert missing == [] and unexpected == []
    x = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    np.testing.assert_allclose(t(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(j(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-6)


def test_set_state_dict_reports_missing_and_unexpected():
    j, t = _block(jnn, jinit), _block(nn, tinit)
    state = _np_state(t)
    state.pop("scale")
    state["extra"] = np.zeros(1, np.float32)
    assert t.set_state_dict(state) == j.set_state_dict(state) \
        == (["scale"], ["extra"])
    with pytest.raises(ValueError, match="shape"):
        t.set_state_dict({"scale": np.zeros(4, np.float32)})


@pytest.mark.parametrize("cls", ["ErnieForPretraining",
                                 "ErnieForSequenceClassification"])
def test_ernie_state_dict_round_trip(cls):
    """The keys equal the JAX model's (the MLM decoder, tied to the word
    embedding, once); JAX -> port and port -> JAX give equal outputs."""
    jpd.seed(3)
    jm = getattr(JE, cls)(JE.ErnieConfig(**SMALL))
    tm = getattr(TE, cls)(TE.ErnieConfig(**SMALL), device="cpu",
                          generator=torch.Generator().manual_seed(5))
    jm.eval()
    tm.eval()
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert tm.set_state_dict(_np_state(jm)) == ([], [])
    ids = np.random.default_rng(1).integers(1, 128, (2, 16)).astype(np.int32)
    ids[1, 10:] = 0

    def outs(j, t):
        jo = j(jnp.asarray(ids))
        with torch.no_grad():
            to = t(torch.from_numpy(ids))
        return ([np.asarray(o) for o in jo] if isinstance(jo, tuple)
                else [np.asarray(jo)],
                [o.numpy() for o in to] if isinstance(to, tuple)
                else [to.numpy()])

    for a, b in zip(*outs(jm, tm)):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    # and back: fresh weights in the port, into a fresh JAX model
    tm2 = getattr(TE, cls)(TE.ErnieConfig(**SMALL), device="cpu",
                           generator=torch.Generator().manual_seed(9))
    tm2.eval()
    jm2 = getattr(JE, cls)(JE.ErnieConfig(**SMALL))
    jm2.eval()
    missing, unexpected = jm2.set_state_dict(
        {k: v.numpy() for k, v in tm2.state_dict().items()})
    assert missing == [] and unexpected == []
    for a, b in zip(*outs(jm2, tm2)):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


def test_tied_state_dict_loads_with_torch_load_state_dict():
    tm = TE.ErnieForPretraining(TE.ErnieConfig(**SMALL), device="cpu")
    sd = tm.state_dict()
    assert "cls.predictions.decoder_weight" not in sd
    other = TE.ErnieForPretraining(TE.ErnieConfig(**SMALL), device="cpu",
                                   generator=torch.Generator().manual_seed(1))
    other.load_state_dict(sd)
    for (k, a), b in zip(sd.items(), other.state_dict().values()):
        assert torch.equal(a, b), k
    assert other.cls.predictions.decoder_weight \
        is other.ernie.embeddings.word_embeddings.weight
    # torch's own recursion (a destination and a prefix) is torch's: every
    # name, the tied one included
    dest = {}
    other.cls.predictions.state_dict(destination=dest, prefix="p.")
    assert "p.decoder_weight" in dest and "p.decoder_bias" in dest


def test_forward_hooks_match_the_reference():
    for pkg, to_t in ((jnn, jnp.asarray), (nn, torch.from_numpy)):
        lin = pkg.Linear(2, 2)
        seen = []
        pre = lin.register_forward_pre_hook(
            lambda layer, args: (args[0] * 0.0,))
        post = lin.register_forward_post_hook(
            lambda layer, args, out: seen.append(out) or out + 1.0)
        out = lin(to_t(np.ones((1, 2), np.float32)))
        assert len(seen) == 1
        np.testing.assert_allclose(np.asarray(out if pkg is jnn
                                              else out.detach()),
                                   np.ones((1, 2)), atol=1e-7)
        pre.remove()
        post.remove()
        out = lin(to_t(np.zeros((1, 2), np.float32)))
        assert len(seen) == 1
        np.testing.assert_allclose(np.asarray(out if pkg is jnn
                                              else out.detach()),
                                   np.zeros((1, 2)), atol=1e-7)


def test_train_eval_and_to_bfloat16():
    for pkg in (jnn, nn):
        m = pkg.Sequential(pkg.Linear(2, 3), pkg.Dropout(0.5))
        assert m.eval() is m
        assert not any(l.training for l in m.sublayers(include_self=True))
        assert m.train() is m
        assert all(l.training for l in m.sublayers(include_self=True))
    t = _block(nn, tinit)
    assert t.to("bfloat16") is t
    assert all(p.dtype == torch.bfloat16 for p in t.parameters())
    assert t.count.dtype == torch.bfloat16
    assert isinstance(t.fc.weight, nn.Parameter)
    t.to(torch.device("cpu"), dtype=torch.float32)
    assert t.fc.weight.dtype == torch.float32
    j = _block(jnn, jinit).to("bfloat16")
    assert all(p.dtype == jnp.bfloat16 for p in j.parameters())


def test_containers_and_clear_gradients():
    for pkg in (jnn, nn):
        ll = pkg.LayerList([pkg.Linear(2, 2), pkg.Linear(2, 3)])
        ll.append(pkg.Linear(3, 1))
        assert len(ll) == 3 and isinstance(ll[-1], pkg.Linear)
        assert isinstance(ll[1:], pkg.LayerList) and len(ll[1:]) == 2
        assert [n for n, _ in ll.named_parameters()][:2] == ["0.weight",
                                                            "0.bias"]
        seq = pkg.Sequential([("a", pkg.Linear(2, 2)), ("b", pkg.ReLU())])
        assert [n for n, _ in seq.named_sublayers()] == ["a", "b"]
        assert len(seq) == 2 and isinstance(seq[1], pkg.ReLU)
        pl = pkg.ParameterList([np.ones(2, np.float32)])
        pl.append(pkg.Parameter(np.zeros(3, np.float32)))
        assert len(pl) == 2 and isinstance(pl[1], pkg.Parameter)
        assert [n for n, _ in pl.named_parameters()] == ["0", "1"]
    m = nn.Sequential(nn.Linear(2, 3), nn.Tanh(), nn.Linear(3, 1))
    pd.sum(m(pd.to_tensor(np.ones((4, 2), np.float32)))).backward()
    assert all(p.grad is not None for p in m.parameters())
    m.clear_gradients()
    assert all(p.grad is None for p in m.parameters())


def test_parameter_fields():
    init = tinit.Constant(0.5)
    p = nn.Parameter(np.ones((2, 3), np.float32), True, "w", init)
    assert p.name == "w" and p.trainable and not p.stop_gradient
    assert p.initializer is init and p.requires_grad
    p.trainable = False
    assert not p.requires_grad and p.stop_gradient
    p.trainable = True
    p.set_value(np.full((2, 3), 4.0))
    np.testing.assert_array_equal(p.numpy(), np.full((2, 3), 4.0))
    with pytest.raises(ValueError):
        p.set_value(np.zeros(3))
    (p * 2).sum().backward()
    assert p.grad is not None
    p.clear_gradient()
    assert p.grad is None
    q = copy.deepcopy(p)
    assert isinstance(q, nn.Parameter) and q.name == "w" \
        and q.initializer is not None and q is not p
    r = pickle.loads(pickle.dumps(p))
    assert isinstance(r, nn.Parameter) and r.name == "w"
    assert torch.equal(r.detach(), p.detach())
    # torch's keyword and an integer value (never trainable)
    assert not nn.Parameter(torch.zeros(2), requires_grad=False).trainable
    assert not nn.Parameter(np.arange(3)).requires_grad
    # the JAX package's Parameter takes the same positional order
    jp = jnn.Parameter(np.ones((2, 3), np.float32), True, "w")
    assert jp.name == "w" and jp.trainable


def test_torch_functional_call_binds_through_layer():
    m = TE.ErnieForSequenceClassification(TE.ErnieConfig(**SMALL),
                                          device="cpu")
    m.eval()
    ids = torch.randint(1, 128, (2, 8))
    params = {k: torch.zeros_like(v) for k, v in m.named_parameters()}
    with torch.no_grad():
        out = torch.func.functional_call(m, params, (ids,))
        own = m(ids)
    assert torch.equal(out, torch.zeros_like(out)) and own.abs().max() > 0
    names = [n for n, _ in m.named_parameters(remove_duplicate=False)]
    assert len(names) == len(set(names)) == len(list(m.parameters()))
