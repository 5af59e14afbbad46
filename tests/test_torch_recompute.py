"""Recompute in the port (paddle_tpu_torch.autograd.recompute and
``TransformerEncoder(enable_recompute=...)``) on the CPU.

* ``recompute`` against the plain function for each policy name (values
  and gradients bit for bit), and the policy names resolved as the JAX
  package's ``checkpoint_policy`` resolves them.
* A post-LN encoder with recompute on and off: the same loss and the same
  gradients, bit for bit, at dropout 0 and, under one host generator, at
  dropout 0.1 (the replay must draw the forward's dropout seeds), and the
  host generator ends in the same state; with the kernel flags on (the
  kernels' plain versions here) and off.
* No recompute in eval mode or under ``no_grad``.
* A small ERNIE (V512 H128 L2 A2 I256, b2 s128) with
  ``enable_recompute=True`` against the JAX package's ``make_train_step``:
  loss rel 1e-4 and every gradient within 1e-4 of its largest value
  (floored at 1e-4 of the largest of all, as tests/test_torch_train.py);
  the BERT recipe's update (AdamW 0.01, LinearWarmup over PolynomialDecay,
  ClipGradByGlobalNorm 1.0) on those gradients atol 1e-6; and the eager
  loop ``loss.backward(); opt.step(); opt.clear_grad()`` equal to the
  functional step from the same state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from __graft_entry__ import make_train_step as jax_make_train_step
from paddle_tpu import optimizer as jopt
from paddle_tpu.autograd import checkpoint_policy as jax_checkpoint_policy
from paddle_tpu.autograd import parameters_dict as jax_parameters_dict
from paddle_tpu.text import ernie as jernie
from paddle_tpu_torch import autograd as tautograd
from paddle_tpu_torch import convert
from paddle_tpu_torch import entry as tentry
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.text import ernie as ternie

POLICIES = [None, "", "nothing_saveable", "everything_saveable",
            "dots_saveable", "dots_with_no_batch_dims_saveable"]
SMALL = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=256,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
LOSS_REL = 1e-4
GRAD_REL = 1e-4
ATOL = 1e-6


@pytest.fixture(params=[True, False], ids=["kernels", "plain"])
def kernel_flags(request):
    flags.set_flags({"use_flash_attention": request.param,
                     "use_fused_layer_norm": request.param})
    yield request.param
    flags.set_flags({"use_flash_attention": True,
                     "use_fused_layer_norm": True})


def _fn(x, w):
    h = torch.tanh(x @ w)
    return (torch.bmm(h[None], h.t()[None])[0] * 0.5).sin().sum(dim=0)


@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_matches_the_plain_function(policy):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 5, generator=g, requires_grad=True)
    w = torch.randn(5, 4, generator=g, requires_grad=True)
    ref = _fn(x, w)
    gx, gw = torch.autograd.grad(ref.sum(), [x, w])
    out = tautograd.recompute(_fn, x, w, policy=policy)
    rx, rw = torch.autograd.grad(out.sum(), [x, w])
    assert torch.equal(out, ref)
    assert torch.equal(rx, gx) and torch.equal(rw, gw)


def test_policy_names_resolve_as_the_reference():
    for name in POLICIES:
        assert (tautograd.checkpoint_policy(name) is None) == \
            (jax_checkpoint_policy(name) is None), name
    assert callable(tautograd.checkpoint_policy("dots_saveable"))
    for mod in (tautograd.checkpoint_policy, jax_checkpoint_policy):
        with pytest.raises(ValueError):
            mod("bogus_policy")


def _encoder_grads(remat, rate, policy=None, seed=3):
    layer = tnn.TransformerEncoderLayer(
        128, 2, 256, dropout=rate, activation="gelu",
        generator=torch.Generator().manual_seed(seed))
    enc = tnn.TransformerEncoder(layer, 3, enable_recompute=remat,
                                 recompute_policy=policy,
                                 generator=torch.Generator().manual_seed(4))
    enc.train()
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 64, 128, generator=g, requires_grad=True)
    mask = torch.zeros(2, 1, 1, 64)
    mask[1, ..., 50:] = -1e4
    gen = torch.Generator().manual_seed(11)
    with trandom.rng_scope(gen):
        out = enc(x, src_mask=mask)
    loss = (out.float() ** 2).mean()
    names = [n for n, _ in enc.named_parameters()]
    grads = torch.autograd.grad(loss, [x] + list(enc.parameters()))
    return loss, dict(zip(["x"] + names, grads)), gen.get_state()


@pytest.mark.parametrize("policy", [None, "dots_saveable"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_encoder_recompute_is_bit_identical(rate, policy, kernel_flags):
    l0, g0, s0 = _encoder_grads(False, rate)
    l1, g1, s1 = _encoder_grads(True, rate, policy)
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    assert torch.equal(s0, s1)          # the host generator ends alike
    if rate > 0:
        l2, _, _ = _encoder_grads(False, rate, seed=3)
        assert torch.equal(l0, l2)


def test_dropout_is_on_in_the_recompute_check():
    """At rate 0.1 the loss differs from rate 0: the bit-identity above
    holds with masks drawn."""
    assert not torch.equal(_encoder_grads(True, 0.1)[0],
                           _encoder_grads(True, 0.0)[0])


def test_recompute_off_in_eval_mode_and_without_grad(monkeypatch):
    calls = []
    real = tautograd._ckpt.checkpoint

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tautograd._ckpt, "checkpoint", counting)
    m = ternie.ErnieForPretraining(
        ternie.ErnieConfig(**dict(SMALL, enable_recompute=True)),
        device="cpu", generator=torch.Generator().manual_seed(0))
    ids = torch.randint(1, 512, (2, 32),
                        generator=torch.Generator().manual_seed(1))
    m.eval()
    m(ids)[0].sum().backward()
    assert not calls
    m.train()
    with torch.no_grad():
        m(ids)
    assert not calls
    m(ids)[0].sum().backward()
    assert len(calls) == SMALL["num_hidden_layers"]


def _batch(seed=0, b=2, s=128, vocab=512, n_mask=8):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (b, s)).astype(np.int32)
    ids[1, 93:] = 0
    tt = np.zeros_like(ids)
    tt[:, 64:] = 1
    pos = np.stack([rng.choice(90, n_mask, replace=False)
                    for _ in range(b)]).astype(np.int32)
    labels = rng.integers(0, vocab, (b, n_mask)).astype(np.int32)
    labels[0, -2:] = -1
    nsp = rng.integers(0, 2, (b,)).astype(np.int32)
    return {"input_ids": ids, "token_type_ids": tt, "masked_positions": pos,
            "mlm_labels": labels, "nsp_labels": nsp}


class _Capture:
    def update(self, grads, state, params, lr=None):
        return grads, state


def _recipe(mod, total=100):
    sched = mod.lr.LinearWarmup(
        mod.lr.PolynomialDecay(1e-4, total, end_lr=0.0, power=1.0), 10, 0.0,
        1e-4)
    return mod.AdamW(sched, weight_decay=0.01,
                     grad_clip=mod.ClipGradByGlobalNorm(1.0))


@pytest.fixture(scope="module")
def models():
    paddle_tpu.seed(21)
    jm = jernie.ErnieForPretraining(jernie.ErnieConfig(
        **dict(SMALL, enable_recompute=True)))
    jm.train()
    tm = ternie.ErnieForPretraining(ternie.ErnieConfig(
        **dict(SMALL, enable_recompute=True)), device="cpu")
    convert.from_jax_params({k: np.asarray(v) for k, v in
                             jax_parameters_dict(jm).items()}, tm)
    tm.train()
    return jm, tm


def test_recompute_recipe_step_matches_jax(models, kernel_flags):
    jm, tm = models
    batch = _batch()
    crit = jernie.ErniePretrainingCriterion(512)
    jparams = jax_parameters_dict(jm)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads, _, jloss = jax_make_train_step(jm, crit, _Capture())(
        jparams, None, jbatch, jax.random.PRNGKey(0))
    tstep = tentry.make_train_step(tm, ternie.ErniePretrainingCriterion(512),
                                   _Capture())
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    tgrads, _, tloss = tstep(convert.parameters_dict(tm), None, tbatch,
                             torch.Generator().manual_seed(0))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=LOSS_REL)
    assert set(tgrads) == set(jgrads)
    floor = 1e-4 * max(float(np.abs(np.asarray(g)).max())
                       for g in jgrads.values())
    for name, g in tgrads.items():
        ref = np.asarray(jgrads[name])
        scale = max(float(np.abs(ref).max()), floor)
        assert float(np.abs(g.numpy() - ref).max()) / scale <= GRAD_REL, name
    # the recipe's update on the same (JAX) gradients
    jo, to = _recipe(jopt), _recipe(topt)
    jp = {k: v for k, v in jparams.items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(2):
        jp, js = jo.update(jgrads, js, jp)
        to.update({k: torch.from_numpy(np.array(v))
                   for k, v in jgrads.items()}, ts, tp)
    for k in tp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=ATOL, err_msg=k)


def test_eager_loop_equals_the_functional_step():
    cfg = ternie.ErnieConfig(**dict(SMALL, enable_recompute=True,
                                    hidden_dropout_prob=0.1,
                                    attention_probs_dropout_prob=0.1))
    crit = ternie.ErniePretrainingCriterion(512)
    tbatch = {k: torch.from_numpy(v).long() for k, v in _batch(1).items()}
    m1 = ternie.ErnieForPretraining(cfg, device="cpu",
                                    generator=torch.Generator().manual_seed(5))
    m2 = ternie.ErnieForPretraining(cfg, device="cpu",
                                    generator=torch.Generator().manual_seed(5))
    m1.train()
    m2.train()
    opt1 = _recipe(topt)
    opt1._parameters = list(m1.parameters())
    opt2 = _recipe(topt)
    params = convert.parameters_dict(m2)
    state = opt2.init(params)
    step = tentry.make_train_step(m2, crit, opt2)
    for i in range(2):
        gen = torch.Generator().manual_seed(100 + i)
        with trandom.rng_scope(gen):
            logits, nsp = m1(tbatch["input_ids"], tbatch["token_type_ids"],
                             masked_positions=tbatch["masked_positions"])
            loss1 = crit(logits.float(), nsp.float(), tbatch["mlm_labels"],
                         tbatch["nsp_labels"])
        loss1.backward()
        opt1.step()
        opt1.clear_grad()
        params, state, loss2 = step(params, state, tbatch,
                                    torch.Generator().manual_seed(100 + i))
        assert torch.equal(loss1.detach(), loss2)
    for (name, p1), p2 in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(p1, p2), name


@pytest.mark.parametrize("policy", [None, "dots_saveable"])
def test_recompute_replays_under_the_train_steps_bf16_binding(policy):
    """The replay runs in the backward, after ``functional_call`` has put
    the module's own fp32 parameters back: the encoder hands the bf16
    casts it was called with to the replay, so a bf16 step with recompute
    equals one without, bit for bit (dropout 0.1, one generator)."""
    def grads(remat):
        cfg = ternie.ErnieConfig(**dict(
            SMALL, enable_recompute=remat, recompute_policy=policy,
            hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1))
        m = ternie.ErnieForPretraining(
            cfg, device="cpu", generator=torch.Generator().manual_seed(2))
        m.train()
        step = tentry.make_train_step(
            m, ternie.ErniePretrainingCriterion(512), _Capture(),
            torch.bfloat16)
        tbatch = {k: torch.from_numpy(v).long()
                  for k, v in _batch(4).items()}
        g, _, loss = step(convert.parameters_dict(m), None, tbatch,
                          torch.Generator().manual_seed(9))
        return loss, g

    l0, g0 = grads(False)
    l1, g1 = grads(True)
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
