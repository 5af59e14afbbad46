"""Slice-level parity of the port's pretraining step against the JAX
package, on the CPU at a small size (V512 H128 L2 A2 I256, batch 2 x seq
128 with a padded row, 8 masked positions).

Weights go JAX -> port through ``convert.from_jax_params``; batches are made
with numpy from a seed.  Tolerances (fp32): the criterion 1e-6; the loss
rel 1e-4 and every parameter's gradient within 1e-4 of that gradient's
largest value (the tied word embedding included), that scale floored at
1e-4 of the largest gradient of all: the key-projection bias's gradient is
zero in exact arithmetic (softmax ignores a shift of a whole row), so both
packages give only rounding noise there; the Adam update atol 1e-6.  At
dropout > 0 no cross-framework comparison exists (the JAX model-level masks
come from ``jax.random``): the step is checked to repeat under one
generator seed and to change under another.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from __graft_entry__ import make_train_step as jax_make_train_step
from paddle_tpu.autograd import parameters_dict as jax_parameters_dict
from paddle_tpu.optimizer import Adam as JaxAdam
from paddle_tpu.text import ernie as jernie
from paddle_tpu_torch import convert
from paddle_tpu_torch import entry as tentry
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.text import ernie as ternie

SMALL = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=256)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
LOSS_REL = 1e-4
GRAD_REL = 1e-4
ADAM_ATOL = 1e-6


class _Capture:
    """An optimizer whose update hands back the gradients, so a train step
    returns them in place of the new parameters."""

    def update(self, grads, state, params, lr=None):
        return grads, state


def _np_params(layer):
    return {k: np.asarray(v) for k, v in jax_parameters_dict(layer).items()}


def _batch(seed=0, b=2, s=128, vocab=512, n_mask=8):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (b, s)).astype(np.int32)
    ids[1, 93:] = 0                                     # padded request
    tt = np.zeros_like(ids)
    tt[:, 64:] = 1
    pos = np.stack([rng.choice(90, n_mask, replace=False)
                    for _ in range(b)]).astype(np.int32)
    labels = rng.integers(0, vocab, (b, n_mask)).astype(np.int32)
    labels[0, -2:] = -1                                 # ignored labels
    nsp = rng.integers(0, 2, (b,)).astype(np.int32)
    return {"input_ids": ids, "token_type_ids": tt, "masked_positions": pos,
            "mlm_labels": labels, "nsp_labels": nsp}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.fixture(scope="module")
def models():
    paddle_tpu.seed(21)
    cfg = dict(SMALL, **NO_DROPOUT)
    jm = jernie.ErnieForPretraining(jernie.ErnieConfig(**cfg))
    jm.train()
    tm = ternie.ErnieForPretraining(ternie.ErnieConfig(**cfg), device="cpu")
    convert.from_jax_params(_np_params(jm), tm)
    return jm, tm


@pytest.fixture(params=[True, False], ids=["kernels", "plain"])
def kernel_flags(request):
    flags.set_flags({"use_flash_attention": request.param,
                     "use_fused_layer_norm": request.param})
    yield request.param
    flags.set_flags({"use_flash_attention": True,
                     "use_fused_layer_norm": True})


def test_pretraining_criterion_matches_jax():
    rng = np.random.default_rng(1)
    scores = rng.normal(0, 3, (2, 8, 512)).astype(np.float32)
    nsp = rng.normal(0, 1, (2, 2)).astype(np.float32)
    labels = rng.integers(0, 512, (2, 8)).astype(np.int32)
    labels[:, ::3] = -1
    nsp_labels = np.array([1, 0], np.int32)
    ref = jernie.ErniePretrainingCriterion(512)(
        jnp.asarray(scores), jnp.asarray(nsp), jnp.asarray(labels),
        jnp.asarray(nsp_labels))
    got = ternie.ErniePretrainingCriterion(512)(
        torch.from_numpy(scores), torch.from_numpy(nsp),
        torch.from_numpy(labels), torch.from_numpy(nsp_labels))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6, atol=1e-6)


def test_cross_entropy_reductions_match_jax():
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn import functional as TF

    rng = np.random.default_rng(2)
    logits = rng.normal(0, 2, (6, 10)).astype(np.float32)
    label = np.array([1, -100, 3, 9, -100, 0], np.int32)
    for reduction in ("mean", "sum", "none"):
        ref = JF.cross_entropy(jnp.asarray(logits), jnp.asarray(label),
                               reduction=reduction)
        got = TF.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(label), reduction=reduction)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
    t = torch.from_numpy(logits).requires_grad_()
    TF.cross_entropy(t, torch.from_numpy(label)).backward()
    assert float(t.grad[1].abs().max()) == 0.0     # ignored rows: no grad


def test_train_step_loss_and_every_gradient_match_jax(models, kernel_flags):
    jm, tm = models
    batch = _batch()
    crit = jernie.ErniePretrainingCriterion(512)
    jstep = jax_make_train_step(jm, crit, _Capture())
    jparams = jax_parameters_dict(jm)
    jgrads, _, jloss = jstep(jparams, None,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(0))
    tstep = tentry.make_train_step(tm, ternie.ErniePretrainingCriterion(512),
                                   _Capture())
    params = convert.parameters_dict(tm)
    tgrads, _, tloss = tstep(params, None, _torch_batch(batch),
                             torch.Generator().manual_seed(0))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=LOSS_REL)
    assert set(tgrads) == set(jgrads)
    assert "ernie.embeddings.word_embeddings.weight" in tgrads
    floor = 1e-4 * max(float(np.abs(np.asarray(g)).max())
                       for g in jgrads.values())
    for name, g in tgrads.items():
        ref = np.asarray(jgrads[name])
        scale = max(float(np.abs(ref).max()), floor)
        err = float(np.abs(g.numpy() - ref).max()) / scale
        assert err <= GRAD_REL, (name, err)


def test_tied_embedding_gradient_sums_both_uses(models):
    """The word-embedding gradient is the embedding gather's plus the MLM
    decoder's: rows of words that never occur in the batch still get the
    decoder's gradient."""
    _, tm = models
    batch = _batch(seed=3)
    step = tentry.make_train_step(tm, ternie.ErniePretrainingCriterion(512),
                                  _Capture())
    grads, _, _ = step(convert.parameters_dict(tm), None, _torch_batch(batch),
                       torch.Generator().manual_seed(0))
    g = grads["ernie.embeddings.word_embeddings.weight"]
    unused = sorted(set(range(512)) - set(batch["input_ids"].ravel()))
    assert unused and float(g[unused].abs().max()) > 0.0


def _adam_inputs(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a.weight": (16, 8), "a.bias": (8,), "b": (3, 5, 2)}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(0, 0.1, s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("steps", [1, 3])
def test_adam_update_matches_jax(steps):
    params, grads = _adam_inputs(steps)
    jopt = JaxAdam(learning_rate=1e-2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    topt = Adam(learning_rate=1e-2)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = topt.init(tp)
    for g in grads[:steps]:
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp)
        tp, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
    assert ts["step"] == int(js["step"]) == steps
    # the JAX state lists each parameter's moments in sorted-name order
    for i, name in enumerate(sorted(params)):
        np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                   rtol=0, atol=ADAM_ATOL, err_msg=name)
        for slot in (0, 1):
            np.testing.assert_allclose(
                ts["per_param"][name][slot].numpy(),
                np.asarray(js["per_param"][i][slot]), rtol=0,
                atol=ADAM_ATOL, err_msg=f"{name} moment {slot}")


def test_adam_updates_in_place_and_stateful_step():
    params, grads = _adam_inputs(4)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    before = {k: v.data_ptr() for k, v in tp.items()}
    opt = Adam(learning_rate=1e-2)
    new, state = opt.update({k: torch.from_numpy(v)
                             for k, v in grads[0].items()}, opt.init(tp), tp)
    assert new is tp and all(v.data_ptr() == before[k] for k, v in tp.items())
    bound = [torch.from_numpy(v.copy()) for v in params.values()]
    facade = Adam(learning_rate=1e-2, parameters=bound)
    facade.step([torch.from_numpy(v) for v in grads[0].values()])
    for p, (name, q) in zip(bound, tp.items()):
        assert torch.equal(p, q), name


def test_bf16_compute_over_fp32_masters(models):
    """The step casts to bf16 inside the loss; gradients land on the fp32
    masters and Adam moves them."""
    _, tm = models
    params = {k: v.detach().clone() for k, v in
              convert.parameters_dict(tm).items()}
    opt = Adam(learning_rate=1e-3)
    state = opt.init(params)
    step = tentry.make_train_step(tm, ternie.ErniePretrainingCriterion(512),
                                  opt, compute_dtype=torch.bfloat16)
    before = {k: v.clone() for k, v in params.items()}
    params, state, loss = step(params, state, _torch_batch(_batch(seed=4)),
                               torch.Generator().manual_seed(0))
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert state["step"] == 1
    for k, v in params.items():
        assert v.dtype == torch.float32
        assert not torch.equal(v, before[k]), k


def _dropout_losses(kernels, seeds):
    flags.set_flags({"use_flash_attention": kernels,
                     "use_fused_layer_norm": kernels})
    try:
        tm = ternie.ErnieForPretraining(
            ternie.ErnieConfig(**SMALL), device="cpu",
            generator=torch.Generator().manual_seed(5)).train()
        step = tentry.make_train_step(
            tm, ternie.ErniePretrainingCriterion(512), _Capture())
        batch = _torch_batch(_batch(seed=6))
        out = []
        for seed in seeds:
            grads, _, loss = step(convert.parameters_dict(tm), None, batch,
                                  torch.Generator().manual_seed(seed))
            out.append((loss.item(),
                        grads["ernie.encoder.layers.0.linear1.weight"]))
        return out
    finally:
        flags.set_flags({"use_flash_attention": True,
                         "use_fused_layer_norm": True})


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
def test_dropout_step_repeats_under_one_seed(kernels):
    (l1, g1), (l2, g2), (l3, g3) = _dropout_losses(kernels, (7, 7, 8))
    assert l1 == l2 and torch.equal(g1, g2)
    assert l1 != l3 and not torch.equal(g1, g3)


def test_rng_scope_draws_host_seeds():
    with trandom.rng_scope(torch.Generator().manual_seed(1)):
        a = [trandom.draw_seed() for _ in range(3)]
    with trandom.rng_scope(torch.Generator().manual_seed(1)):
        b = [trandom.draw_seed() for _ in range(3)]
    assert a == b and len(set(a)) == 3
    assert all(-2 ** 31 <= s < 2 ** 31 for s in a)
    trandom.seed(3)
    c = trandom.draw_seed()
    trandom.seed(3)
    assert trandom.draw_seed() == c
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError):
        trandom.rng_scope(on_card)   # seeds are drawn on the host only
