"""ERNIE sentence-classification fine-tuning through the dygraph loop, the
port against the JAX package on the CPU.

A 2-layer, d64 ``ErnieForSequenceClassification`` (one 64-wide head, the
kernels' head width) takes 3 steps of BERT's GLUE recipe (Devlin et al.
2019, App. A.3: AdamW at lr 2e-5, weight decay 0.01, linear warm-up over
the first 10% into a linear decay, global-norm clip 1.0) in fp32 at
dropout 0, from the JAX model's ``state_dict()`` put in with
``set_state_dict``, on padded batches (key lengths 8-32 of 32)::

    loss = mean(cross_entropy(model(ids, types, attention_mask=mask), y))
    loss.backward(); opt.minimize(loss); model.clear_gradients()

The JAX loop runs on its replay tape under ``paddle_tpu.dygraph.guard()``;
the JAX gradients of the first step come from its functional
``autograd.value_and_grad`` on the same model and batch.  Held: the losses at rtol 1e-4 (fp32 sums in another order, carried
through three Adam steps: 1.0e-5 at the third), and the first step's
gradients tensor by tensor, each within 1e-4 of its largest value,
floored at 1e-3 of the largest gradient of all (the key-projection
biases' gradient is zero in exact arithmetic, softmax shift invariance,
so theirs is rounding noise; the others read 1.4e-6 of their own max).
The parameters after the Adam steps are not compared: Adam divides each
gradient component by its running RMS, so a component near rounding noise
takes a full step that follows the noise, and such a check failed in some
runs at 2 intra-op threads.  The port's loop is also held bit for bit against its own
``autograd.value_and_grad`` + ``opt.update`` path, as the reference's
``test_tape_matches_functional_path`` does; and one eval batch's accuracy
(``argmax``, ``equal``, ``cast``, ``mean``) against the JAX package's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpd
import paddle_tpu.autograd as jautograd
import paddle_tpu.dygraph as jdygraph
import paddle_tpu.nn.functional as JF
from paddle_tpu import optimizer as JO
from paddle_tpu.text import ernie as JE
import paddle_tpu_torch as P
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import autograd as tautograd
from paddle_tpu_torch import dygraph as tdygraph
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.text import ernie as TE

CFG = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=1, intermediate_size=128,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
B, S, STEPS, TOTAL = 4, 32, 3, 10
LR = 2e-5
LOSS_RTOL = 1e-4
GRAD_REL = 1e-4
GRAD_FLOOR = 1e-3


@pytest.fixture(autouse=True)
def _cpu():
    with P.device_guard("cpu"):
        yield


def _batch(seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, S + 1, B)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    ids = rng.integers(1, CFG["vocab_size"], (B, S)).astype(np.int32) * mask
    return ids, np.zeros_like(ids), mask, rng.integers(0, 2, B).astype(
        np.int32)


def _recipe(O, parameters=None):
    sched = O.lr.LinearWarmup(
        O.lr.PolynomialDecay(LR, TOTAL, end_lr=0.0, power=1.0),
        TOTAL // 10, 0.0, LR)
    return O.AdamW(sched, parameters=parameters, weight_decay=0.01,
                   grad_clip=O.ClipGradByGlobalNorm(1.0))


def _jax_loss(model):
    def loss_fn(ids, types, mask, y):
        return jpd.mean(JF.cross_entropy(
            model(ids, types, attention_mask=mask), y))
    return loss_fn


@pytest.fixture(scope="module")
def reference():
    """The JAX loop: initial state, losses, final state, eval accuracy;
    and the first step's gradients, from ``autograd.value_and_grad`` (the
    tape's ``loss.backward()`` doubles some parameters' gradients in some
    runs, ROADMAP.md Queue 3)."""
    batches = [_batch(i) for i in range(STEPS + 1)]
    with jdygraph.guard():
        jpd.seed(0)
        model = JE.ErnieForSequenceClassification(JE.ErnieConfig(**CFG),
                                                  num_classes=2)
        state0 = {k: np.asarray(v) for k, v in model.state_dict().items()}
        opt = _recipe(JO, model.parameters())
        _, grads0 = jautograd.value_and_grad(model, _jax_loss(model))(
            jautograd.parameters_dict(model),
            *[jpd.to_tensor(a) for a in batches[0]])
        grads0 = {k: np.asarray(v) for k, v in grads0.items()}
        losses = []
        for ids, types, mask, y in batches[:STEPS]:
            logits = model(jpd.to_tensor(ids), jpd.to_tensor(types),
                           attention_mask=jpd.to_tensor(mask))
            loss = jpd.mean(JF.cross_entropy(logits, jpd.to_tensor(y)))
            loss.backward()
            opt.minimize(loss)
            model.clear_gradients()
            losses.append(float(loss))
    model.eval()
    ids, types, mask, y = batches[STEPS]
    with jpd.no_grad():
        logits = model(jpd.to_tensor(ids), jpd.to_tensor(types),
                       attention_mask=jpd.to_tensor(mask))
        acc = jpd.mean(jpd.cast(jpd.equal(jpd.argmax(logits, -1),
                                          jpd.to_tensor(y)), "float32"))
    final = {k: np.asarray(v) for k, v in model.state_dict().items()}
    return (batches, state0, losses, final, float(acc), np.asarray(logits),
            grads0)


def _port_model(state0):
    model = TE.ErnieForSequenceClassification(TE.ErnieConfig(**CFG),
                                              num_classes=2)
    missing, unexpected = model.set_state_dict(state0)
    assert missing == [] and unexpected == []
    return model


def _port_loop(model, batches, grads0=None):
    """The dygraph loop; with a dict ``grads0``, the first step's
    gradients go into it by parameter name."""
    opt = _recipe(TO, model.parameters())
    losses = []
    with tdygraph.guard():
        for ids, types, mask, y in batches[:STEPS]:
            logits = model(P.to_tensor(ids), P.to_tensor(types),
                           attention_mask=P.to_tensor(mask))
            loss = P.mean(TF.cross_entropy(logits, P.to_tensor(y)))
            loss.backward()
            if grads0 is not None and not losses:
                grads0.update((k, p.grad.detach().clone())
                              for k, p in model.named_parameters())
            opt.minimize(loss)
            model.clear_gradients()
            losses.append(loss.detach())
    return losses


def test_state_dict_keys_and_the_loop_match_the_reference(reference):
    batches, state0, ref_losses, _, _, _, ref_grads = reference
    model = _port_model(state0)
    assert list(model.state_dict()) == list(state0)
    grads = {}
    losses = _port_loop(model, batches, grads)
    np.testing.assert_allclose([float(l) for l in losses], ref_losses,
                               rtol=LOSS_RTOL)
    assert sorted(grads) == sorted(ref_grads)
    top = max(float(np.abs(g).max()) for g in ref_grads.values())
    worst = []
    for k, ref in ref_grads.items():
        err = float(np.abs(grads[k].numpy() - ref).max())
        scale = max(float(np.abs(ref).max()), GRAD_FLOOR * top)
        worst.append((err / scale, k))
    for r, k in worst:
        assert r <= GRAD_REL, (k, r)


def test_eval_accuracy_matches_the_reference(reference):
    batches, state0, _, final, ref_acc, ref_logits, _ = reference
    model = _port_model(final)
    model.eval()
    ids, types, mask, y = batches[STEPS]
    with P.no_grad():
        logits = model(P.to_tensor(ids), P.to_tensor(types),
                       attention_mask=P.to_tensor(mask))
        acc = P.mean(P.cast(P.equal(P.argmax(logits, -1), P.to_tensor(y)),
                            "float32"))
    assert not logits.requires_grad
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=1e-5,
                               atol=1e-6)
    assert float(acc) == ref_acc


def test_loop_is_bit_for_bit_the_functional_path(reference):
    """``loss.backward(); opt.minimize(loss)`` against
    ``autograd.value_and_grad`` + ``opt.update`` from one state."""
    batches, state0 = reference[0], reference[1]
    eager = _port_model(state0)
    eager_losses = _port_loop(eager, batches)

    model = _port_model(state0)
    opt = _recipe(TO)
    params = tautograd.parameters_dict(model)
    state = opt.init(params)

    def loss_fn(ids, types, mask, y):
        return P.mean(TF.cross_entropy(
            model(ids, types, attention_mask=mask), y))

    step = tautograd.value_and_grad(model, loss_fn)
    fn_losses = []
    for batch in batches[:STEPS]:
        loss, grads = step(params, *[P.to_tensor(a) for a in batch])
        params, state = opt.update(grads, state, params)
        fn_losses.append(loss)
    for a, b in zip(eager_losses, fn_losses):
        assert torch.equal(a, b)
    for (k, a), b in zip(eager.state_dict().items(),
                         model.state_dict().values()):
        assert torch.equal(a, b), k


def test_bert_aliases():
    assert TE.BertConfig is TE.ErnieConfig
    assert TE.BertModel is TE.ErnieModel
    assert TE.BertForPretraining is TE.ErnieForPretraining
    assert JE.BertModel is JE.ErnieModel
