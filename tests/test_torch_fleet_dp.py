"""Data-parallel ERNIE pretraining on 2 gloo ranks on the CPU against the
JAX package's single-device step on the full batch.

A small ERNIE (2 layers, hidden 64, 4 heads, I 128, vocab 128, s16; the
JAX model's weights put into the port with ``convert.from_jax_params``)
takes 3 steps of ``entry.make_train_step`` with ``DataParallel``
(``comm_buffer_size`` 0.1 MB: several buckets) and fleet's
``DistributedOptimizer(Adam)``, each rank on its half of the batch
(``shard_batch``).  Every masked label counts, so the ranks' halves hold
equal token counts and the mean of their losses and gradients is the full
batch's.  Held:

* the first step's averaged gradients, tensor by tensor, within 1e-4 of
  each gradient's largest value floored at 1e-4 of the largest of all
  (tests/test_torch_train.py's tolerance), equal on both ranks bit for
  bit;
* the mean of the ranks' losses against the JAX loss at each of the 3
  steps (JAX Adam on the full batch), rtol 1e-4;
* with ``comm_quantize`` int8 / fp8 (fleet owns the sync), the first
  step's gradients within the blockwise bound of the uncompressed ones:
  per block of each bucket, c x the largest of the ranks' block maxima M.
  int8 rounds to half a step of M / 127 in each of the two quantizations,
  the second on values up to M (1 + 1/254): c = (2 + 1/254) / 254.  fp8
  (e4m3) rounds within 1/16 of a value: c = (2 + 1/16) / 16.  Each c
  times 1 + 1e-6 for the fp32 arithmetic around the roundings.
"""
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
from paddle_tpu_torch.parallel import compress as TC
import torch_parallel_job as J

LOSS_REL = 1e-4
GRAD_REL = 1e-4
BOUND = {"int8": (2 + 1 / 254) / 254 * (1 + 1e-6),
         "fp8": (2 + 1 / 16) / 16 * (1 + 1e-6)}


class _Capture:
    def update(self, grads, state, params, lr=None):
        return grads, state


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX model's weights (written for the job), its first full-batch
    gradients and its losses over the steps; then the 2-rank job."""
    paddle_tpu.seed(5)
    jm = jernie.ErnieForPretraining(jernie.ErnieConfig(**J.ERNIE))
    jm.train()
    params = jax_parameters_dict(jm)
    out = tmp_path_factory.mktemp("fleet_dp")
    np.savez(out / "ernie_params.npz",
             **{k: np.asarray(v) for k, v in params.items()})
    crit = jernie.ErniePretrainingCriterion(J.ERNIE["vocab_size"])

    def batch(i):
        return {k: jnp.asarray(v.astype(np.int32))
                for k, v in J.ernie_batch(i).items()}

    grads, _, _ = jax_make_train_step(jm, crit, _Capture())(
        params, None, batch(0), jax.random.PRNGKey(0))
    opt = JaxAdam(learning_rate=J.ERNIE_LR)
    step = jax_make_train_step(jm, crit, opt)
    state, losses = opt.init(params), []
    for i in range(J.ERNIE_STEPS):
        params, state, loss = step(params, state, batch(i),
                                   jax.random.PRNGKey(0))
        losses.append(float(loss))
    rc, secs, log = J.run_job(out, 2, ["ernie_dp"])
    assert rc == 0, log[-4000:]
    return out, {k: np.asarray(v) for k, v in grads.items()}, losses


def _part(res, prefix):
    return {k[len(prefix) + 1:]: v for k, v in res.items()
            if k.startswith(prefix + "/")}


def test_averaged_first_step_gradients_match_the_full_batch(reference):
    out, ref, _ = reference
    got = [_part(J.result(out, "ernie_dp", r), "grad") for r in (0, 1)]
    assert set(got[0]) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[0][k], got[1][k])
    floor = 1e-4 * max(float(np.abs(g).max()) for g in ref.values())
    for k, g in ref.items():
        scale = max(float(np.abs(g).max()), floor)
        err = float(np.abs(got[0][k] - g).max()) / scale
        assert err <= GRAD_REL, (k, err)
    # the buckets the bucketer formed: several
    rev = list(reversed(TC._flatten(got[0])))
    assert len(TC.bucket_assignment([v.size * 4 for _, v in rev],
                                    J.ERNIE_BUFFER_MB)) >= 3


def test_mean_rank_loss_follows_the_full_batch_over_the_steps(reference):
    out, _, ref_losses = reference
    losses = np.mean([J.result(out, "ernie_dp", r)["losses"]
                      for r in (0, 1)], axis=0)
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_REL)


def _block_bound(locals_, kind, block=256):
    """Per element of each leaf: BOUND[kind] x the largest of the ranks'
    maxima over the element's quantization block (blocks of each bucket's
    flat buffer, as the bucketer lays them out)."""
    names = sorted(locals_[0], reverse=True)   # reversed pytree order
    sizes = [locals_[0][k].size for k in names]
    bounds = {}
    for bucket in TC.bucket_assignment([s * 4 for s in sizes],
                                       J.ERNIE_BUFFER_MB):
        flat = [np.concatenate([loc[names[i]].reshape(-1) for i in bucket])
                for loc in locals_]
        m = flat[0].size
        pad = (-m) % (2 * block)
        amax = np.max([np.abs(np.concatenate([f, np.zeros(pad)]))
                       .reshape(-1, block).max(axis=1) for f in flat], axis=0)
        per = np.repeat(amax, block)[:m] * BOUND[kind]
        off = 0
        for i in bucket:
            bounds[names[i]] = per[off:off + sizes[i]].reshape(
                locals_[0][names[i]].shape)
            off += sizes[i]
    return bounds


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_sync_stays_within_the_blockwise_bound(reference, kind):
    out, _, _ = reference
    res = [J.result(out, "ernie_dp", r) for r in (0, 1)]
    plain = _part(res[0], "grad")
    locals_ = [_part(x, "local") for x in res]
    bound = _block_bound(locals_, kind)
    q = [_part(x, kind) for x in res]
    worst = 0.0
    for k in plain:
        np.testing.assert_array_equal(q[0][k], q[1][k])
        err = np.abs(q[0][k] - plain[k])
        assert (err <= bound[k]).all(), (k, float((err - bound[k]).max()))
        worst = max(worst, float(err.max()))
    assert worst > 0.0      # the payload was quantized
