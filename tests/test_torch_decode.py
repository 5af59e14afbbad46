"""Beam search (``nn.gather_tree``, ``nn.BeamSearchDecoder``,
``nn.dynamic_decode``), the port against the JAX package on the CPU over
a GRU cell with the same weights: the backtracked tokens, parents and
lengths equal, the scores at rtol 1e-5 (atol 1e-5), and the loop stops
when every beam has finished."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
from paddle_tpu.autograd import parameters_dict
import paddle_tpu_torch as P
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import convert

V, E, H = 11, 6, 8


@pytest.fixture(autouse=True)
def _cpu():
    with P.device_guard("cpu"):
        yield


def test_gather_tree():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 9, (6, 3, 4)).astype(np.int32)
    parents = rng.integers(0, 4, (6, 3, 4)).astype(np.int32)
    ref = jnn.gather_tree(ids, parents)
    got = tnn.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the last step is the identity; a chain of parents 0 reads beam 0's
    np.testing.assert_array_equal(got[-1].numpy(), ids[-1])


def _decoders(seed, beam, end_token):
    rng = np.random.default_rng(seed)
    emb = rng.normal(0, 1, (V, E)).astype(np.float32)
    w_out = rng.normal(0, 1.5, (H, V)).astype(np.float32)
    jc, tc = jnn.GRUCell(E, H), tnn.GRUCell(E, H)
    convert.from_jax_params({k: np.asarray(v) for k, v in
                             parameters_dict(jc).items()}, tc)
    jd = jnn.BeamSearchDecoder(
        jc, 1, end_token, beam, lambda t: jnp.asarray(emb)[t],
        lambda h: h @ jnp.asarray(w_out), V)
    temb, tw = torch.from_numpy(emb), torch.from_numpy(w_out)
    td = tnn.BeamSearchDecoder(tc, 1, end_token, beam, lambda t: temb[t],
                               lambda h: h @ tw, V)
    init = rng.normal(0, 1, (3, H)).astype(np.float32)
    return jd, td, init


@pytest.mark.parametrize("beam,steps,end_token", [(3, 7, 2), (4, 12, 0),
                                                  (1, 5, 3)])
def test_dynamic_decode(beam, steps, end_token):
    jd, td, init = _decoders(beam, beam, end_token)
    ref, rstate, rlen = jnn.dynamic_decode(jd, jnp.asarray(init), steps,
                                           return_length=True)
    got, gstate, glen = tnn.dynamic_decode(td, torch.from_numpy(init), steps,
                                           return_length=True)
    np.testing.assert_array_equal(got.predicted_ids.numpy(),
                                  np.asarray(ref.predicted_ids))
    np.testing.assert_array_equal(got.parent_ids.numpy(),
                                  np.asarray(ref.parent_ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(glen.numpy(), np.asarray(rlen))
    np.testing.assert_array_equal(gstate.finished.numpy(),
                                  np.asarray(rstate.finished))
    # the best beam's score is the best of the last step
    assert bool((got.scores[-1][:, 0] >= got.scores[-1].max(1).values
                 - 1e-6).all())


def test_decode_stops_when_every_beam_finished():
    jd, td, init = _decoders(9, 2, 5)
    calls = []
    step = td.step

    def counted(tokens, state):
        calls.append(1)
        return step(tokens, state)

    td.step = counted
    # end_token's logit dominates: the best beam ends at the first step,
    # the runner-up (beam 0's second token) at the second
    td.output_fn = lambda h: torch.nn.functional.one_hot(
        torch.full(h.shape[:1], 5), V).float() * 50.0
    out, state = tnn.dynamic_decode(td, torch.from_numpy(init), 6)
    assert len(calls) == 2 and bool(state.finished.all())
    assert bool((out.predicted_ids[1:] == 5).all())
    assert torch.equal(out.scores[2:], out.scores[1:2].expand(4, -1, -1))


def test_vocab_size_is_checked():
    _, td, init = _decoders(1, 2, 0)
    td.vocab_size = V + 1
    with pytest.raises(ValueError, match="vocab_size"):
        tnn.dynamic_decode(td, torch.from_numpy(init), 3)
