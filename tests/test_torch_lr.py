"""The port's LR schedulers (paddle_tpu_torch.optimizer.lr) against the
JAX package's, on the CPU: each of the thirteen schedulers' ``get_lr_at``
over steps 0-50 (rel 1e-6; the port computes in numpy float32 as the JAX
package does in ``jnp`` float32), ``step()`` / ``get_lr()`` /
``state_dict()``, BERT's ``LinearWarmup`` over ``PolynomialDecay``, and
``ReduceOnPlateau`` on one metric sequence in both packages."""
import math

import numpy as np
import pytest

from paddle_tpu.optimizer import lr as J
from paddle_tpu_torch import convert
from paddle_tpu_torch.optimizer import lr as T

REL = 1e-6
STEPS = range(51)


def _schedulers(mod):
    return {
        "NoamDecay": lambda: mod.NoamDecay(512, 10, learning_rate=2.0),
        "ExponentialDecay": lambda: mod.ExponentialDecay(0.1, 0.93),
        "NaturalExpDecay": lambda: mod.NaturalExpDecay(0.1, 0.07),
        "InverseTimeDecay": lambda: mod.InverseTimeDecay(0.1, 0.3),
        "PolynomialDecay": lambda: mod.PolynomialDecay(0.1, 30, 0.001, 2.0),
        "PolynomialDecayCycle": lambda: mod.PolynomialDecay(
            0.1, 12, 0.001, 1.5, cycle=True),
        "PiecewiseDecay": lambda: mod.PiecewiseDecay([5, 17, 40],
                                                     [0.1, 0.05, 0.01, 1e-3]),
        "CosineAnnealingDecay": lambda: mod.CosineAnnealingDecay(0.1, 37,
                                                                 0.002),
        "LinearWarmup": lambda: mod.LinearWarmup(0.1, 9, 0.001, 0.1),
        "LinearWarmupOverPolynomial": lambda: mod.LinearWarmup(
            mod.PolynomialDecay(1e-4, 40, end_lr=0.0, power=1.0), 10, 0.0,
            1e-4),
        "StepDecay": lambda: mod.StepDecay(0.1, 7, 0.5),
        "MultiStepDecay": lambda: mod.MultiStepDecay(0.1, [3, 11, 29], 0.3),
        "LambdaDecay": lambda: mod.LambdaDecay(0.1, lambda s: 0.95 ** s),
        "ReduceOnPlateau": lambda: mod.ReduceOnPlateau(0.1),
    }


@pytest.mark.parametrize("name", sorted(_schedulers(T)))
def test_get_lr_at_matches_jax(name):
    j, t = _schedulers(J)[name](), _schedulers(T)[name]()
    got = np.array([t.get_lr_at(s) for s in STEPS])
    ref = np.array([float(j.get_lr_at(s)) for s in STEPS])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=REL, atol=0)


@pytest.mark.parametrize("name", sorted(_schedulers(T)))
def test_step_get_lr_and_state_dict(name):
    j, t = _schedulers(J)[name](), _schedulers(T)[name]()
    for _ in range(13):
        j.step()
        t.step()
    assert t.last_epoch == j.last_epoch == 13
    assert math.isclose(t.get_lr(), j.get_lr(), rel_tol=REL)
    t.step(epoch=21)
    j.step(epoch=21)
    assert math.isclose(t.get_lr(), j.get_lr(), rel_tol=REL)
    other = _schedulers(T)[name]()
    other.set_state_dict(convert.scheduler_state_from_jax(j.state_dict()))
    assert other.last_epoch == t.last_epoch == j.last_epoch
    assert math.isclose(other.get_lr(), t.get_lr(), rel_tol=REL)


def test_bert_recipe_warmup_then_linear_decay():
    """Devlin et al. 2019, App. A.2: warm-up over 10000 steps to 1e-4,
    then linear decay to 0 (here over 1000000 steps)."""
    t = T.LinearWarmup(T.PolynomialDecay(1e-4, 1_000_000, end_lr=0.0,
                                         power=1.0), 10_000, 0.0, 1e-4)
    j = J.LinearWarmup(J.PolynomialDecay(1e-4, 1_000_000, end_lr=0.0,
                                         power=1.0), 10_000, 0.0, 1e-4)
    steps = [0, 1, 2, 5000, 9999, 10_000, 10_001, 500_000, 1_009_999,
             1_010_000, 2_000_000]
    got = np.array([t.get_lr_at(s) for s in steps])
    ref = np.array([float(j.get_lr_at(s)) for s in steps])
    np.testing.assert_allclose(got, ref, rtol=REL, atol=0)
    assert got[0] == 0.0 and got[-1] == 0.0
    assert got[5] == np.float32(1e-4)


def test_reduce_on_plateau_follows_a_metric_sequence():
    metrics = [1.0, 0.9, 0.91, 0.92, 0.95, 0.89, 0.9, 0.9, 0.9, 0.9, 0.9,
               0.5, 0.6, 0.7, 0.8, 0.9]
    kw = dict(mode="min", factor=0.5, patience=2, threshold=1e-3,
              cooldown=1, min_lr=0.01)
    j, t = J.ReduceOnPlateau(0.1, **kw), T.ReduceOnPlateau(0.1, **kw)
    got, ref = [], []
    for m in metrics:
        j.step(m)
        t.step(np.float32(m))
        got.append(t.get_lr())
        ref.append(j.get_lr())
    assert got == ref
    assert len(set(got)) > 2
    t.step()
    assert t.get_lr() == got[-1] and t.last_epoch == 1
