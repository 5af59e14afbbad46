"""LR schedulers (counterpart of paddle_tpu/optimizer/lr.py).

Each scheduler computes the LR of an integer step on the host in numpy
float32, the arithmetic of the JAX package's ``jnp`` float32 expressions
(Python numbers there are weakly typed, so they enter as float32 here).
An LR never lives on the card, and reading one never waits for it.
``get_lr_at(step)`` returns an ``np.float32``; the stateful ``step()`` /
``get_lr()`` / ``state_dict()`` mirror the reference's epoch-driven API.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["LRScheduler", "NoamDecay", "ExponentialDecay", "NaturalExpDecay",
           "InverseTimeDecay", "PolynomialDecay", "PiecewiseDecay",
           "CosineAnnealingDecay", "LinearWarmup", "StepDecay",
           "MultiStepDecay", "LambdaDecay", "ReduceOnPlateau"]

f32 = np.float32


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.step()

    def get_lr_at(self, step):
        raise NotImplementedError

    def get_lr(self):
        return self.last_lr

    def step(self, epoch=None):
        self.last_epoch = (self.last_epoch + 1) if epoch is None else epoch
        self.last_lr = float(self.get_lr_at(max(self.last_epoch, 0)))

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, d):
        self.last_epoch = d["last_epoch"]
        self.last_lr = d["last_lr"]


class NoamDecay(LRScheduler):
    """The Transformer schedule: base * d_model^-0.5 * min(step^-0.5,
    step * warmup^-1.5), step floored at 1."""

    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr_at(self, step):
        step = np.maximum(f32(step), f32(1.0))
        a = step ** f32(-0.5)
        b = step * f32(self.warmup_steps ** -1.5)
        return f32(self.base_lr * (self.d_model ** -0.5)) * np.minimum(a, b)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr_at(self, step):
        return f32(self.base_lr) * f32(self.gamma) ** f32(step)


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr_at(self, step):
        return f32(self.base_lr) * np.exp(f32(-self.gamma) * f32(step))


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr_at(self, step):
        return f32(self.base_lr) / (f32(1) + f32(self.gamma) * f32(step))


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr_at(self, step):
        step = f32(step)
        if self.cycle:
            div = np.ceil(np.maximum(step, f32(1.0)) / f32(self.decay_steps))
            decay_steps = f32(self.decay_steps) * div
        else:
            decay_steps = f32(self.decay_steps)
            step = np.minimum(step, decay_steps)
        return (f32(self.base_lr - self.end_lr)
                * (f32(1) - step / decay_steps) ** f32(self.power)
                + f32(self.end_lr))


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr_at(self, step):
        idx = np.searchsorted(np.asarray(self.boundaries, np.float32),
                              f32(step), side="right")
        return np.asarray(self.values, np.float32)[idx]


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr_at(self, step):
        t = np.minimum(f32(step), f32(self.T_max))
        cos = np.cos(f32(math.pi) * t / f32(self.T_max))
        return (f32(self.eta_min)
                + f32((self.base_lr - self.eta_min) * 0.5) * (f32(1) + cos))


class LinearWarmup(LRScheduler):
    """A linear ramp from ``start_lr`` to ``end_lr`` over ``warmup_steps``,
    then ``learning_rate``: a number, or a scheduler taken at ``step -
    warmup_steps``."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.inner = (learning_rate if isinstance(learning_rate, LRScheduler)
                      else None)
        self.peak = (learning_rate if not isinstance(learning_rate,
                                                     LRScheduler) else None)
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(end_lr, last_epoch, verbose)

    def get_lr_at(self, step):
        step = f32(step)
        warm = (f32(self.start_lr) + f32(self.end_lr - self.start_lr)
                * np.minimum(step, f32(self.warmup_steps))
                / f32(self.warmup_steps))
        if self.inner is not None:
            after = f32(self.inner.get_lr_at(
                np.maximum(step - f32(self.warmup_steps), f32(0))))
        else:
            after = f32(self.peak)
        return warm if step < f32(self.warmup_steps) else after


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr_at(self, step):
        k = np.floor(f32(step) / f32(self.step_size))
        return f32(self.base_lr) * f32(self.gamma) ** k


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr_at(self, step):
        k = np.searchsorted(np.asarray(self.milestones, np.float32),
                            f32(step), side="right")
        return f32(self.base_lr) * f32(self.gamma) ** f32(k)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr_at(self, step):
        return f32(self.base_lr * self.lr_lambda(step))


class ReduceOnPlateau(LRScheduler):
    """Metric-driven: ``step(metric)`` multiplies the LR by ``factor`` after
    more than ``patience`` steps without an improvement beyond
    ``threshold``, then waits ``cooldown`` steps; never below ``min_lr``."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, cooldown=0, min_lr=0, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_lr = min_lr
        self._best = None
        self._num_bad = 0
        self._cooldown_counter = 0
        self._current = learning_rate
        super().__init__(learning_rate, -1, verbose)

    def get_lr_at(self, step):
        return f32(self._current)

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            self.last_epoch += 1
            self.last_lr = float(self._current)
            return
        value = float(metrics)
        better = (self._best is None
                  or (self.mode == "min"
                      and value < self._best - self.threshold)
                  or (self.mode == "max"
                      and value > self._best + self.threshold))
        if better:
            self._best = value
            self._num_bad = 0
        elif self._cooldown_counter > 0:
            self._cooldown_counter -= 1
        else:
            self._num_bad += 1
            if self._num_bad > self.patience:
                self._current = max(self._current * self.factor, self.min_lr)
                self._cooldown_counter = self.cooldown
                self._num_bad = 0
        self.last_lr = float(self._current)
