"""The long-tail optimizers and parameter averages (counterpart of
paddle_tpu/optimizer/extras.py; ref fluid/optimizer.py): ``Ftrl``
(ftrl_op.h), ``Dpsgd`` (dpsgd_op.cc), ``dgc_compress`` and
``DGCMomentum`` (dgc_op.cc: top-k sparsified, momentum-corrected
gradients with error feedback), ``ExponentialMovingAverage``,
``ModelAverage`` and ``Lookahead``.

The updates are in place under ``torch.no_grad``, as the port's other
optimizers; slots are dicts under the JAX package's keys, so
``convert.optimizer_state_from_jax`` maps them by name.  DGC compresses
the gradient that would ride an all-reduce; it is exposed as a transform
the caller applies, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .optimizer import Optimizer
from .optimizers import _cast_scalar

__all__ = ["Ftrl", "Dpsgd", "DGCMomentum", "dgc_compress",
           "ExponentialMovingAverage", "ModelAverage", "Lookahead"]


def _tree_map(fn, *trees):
    """``fn`` over the tensors of nested dicts / lists / tuples."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *sub) for sub in zip(*trees))
    return fn(*trees)


def _copy(t):
    return torch.as_tensor(t).detach().clone()


class Ftrl(Optimizer):
    """Follow the regularized leader (ref operators/optimizers/ftrl_op.h):
    slots ``squared`` (the running sum of g^2) and ``linear``."""

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self.l1, self.l2, self.lr_power = l1, l2, lr_power

    def init_param_state(self, p):
        return {"squared": torch.zeros_like(p), "linear": torch.zeros_like(p)}

    def apply_updates(self, grads, params, slots, lr, step):
        for p, g, s in zip(params, grads, slots):
            lr_p = _cast_scalar(lr, p.dtype)
            sq, lin = s["squared"], s["linear"]
            sq_new = sq + g * g
            pow_new = sq_new ** (-self.lr_power)
            pow_old = torch.where(sq > 0, sq ** (-self.lr_power),
                                  torch.zeros_like(sq))
            lin_new = lin + g - (pow_new - pow_old) / lr_p * p
            quad = pow_new / lr_p + 2 * self.l2
            pre = torch.clamp(lin_new, -self.l1, self.l1) - lin_new
            p.copy_(torch.where(lin_new.abs() > self.l1, pre / quad,
                                torch.zeros_like(p)))
            sq.copy_(sq_new)
            lin.copy_(lin_new)


class Dpsgd(Optimizer):
    """Differentially private SGD (ref dpsgd_op.cc): each gradient clipped
    to norm ``clip``, then Gaussian noise of std sigma clip / batch_size
    added.  The noise comes from a generator on the parameter's device
    seeded by (seed, step, the parameter's place in the list), so one seed
    repeats its draws; it cannot match the JAX package's ``jax.random``
    draws, which fold in the parameter's size and so give two parameters
    of one size the same noise (ROADMAP.md Queue 3).  At sigma 0 no noise
    is drawn (adding the zeros the JAX package adds changes no bit)."""

    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16,
                 sigma=1.0, parameters=None, seed: int = 0, name=None):
        super().__init__(learning_rate, parameters, None, None, name)
        self.clip = clip
        self.batch_size = batch_size
        self.sigma = sigma
        self.seed = seed

    def init_param_state(self, p):
        return None

    def apply_updates(self, grads, params, slots, lr, step):
        for i, (p, g) in enumerate(zip(params, grads)):
            norm = torch.sqrt(torch.sum(g * g))
            g = g * torch.clamp(self.clip / torch.clamp(norm, min=1e-12),
                                max=1.0)
            if self.sigma:
                gen = torch.Generator(device=p.device).manual_seed(
                    (int(self.seed) * 1_000_003 + int(step)) * 1_000_033 + i)
                g = g + torch.randn(g.shape, generator=gen, dtype=g.dtype,
                                    device=g.device) * (
                    self.sigma * self.clip / self.batch_size)
            p.copy_(p - _cast_scalar(lr, p.dtype) * g)


def dgc_compress(grad, velocity, error, sparsity: float,
                 momentum: float = 0.9):
    """Deep gradient compression (ref dgc_op.cc:23): momentum correction,
    error feedback and top-k sparsification.  Returns (sparse_grad,
    new_velocity, new_error): ``sparse_grad`` keeps the entries whose
    magnitude reaches the k-th largest (k = n (1 - sparsity), at least 1)
    and is what rides the all-reduce; the rest accumulates in ``error``;
    the velocity of what was sent resets to 0."""
    v_new = momentum * velocity + grad
    acc = v_new + error
    flat = acc.abs().reshape(-1)
    k = max(1, int(flat.shape[0] * (1.0 - sparsity)))
    thresh = torch.topk(flat, k).values[-1]
    mask = acc.abs() >= thresh
    sparse = torch.where(mask, acc, torch.zeros_like(acc))
    return sparse, torch.where(mask, torch.zeros_like(v_new), v_new), \
        acc - sparse


class DGCMomentum(Optimizer):
    """Momentum with DGC (ref fluid/optimizer.py:1176): from step
    ``rampup_begin_step`` (1-based, as the JAX package's step) the update
    is the DGC-compressed gradient, whose own velocity carries the
    momentum; before it, plain (or Nesterov) momentum.  Slots
    ``velocity``, ``dgc_velocity`` and ``error``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 sparsity=0.999, rampup_begin_step=0, use_nesterov=False,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self.momentum = momentum
        self.sparsity = sparsity
        self.rampup_begin_step = rampup_begin_step
        self.use_nesterov = use_nesterov

    def init_param_state(self, p):
        return {"velocity": torch.zeros_like(p),
                "dgc_velocity": torch.zeros_like(p),
                "error": torch.zeros_like(p)}

    def apply_updates(self, grads, params, slots, lr, step):
        dgc = self.rampup_begin_step <= 0 or step >= self.rampup_begin_step
        for p, g, s in zip(params, grads, slots):
            lr_p = _cast_scalar(lr, p.dtype)
            if dgc:
                sparse, v, err = dgc_compress(g, s["dgc_velocity"],
                                              s["error"], self.sparsity,
                                              self.momentum)
                p.copy_(p - lr_p * sparse)
                s["dgc_velocity"].copy_(v)
                s["error"].copy_(err)
            else:
                v = self.momentum * s["velocity"] + g
                p.copy_(p - lr_p * (g + self.momentum * v)
                        if self.use_nesterov else p - lr_p * v)
                s["velocity"].copy_(v)


class ExponentialMovingAverage:
    """An EMA of parameters (ref fluid/optimizer.py:3411): ``update(params)``
    after each step (params a dict, list or tuple of tensors, the shadow
    copied from them on the first call); ``apply()`` returns the shadow
    weights, to evaluate with.  With ``thres_steps`` the decay warms up as
    min(decay, (1 + t) / (10 + t))."""

    def __init__(self, decay: float = 0.999, thres_steps: bool = True):
        self.decay = decay
        self.thres_steps = thres_steps
        self._shadow = None
        self._step = 0

    @torch.no_grad()
    def update(self, params):
        self._step += 1
        d = self.decay
        if self.thres_steps:
            d = min(self.decay, (1 + self._step) / (10 + self._step))
        if self._shadow is None:
            self._shadow = _tree_map(_copy, params)
        else:
            self._shadow = _tree_map(lambda s, p: d * s + (1 - d) * p,
                                     self._shadow, params)
        return self._shadow

    def apply(self, params=None):
        if self._shadow is None:
            raise RuntimeError("EMA has no state; call update() first")
        return self._shadow

    def state_dict(self):
        return {"shadow": self._shadow, "step": self._step}

    def set_state_dict(self, sd):
        self._shadow = sd["shadow"]
        self._step = sd["step"]


class ModelAverage(ExponentialMovingAverage):
    """The uniform average of the last ``max_average_window`` parameter
    updates (ref fluid/optimizer.py:3102), as a running mean."""

    def __init__(self, average_window_rate: float = 0.15,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000):
        super().__init__(decay=0.0, thres_steps=False)
        self.max_average_window = max_average_window

    @torch.no_grad()
    def update(self, params):
        self._step += 1
        n = min(self._step, self.max_average_window)
        if self._shadow is None:
            self._shadow = _tree_map(_copy, params)
        else:
            self._shadow = _tree_map(lambda s, p: s + (p - s) / n,
                                     self._shadow, params)
        return self._shadow


class Lookahead:
    """Lookahead (ref fluid/optimizer.py:4822): every ``k`` steps of the
    inner optimizer the slow weights move ``alpha`` toward the fast ones
    and the fast ones are reset to them.  The functional pair
    ``init`` / ``update`` is the JAX package's; the port adds the eager
    facade (``step``, ``minimize``, ``clear_grad``) over the inner
    optimizer's bound parameters.  Both keep one state layout,
    ``{"inner", "slow", "step"}`` with the slow weights by name; the eager
    facade names the bound parameters by position ("0", "1", ...), as the
    inner optimizer's own facade does."""

    def __init__(self, inner: Optimizer, alpha: float = 0.5, k: int = 5):
        self.inner = inner
        self.alpha = alpha
        self.k = k
        self._slow = None
        self._step = 0

    def init(self, params):
        return {"inner": self.inner.init(params),
                "slow": _tree_map(_copy, params), "step": 0}

    def _merge(self, params, slow, step):
        """The slow/fast merge of a step (every ``k``-th); returns it."""
        if step % self.k == 0:
            for name, fast in params.items():
                s = slow[name]
                s.copy_(s + self.alpha * (fast - s))
                fast.copy_(s)
        return step

    @torch.no_grad()
    def update(self, grads, state, params, lr=None):
        params, inner_state = self.inner.update(grads, state["inner"],
                                                params, lr)
        state.update(inner=inner_state,
                     step=self._merge(params, state["slow"],
                                      state["step"] + 1))
        return params, state

    def get_lr(self, step=None):
        return self.inner.get_lr(step)

    # -- eager facade ----------------------------------------------------------
    def _bound(self):
        return {str(i): p for i, p in enumerate(self.inner._param_list())}

    @torch.no_grad()
    def step(self, grads=None):
        params = self._bound()
        if self._slow is None:
            self._slow = _tree_map(_copy, params)
        self.inner.step(grads)
        self._step = self._merge(params, self._slow, self._step + 1)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        del loss, startup_program, parameters, no_grad_set
        self.step(None)
        return [], []

    def clear_grad(self):
        self.inner.clear_grad()

    clear_gradients = clear_grad

    def state_dict(self) -> Dict[str, Any]:
        """The functional layout over the bound parameters' positions."""
        return {"inner": self.inner.state_dict()["state"],
                "slow": self._slow, "step": self._step}

    def set_state_dict(self, state):
        """Load the functional layout: this facade's ``state_dict()``, or
        ``convert.optimizer_state_from_jax(jax_state, params)`` with
        ``params`` ({name: tensor}) in the bound parameters' order.  Names
        are matched by position, each slow weight's shape checked."""
        bound = self._bound()

        def by_position(named, what):
            if len(named) != len(bound):
                raise ValueError(f"Lookahead.set_state_dict: {len(named)} "
                                 f"{what}, {len(bound)} bound parameters")
            return dict(zip(bound, named.values()))

        slow = by_position(state["slow"], "slow weights")
        for name, p in bound.items():
            if tuple(slow[name].shape) != tuple(p.shape):
                raise ValueError(f"Lookahead.set_state_dict: the slow "
                                 f"weight of parameter {name} has shape "
                                 f"{tuple(slow[name].shape)}, the "
                                 f"parameter {tuple(p.shape)}")
        inner = dict(state["inner"], per_param=by_position(
            state["inner"]["per_param"], "inner slots"))
        self.inner.set_state_dict({"state": inner, "step": inner["step"]})
        self._slow = {n: t.to(bound[n].device) for n, t in slow.items()}
        self._step = int(state["step"])
