"""Static-graph optimizers: append update ops to the program
(counterpart of paddle_tpu/static/optimizer.py, pure Python, copied).

Reference parity: python/paddle/fluid/optimizer.py ``Optimizer`` (:56):
``minimize`` = append_backward + ``_create_optimization_pass`` emitting one
fused update op per parameter (operators/optimizers/), with slot
("accumulator") variables created as persistables.  The learning-rate
variable and the slot names are the JAX package's, so a scope carries
across (``convert.static_state_from_jax``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..nn import initializer as I
from .backward import append_backward
from .framework import (
    Parameter,
    Variable,
    default_main_program,
    unique_name,
)
from .layers import create_parameter

__all__ = ["SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer",
           "Adam", "AdamOptimizer"]


class _StaticOptimizer:
    def __init__(self, learning_rate: float):
        self._lr_value = float(learning_rate)
        self._lr_var: Optional[Variable] = None

    def _lr(self) -> Variable:
        if self._lr_var is None or \
                not default_main_program().global_block().has_var(self._lr_var.name):
            self._lr_var = create_parameter(
                (), "float32", name=unique_name("learning_rate"),
                default_initializer=I.Constant(self._lr_value),
                trainable=False)
        return self._lr_var

    def _slot(self, param: Parameter, suffix: str, init=0.0, shape=None):
        return create_parameter(
            shape if shape is not None else param.shape, "float32",
            name=f"{param.name}_{suffix}",
            default_initializer=I.Constant(init), trainable=False)

    def minimize(self, loss: Variable, parameter_list=None
                 ) -> Tuple[None, List[Tuple[Parameter, Variable]]]:
        p_g = append_backward(loss, parameter_list)
        self.apply_gradients(p_g)
        return None, p_g

    def apply_gradients(self, params_grads):
        block = default_main_program().global_block()
        lr = self._lr()
        for p, g in params_grads:
            self._append_update(block, p, g, lr)

    def _append_update(self, block, p, g, lr):
        raise NotImplementedError


class SGD(_StaticOptimizer):
    """ref fluid/optimizer.py:947 SGDOptimizer → sgd op."""

    def _append_update(self, block, p, g, lr):
        block.append_op("sgd",
                        {"Param": [p.name], "Grad": [g.name],
                         "LearningRate": [lr.name]},
                        {"ParamOut": [p.name]})


class Momentum(_StaticOptimizer):
    """ref fluid/optimizer.py MomentumOptimizer → momentum op."""

    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False):
        super().__init__(learning_rate)
        self.mu = momentum
        self.use_nesterov = use_nesterov

    def _append_update(self, block, p, g, lr):
        vel = self._slot(p, "velocity")
        block.append_op("momentum",
                        {"Param": [p.name], "Grad": [g.name],
                         "Velocity": [vel.name], "LearningRate": [lr.name]},
                        {"ParamOut": [p.name], "VelocityOut": [vel.name]},
                        {"mu": self.mu, "use_nesterov": self.use_nesterov})


class Adam(_StaticOptimizer):
    """ref fluid/optimizer.py:1821 AdamOptimizer → adam op (dense path)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        super().__init__(learning_rate)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _append_adam_like(self, block, p, g, lr, op_type, extra_attrs=None):
        """Shared wiring for the adam-family ops (adam/adamw/lamb): same
        moment1/moment2/beta-pow slots and IO contract, different op name
        plus op-specific attrs."""
        m1 = self._slot(p, "moment1")
        m2 = self._slot(p, "moment2")
        b1p = self._slot(p, "beta1_pow", init=1.0, shape=())
        b2p = self._slot(p, "beta2_pow", init=1.0, shape=())
        block.append_op(
            op_type,
            {"Param": [p.name], "Grad": [g.name], "Moment1": [m1.name],
             "Moment2": [m2.name], "LearningRate": [lr.name],
             "Beta1Pow": [b1p.name], "Beta2Pow": [b2p.name]},
            {"ParamOut": [p.name], "Moment1Out": [m1.name],
             "Moment2Out": [m2.name], "Beta1PowOut": [b1p.name],
             "Beta2PowOut": [b2p.name]},
            {"beta1": self.beta1, "beta2": self.beta2,
             "epsilon": self.epsilon, **(extra_attrs or {})})

    def _append_update(self, block, p, g, lr):
        self._append_adam_like(block, p, g, lr, "adam")


SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdamOptimizer = Adam


class AdamW(Adam):
    """ref paddle AdamW — adamw op (decoupled decay attr ``coeff``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.01):
        super().__init__(learning_rate, beta1, beta2, epsilon)
        self.coeff = weight_decay

    def _append_update(self, block, p, g, lr):
        self._append_adam_like(block, p, g, lr, "adamw",
                               {"coeff": self.coeff})


class Adagrad(_StaticOptimizer):
    """ref fluid/optimizer.py AdagradOptimizer → adagrad op."""

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate)
        self.epsilon = epsilon
        self.init_acc = initial_accumulator_value

    def _append_update(self, block, p, g, lr):
        acc = self._slot(p, "moment", init=self.init_acc)
        block.append_op(
            "adagrad",
            {"Param": [p.name], "Grad": [g.name], "Moment": [acc.name],
             "LearningRate": [lr.name]},
            {"ParamOut": [p.name], "MomentOut": [acc.name]},
            {"epsilon": self.epsilon})


class Adadelta(_StaticOptimizer):
    """ref fluid/optimizer.py AdadeltaOptimizer → adadelta op."""

    def __init__(self, learning_rate=1.0, epsilon=1e-6, rho=0.95):
        super().__init__(learning_rate)
        self.epsilon, self.rho = epsilon, rho

    def _append_update(self, block, p, g, lr):
        ag = self._slot(p, "avg_squared_grad")
        au = self._slot(p, "avg_squared_update")
        block.append_op(
            "adadelta",
            {"Param": [p.name], "Grad": [g.name],
             "AvgSquaredGrad": [ag.name], "AvgSquaredUpdate": [au.name]},
            {"ParamOut": [p.name], "AvgSquaredGradOut": [ag.name],
             "AvgSquaredUpdateOut": [au.name]},
            {"epsilon": self.epsilon, "rho": self.rho})


class RMSProp(_StaticOptimizer):
    """ref fluid/optimizer.py RMSPropOptimizer → rmsprop op."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False):
        super().__init__(learning_rate)
        self.rho, self.epsilon = rho, epsilon
        self.momentum, self.centered = momentum, centered

    def _append_update(self, block, p, g, lr):
        ms = self._slot(p, "mean_square")
        mg = self._slot(p, "mean_grad")
        mom = self._slot(p, "momentum_acc")
        block.append_op(
            "rmsprop",
            {"Param": [p.name], "Grad": [g.name], "MeanSquare": [ms.name],
             "MeanGrad": [mg.name], "Moment": [mom.name],
             "LearningRate": [lr.name]},
            {"ParamOut": [p.name], "MeanSquareOut": [ms.name],
             "MeanGradOut": [mg.name], "MomentOut": [mom.name]},
            {"decay": self.rho, "epsilon": self.epsilon,
             "momentum": self.momentum, "centered": self.centered})


class Lamb(_StaticOptimizer):
    """ref fluid/optimizer.py:2930 LambOptimizer → lamb op."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6):
        super().__init__(learning_rate)
        self.wd = lamb_weight_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _append_update(self, block, p, g, lr):
        Adam._append_adam_like(self, block, p, g, lr, "lamb",
                               {"weight_decay": self.wd})


class Ftrl(_StaticOptimizer):
    """ref fluid/optimizer.py FtrlOptimizer → ftrl op."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5):
        super().__init__(learning_rate)
        self.l1, self.l2, self.lr_power = l1, l2, lr_power

    def _append_update(self, block, p, g, lr):
        sq = self._slot(p, "squared_acc")
        lin = self._slot(p, "linear_acc")
        block.append_op(
            "ftrl",
            {"Param": [p.name], "Grad": [g.name],
             "SquaredAccumulator": [sq.name],
             "LinearAccumulator": [lin.name], "LearningRate": [lr.name]},
            {"ParamOut": [p.name], "SquaredAccumOut": [sq.name],
             "LinearAccumOut": [lin.name]},
            {"l1": self.l1, "l2": self.l2, "lr_power": self.lr_power})


class LarsMomentum(_StaticOptimizer):
    """ref fluid/optimizer.py:1591 LarsMomentumOptimizer → lars_momentum."""

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005):
        super().__init__(learning_rate)
        self.mu = momentum
        self.lars_coeff = lars_coeff
        self.lars_weight_decay = lars_weight_decay

    def _append_update(self, block, p, g, lr):
        vel = self._slot(p, "velocity")
        block.append_op(
            "lars_momentum",
            {"Param": [p.name], "Grad": [g.name], "Velocity": [vel.name],
             "LearningRate": [lr.name]},
            {"ParamOut": [p.name], "VelocityOut": [vel.name]},
            {"mu": self.mu, "lars_coeff": self.lars_coeff,
             "lars_weight_decay": self.lars_weight_decay})


class Dpsgd(_StaticOptimizer):
    """ref fluid/optimizer.py DpsgdOptimizer → dpsgd op."""

    def __init__(self, learning_rate, clip=10.0, batch_size=16.0,
                 sigma=1.0):
        super().__init__(learning_rate)
        self.clip, self.batch_size, self.sigma = clip, batch_size, sigma

    def _append_update(self, block, p, g, lr):
        block.append_op(
            "dpsgd",
            {"Param": [p.name], "Grad": [g.name],
             "LearningRate": [lr.name]},
            {"ParamOut": [p.name]},
            {"clip": self.clip, "batch_size": self.batch_size,
             "sigma": self.sigma})


__all__ += ["AdamW", "AdamWOptimizer", "Adagrad", "AdagradOptimizer",
            "Adadelta", "AdadeltaOptimizer", "RMSProp", "RMSPropOptimizer",
            "Lamb", "LambOptimizer", "Ftrl", "FtrlOptimizer",
            "LarsMomentum", "LarsMomentumOptimizer", "Dpsgd",
            "DpsgdOptimizer"]
AdamWOptimizer = AdamW
AdagradOptimizer = Adagrad
AdadeltaOptimizer = Adadelta
RMSPropOptimizer = RMSProp
LambOptimizer = Lamb
FtrlOptimizer = Ftrl
LarsMomentumOptimizer = LarsMomentum
DpsgdOptimizer = Dpsgd
