"""Fluid-analog optimizers: append backward + optimize ops to the Program
(the port of ``paddle_tpu/fluid/optimizer.py``, copied).

Reference analog: python/paddle/v2/framework/optimizer.py (SGD/Momentum/
Adagrad/Adam/Adamax/... each building optimize ops after
append_backward_ops) and the server-side optimizer ops the pserver runs
(ParameterServer2.cpp:362-541).

The optimize ops are ordinary program ops, run by the Executor after the
grad ops.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from paddle_tpu_torch.fluid.backward import append_backward
from paddle_tpu_torch.fluid.framework import (Parameter, Variable,
                                        default_main_program)
from paddle_tpu_torch.platform.enforce import enforce_that


class Optimizer:
    op_type = ""

    def __init__(self, learning_rate: float = 0.01):
        self.learning_rate = float(learning_rate)
        self._lr_var: Optional[Variable] = None

    # -- accumulator helpers ------------------------------------------------

    def _lr(self) -> Variable:
        if self._lr_var is None:
            g = default_main_program().global_block()
            v = g.create_var(
                name=default_main_program().unique_name("learning_rate"),
                shape=(1,), dtype="float32", persistable=True)
            v.initializer = {"type": "constant",
                             "value": self.learning_rate}
            self._lr_var = v
        return self._lr_var

    def _accum(self, param: Parameter, suffix: str, value: float = 0.0,
               shape=None) -> Variable:
        g = default_main_program().global_block()
        v = g.create_var(name=f"{param.name}.{suffix}",
                         shape=shape if shape is not None else param.shape,
                         dtype=param.dtype, persistable=True)
        v.initializer = {"type": "constant", "value": value}
        return v

    # -- per-class hooks ----------------------------------------------------

    def _append_optimize_op(self, block, param: Parameter, grad: Variable):
        raise NotImplementedError

    def _finish(self, block):
        pass

    # -- public -------------------------------------------------------------

    def minimize(self, loss: Variable,
                 parameter_list: Optional[List[str]] = None):
        params_grads = append_backward(loss, parameter_list)
        enforce_that(len(params_grads) > 0, "no trainable parameters reach "
                     "the loss", context="optimizer")
        block = default_main_program().global_block()
        for p, g in params_grads:
            self._append_optimize_op(block, p, g)
        self._finish(block)
        return params_grads


class SGDOptimizer(Optimizer):
    op_type = "sgd"

    def _append_optimize_op(self, block, param, grad):
        block.append_op("sgd", inputs={"Param": param, "Grad": grad,
                                       "LearningRate": self._lr()},
                        outputs={"ParamOut": param})


class MomentumOptimizer(Optimizer):
    op_type = "momentum"

    def __init__(self, learning_rate=0.01, momentum=0.9,
                 use_nesterov=False):
        super().__init__(learning_rate)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _append_optimize_op(self, block, param, grad):
        vel = self._accum(param, "velocity")
        block.append_op("momentum",
                        inputs={"Param": param, "Grad": grad,
                                "Velocity": vel,
                                "LearningRate": self._lr()},
                        outputs={"ParamOut": param, "VelocityOut": vel},
                        attrs={"mu": self.momentum,
                               "use_nesterov": self.use_nesterov})


class AdagradOptimizer(Optimizer):
    op_type = "adagrad"

    def __init__(self, learning_rate=0.01, epsilon=1e-6):
        super().__init__(learning_rate)
        self.epsilon = epsilon

    def _append_optimize_op(self, block, param, grad):
        m = self._accum(param, "moment")
        block.append_op("adagrad",
                        inputs={"Param": param, "Grad": grad, "Moment": m,
                                "LearningRate": self._lr()},
                        outputs={"ParamOut": param, "MomentOut": m},
                        attrs={"epsilon": self.epsilon})


class AdadeltaOptimizer(Optimizer):
    op_type = "adadelta"

    def __init__(self, learning_rate=1.0, rho=0.95, epsilon=1e-6):
        super().__init__(learning_rate)
        self.rho, self.epsilon = rho, epsilon

    def _append_optimize_op(self, block, param, grad):
        ag = self._accum(param, "avg_squared_grad")
        au = self._accum(param, "avg_squared_update")
        block.append_op(
            "adadelta",
            inputs={"Param": param, "Grad": grad, "AvgSquaredGrad": ag,
                    "AvgSquaredUpdate": au, "LearningRate": self._lr()},
            outputs={"ParamOut": param, "AvgSquaredGradOut": ag,
                     "AvgSquaredUpdateOut": au},
            attrs={"rho": self.rho, "epsilon": self.epsilon})


class RMSPropOptimizer(Optimizer):
    op_type = "rmsprop"

    def __init__(self, learning_rate=0.01, decay=0.9, momentum=0.0,
                 epsilon=1e-6):
        super().__init__(learning_rate)
        self.decay, self.momentum, self.epsilon = decay, momentum, epsilon

    def _append_optimize_op(self, block, param, grad):
        ms = self._accum(param, "mean_square")
        mom = self._accum(param, "moment")
        block.append_op(
            "rmsprop",
            inputs={"Param": param, "Grad": grad, "MeanSquare": ms,
                    "Moment": mom, "LearningRate": self._lr()},
            outputs={"ParamOut": param, "MeanSquareOut": ms,
                     "MomentOut": mom},
            attrs={"decay": self.decay, "momentum": self.momentum,
                   "epsilon": self.epsilon})


class DecayedAdagradOptimizer(Optimizer):
    op_type = "decayed_adagrad"

    def __init__(self, learning_rate=0.01, decay=0.95, epsilon=1e-6):
        super().__init__(learning_rate)
        self.decay, self.epsilon = decay, epsilon

    def _append_optimize_op(self, block, param, grad):
        m = self._accum(param, "moment")
        block.append_op(
            "decayed_adagrad",
            inputs={"Param": param, "Grad": grad, "Moment": m,
                    "LearningRate": self._lr()},
            outputs={"ParamOut": param, "MomentOut": m},
            attrs={"decay": self.decay, "epsilon": self.epsilon})


class AdamOptimizer(Optimizer):
    op_type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        super().__init__(learning_rate)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self._b1p: Optional[Variable] = None
        self._b2p: Optional[Variable] = None

    def _pows(self):
        if self._b1p is None:
            g = default_main_program().global_block()
            prog = default_main_program()
            self._b1p = g.create_var(name=prog.unique_name("beta1_pow"),
                                     shape=(1,), dtype="float32",
                                     persistable=True)
            self._b1p.initializer = {"type": "constant", "value": 1.0}
            self._b2p = g.create_var(name=prog.unique_name("beta2_pow"),
                                     shape=(1,), dtype="float32",
                                     persistable=True)
            self._b2p.initializer = {"type": "constant", "value": 1.0}
        return self._b1p, self._b2p

    def _append_optimize_op(self, block, param, grad):
        m1 = self._accum(param, "moment1")
        m2 = self._accum(param, "moment2")
        b1p, b2p = self._pows()
        block.append_op(
            "adam",
            inputs={"Param": param, "Grad": grad, "Moment1": m1,
                    "Moment2": m2, "Beta1Pow": b1p, "Beta2Pow": b2p,
                    "LearningRate": self._lr()},
            outputs={"ParamOut": param, "Moment1Out": m1,
                     "Moment2Out": m2},
            attrs={"beta1": self.beta1, "beta2": self.beta2,
                   "epsilon": self.epsilon})

    def _finish(self, block):
        b1p, b2p = self._pows()
        block.append_op("beta_pow_update",
                        inputs={"Beta1Pow": b1p, "Beta2Pow": b2p},
                        outputs={"Beta1PowOut": b1p, "Beta2PowOut": b2p},
                        attrs={"beta1": self.beta1, "beta2": self.beta2})


class AdamaxOptimizer(Optimizer):
    op_type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        super().__init__(learning_rate)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self._b1p: Optional[Variable] = None

    def _pow(self):
        if self._b1p is None:
            prog = default_main_program()
            g = prog.global_block()
            self._b1p = g.create_var(name=prog.unique_name("beta1_pow"),
                                     shape=(1,), dtype="float32",
                                     persistable=True)
            self._b1p.initializer = {"type": "constant", "value": 1.0}
        return self._b1p

    def _append_optimize_op(self, block, param, grad):
        m = self._accum(param, "moment")
        inf = self._accum(param, "inf_norm")
        block.append_op(
            "adamax",
            inputs={"Param": param, "Grad": grad, "Moment": m,
                    "InfNorm": inf, "Beta1Pow": self._pow(),
                    "LearningRate": self._lr()},
            outputs={"ParamOut": param, "MomentOut": m, "InfNormOut": inf},
            attrs={"beta1": self.beta1, "beta2": self.beta2,
                   "epsilon": self.epsilon})

    def _finish(self, block):
        block.append_op("beta_pow_update",
                        inputs={"Beta1Pow": self._pow()},
                        outputs={"Beta1PowOut": self._pow()},
                        attrs={"beta1": self.beta1})


class ProximalGDOptimizer(Optimizer):
    op_type = "proximal_gd"

    def __init__(self, learning_rate=0.01, l1=0.0, l2=0.0):
        super().__init__(learning_rate)
        self.l1, self.l2 = l1, l2

    def _append_optimize_op(self, block, param, grad):
        block.append_op("proximal_gd",
                        inputs={"Param": param, "Grad": grad,
                                "LearningRate": self._lr()},
                        outputs={"ParamOut": param},
                        attrs={"l1": self.l1, "l2": self.l2})
