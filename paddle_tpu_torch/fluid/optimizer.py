"""Optimizers of the slice (counterpart: `paddle_tpu/fluid/optimizer.py`):
`Optimizer`, `SGDOptimizer` and `AdamOptimizer`.

`minimize = append_backward + apply_gradients`: gradients come from the
backward section (backward.py); each optimizer then appends its update op
per parameter (ops/optimizer_ops.py). The learning rate and the
accumulators (moments, beta powers) are persistable vars that the startup
program fills with `fill_constant`. Gradient clipping and regularization
are not ported yet and raise.
"""
from __future__ import annotations

from typing import Dict

from . import framework
from .backward import append_backward
from .framework import Variable, unique_name
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper, apply_op

__all__ = ["Optimizer", "SGDOptimizer", "AdamOptimizer", "SGD", "Adam"]


def _not_ported(what):
    return NotImplementedError("%s is not ported yet" % what)


class Optimizer:
    def __init__(self, learning_rate, parameter_list=None,
                 regularization=None, grad_clip=None, name=None,
                 parameters=None, weight_decay=None):
        if regularization is not None or weight_decay is not None:
            raise _not_ported("regularization (weight decay)")
        if grad_clip is not None:
            raise _not_ported("gradient clipping")
        self._learning_rate = learning_rate
        # `parameters` is the 2.0-API spelling
        self._parameter_list = parameter_list if parameter_list is not None \
            else parameters
        self._name = name or unique_name(type(self).__name__)
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self._lr_var_per_program = {}

    # -- learning rate -----------------------------------------------------
    def _global_learning_rate(self, program=None):
        program = program or framework.default_main_program()
        if isinstance(self._learning_rate, Variable):
            return self._learning_rate
        key = id(program)
        if key not in self._lr_var_per_program:
            helper = LayerHelper("learning_rate")
            var = helper.create_global_variable(
                name=unique_name("learning_rate"), shape=[1],
                dtype="float32", persistable=True)
            helper.set_variable_initializer(
                var, ConstantInitializer(float(self._learning_rate)))
            self._lr_var_per_program[key] = var
        return self._lr_var_per_program[key]

    def _create_param_lr(self, param_and_grad):
        """The global learning rate, scaled by the param's own
        ParamAttr learning_rate when that is not 1."""
        param = param_and_grad[0]
        base = self._global_learning_rate()
        plr = getattr(param, "optimize_attr", {}).get("learning_rate", 1.0)
        if plr == 1.0:
            return base
        return apply_op("scale", "scale", {"X": [base]},
                        {"scale": float(plr), "bias": 0.0,
                         "bias_after_scale": True}, ["Out"],
                        out_dtype=base.dtype)[0]

    # -- accumulators ------------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        accs = self._accumulators.setdefault(name, {})
        if param.name in accs:
            return accs[param.name]
        helper = LayerHelper(self._name)
        var = helper.create_global_variable(
            name=unique_name("%s_%s_%s" % (self._name, param.name, name)),
            shape=list(shape or param.shape), dtype=dtype or "float32",
            persistable=True)
        helper.set_variable_initializer(var,
                                        ConstantInitializer(fill_value))
        accs[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- core --------------------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list or self._parameter_list,
                               no_grad_set)

    def apply_gradients(self, params_grads):
        params_grads = sorted(params_grads, key=lambda pg: pg[0].name)
        for p, _ in params_grads:
            if getattr(p, "regularizer", None) is not None:
                raise _not_ported("regularization (ParamAttr regularizer)")
            if getattr(p, "gradient_clip_attr", None) is not None:
                raise _not_ported("gradient clipping")
        block = framework.default_main_program().global_block()
        self._create_accumulators(block, [pg[0] for pg in params_grads])
        return [self._append_optimize_op(block, pg) for pg in params_grads]

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="sgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p]})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, shape=[1],
                                  fill_value=self._beta1)
            self._add_accumulator("beta2_pow_acc", p, shape=[1],
                                  fill_value=self._beta2)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            type="adam",
            inputs={"Param": [p], "Grad": [g], "Moment1": [m1],
                    "Moment2": [m2], "Beta1Pow": [b1p], "Beta2Pow": [b2p],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


SGD = SGDOptimizer
Adam = AdamOptimizer
