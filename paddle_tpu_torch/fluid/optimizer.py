"""Optimizers (counterpart: `paddle_tpu/fluid/optimizer.py:37-718`):
`Optimizer`, `SGDOptimizer`, `MomentumOptimizer`,
`LarsMomentumOptimizer`, `AdamOptimizer`, `AdamWOptimizer`,
`LambOptimizer`, `AdamaxOptimizer`, `AdagradOptimizer`,
`DecayedAdagradOptimizer`, `AdadeltaOptimizer`, `RMSPropOptimizer`,
`FtrlOptimizer` and `DpsgdOptimizer`, with their 2.0-style aliases.

`minimize = append_backward + apply_gradients`: gradients come from the
backward section (backward.py); gradient clipping (`grad_clip`, else
`clip.set_gradient_clip`'s default or a param's `gradient_clip_attr`;
clip.py) rewrites them, then weight decay (`regularization`, or a
ParamAttr's `regularizer`; regularizer.py) adds its term; each optimizer
then appends its update op per parameter (ops/optimizer_ops.py) and any
op it needs once the updates are in (`_finish_update`: Adamax's beta
power). The learning rate and the accumulators (velocities, moments,
beta powers) are persistable vars that the startup program fills with
`fill_constant`. DGC, ModelAverage, EMA, Recompute, Lookahead, gradient
merge and Pipeline (`optimizer.py:719-1230` of the reference) are not
ported yet.
"""
from __future__ import annotations

from typing import Dict

from . import framework
from .backward import append_backward
from .clip import append_gradient_clip_ops
from .framework import Variable, unique_name
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper, apply_op
from .regularizer import L2Decay, append_regularization_ops

__all__ = ["Optimizer", "SGDOptimizer", "MomentumOptimizer",
           "LarsMomentumOptimizer", "AdamOptimizer", "AdamWOptimizer",
           "LambOptimizer", "AdamaxOptimizer", "AdagradOptimizer",
           "DecayedAdagradOptimizer", "AdadeltaOptimizer",
           "RMSPropOptimizer", "FtrlOptimizer", "DpsgdOptimizer",
           "SGD", "Momentum", "Adam", "AdamW", "Lamb", "LarsMomentum",
           "Adamax", "Adagrad", "DecayedAdagrad", "Adadelta", "RMSProp",
           "Ftrl", "Dpsgd"]


class Optimizer:
    def __init__(self, learning_rate, parameter_list=None,
                 regularization=None, grad_clip=None, name=None,
                 parameters=None, weight_decay=None):
        if regularization is None and weight_decay is not None:
            # `weight_decay` is the 2.0-API spelling: a regularizer, or a
            # float meaning L2Decay of that coefficient
            regularization = weight_decay if not isinstance(
                weight_decay, (int, float)) else L2Decay(float(weight_decay))
        self.regularization = regularization
        self._grad_clip = grad_clip
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

    def _finish_update(self, block, params_grads):
        pass

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list or self._parameter_list,
                               no_grad_set)

    def apply_gradients(self, params_grads):
        params_grads = sorted(params_grads, key=lambda pg: pg[0].name)
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        else:
            params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        block = framework.default_main_program().global_block()
        self._create_accumulators(block, [pg[0] for pg in params_grads])
        ops = [self._append_optimize_op(block, pg) for pg in params_grads]
        self._finish_update(block, params_grads)
        return ops

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


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            type="momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum,
                   "use_nesterov": self._use_nesterov})


class LarsMomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, epsilon=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            type="lars_momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay,
                   "epsilon": self._epsilon})


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
            type=self._op_type(),
            inputs={"Param": [p], "Grad": [g], "Moment1": [m1],
                    "Moment2": [m2], "Beta1Pow": [b1p], "Beta2Pow": [b2p],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs=self._op_attrs(p))

    def _op_type(self):
        return "adam"

    def _op_attrs(self, p):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon}


class AdamWOptimizer(AdamOptimizer):
    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._coeff = weight_decay

    def _op_type(self):
        return "adamw"

    def _op_attrs(self, p):
        return dict(super()._op_attrs(p), coeff=self._coeff)


class LambOptimizer(AdamOptimizer):
    """LAMB: Adam's moments with a layer-wise trust ratio; the params
    `exclude_from_weight_decay_fn` accepts take no weight decay."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kwargs):
        super().__init__(learning_rate, beta1=beta1, beta2=beta2,
                         epsilon=epsilon, **kwargs)
        self._weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _op_type(self):
        return "lamb"

    def _op_attrs(self, p):
        wd = self._weight_decay
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        return dict(super()._op_attrs(p), weight_decay=wd)


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, shape=[1],
                                  fill_value=self._beta1)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="adamax",
            inputs={"Param": [p], "Grad": [g],
                    "Moment": [self._get_accumulator("moment", p)],
                    "InfNorm": [self._get_accumulator("inf_norm", p)],
                    "Beta1Pow": [self._get_accumulator("beta1_pow_acc", p)],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p],
                     "MomentOut": [self._get_accumulator("moment", p)],
                     "InfNormOut": [self._get_accumulator("inf_norm", p)]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self, block, params_grads):
        """The beta1 power advances after every update (a `scale` op a
        parameter), as the reference's Adamax does."""
        for p, _ in params_grads:
            b1p = self._get_accumulator("beta1_pow_acc", p)
            block.append_op(
                type="scale", inputs={"X": [b1p]}, outputs={"Out": [b1p]},
                attrs={"scale": self._beta1, "bias": 0.0,
                       "bias_after_scale": True})


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            type=self._op_type(),
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "MomentOut": [m]},
            attrs=self._op_attrs())

    def _op_type(self):
        return "adagrad"

    def _op_attrs(self):
        return {"epsilon": self._epsilon}


class DecayedAdagradOptimizer(AdagradOptimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, epsilon=epsilon, **kwargs)
        self._decay = decay

    def _op_type(self):
        return "decayed_adagrad"

    def _op_attrs(self):
        return {"decay": self._decay, "epsilon": self._epsilon}


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        asg = self._get_accumulator("avg_squared_grad", p)
        asu = self._get_accumulator("avg_squared_update", p)
        return block.append_op(
            type="adadelta",
            inputs={"Param": [p], "Grad": [g], "AvgSquaredGrad": [asg],
                    "AvgSquaredUpdate": [asu]},
            outputs={"ParamOut": [p], "AvgSquaredGradOut": [asg],
                     "AvgSquaredUpdateOut": [asu]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("momentum_acc", p)
            if self._centered:
                self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        ms = self._get_accumulator("mean_square", p)
        mom = self._get_accumulator("momentum_acc", p)
        ins = {"Param": [p], "Grad": [g], "MeanSquare": [ms],
               "Moment": [mom],
               "LearningRate": [self._create_param_lr(param_and_grad)]}
        outs = {"ParamOut": [p], "MeanSquareOut": [ms], "MomentOut": [mom]}
        if self._centered:
            mg = self._get_accumulator("mean_grad", p)
            ins["MeanGrad"] = [mg]
            outs["MeanGradOut"] = [mg]
        return block.append_op(
            type="rmsprop", inputs=ins, outputs=outs,
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            type="ftrl",
            inputs={"Param": [p], "Grad": [g], "SquaredAccumulator": [sq],
                    "LinearAccumulator": [lin],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


class DpsgdOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16.0,
                 sigma=1.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._clip, self._batch_size, self._sigma = clip, batch_size, sigma

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="dpsgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p]},
            attrs={"clip": self._clip, "batch_size": self._batch_size,
                   "sigma": self._sigma})


# paddle 2.0-style aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adamax = AdamaxOptimizer
Adagrad = AdagradOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
Dpsgd = DpsgdOptimizer
