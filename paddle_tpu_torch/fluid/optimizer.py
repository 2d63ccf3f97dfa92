"""Optimizers (counterpart: `paddle_tpu/fluid/optimizer.py`):
`Optimizer`, `SGDOptimizer`, `MomentumOptimizer`,
`LarsMomentumOptimizer`, `AdamOptimizer`, `AdamWOptimizer`,
`LambOptimizer`, `AdamaxOptimizer`, `AdagradOptimizer`,
`DecayedAdagradOptimizer`, `AdadeltaOptimizer`, `RMSPropOptimizer`,
`FtrlOptimizer` and `DpsgdOptimizer`, with their 2.0-style aliases; and
the wrappers and extras of the reference's `:706-1230`:
`DGCMomentumOptimizer` (its local half: the `dgc_momentum` op and its
step counter; the collective `dgc` rewrite is ROADMAP Queue 1 #10),
`ModelAverage`, `ExponentialMovingAverage`, `RecomputeOptimizer`,
`LookaheadOptimizer` and `GradientMergeOptimizer`. `PipelineOptimizer`
needs the GPipe engine of `parallel/pipeline.py` and raises (#10).

`minimize = append_backward + apply_gradients`: gradients come from the
backward section (backward.py); gradient clipping (`grad_clip`, else
`clip.set_gradient_clip`'s default or a param's `gradient_clip_attr`;
clip.py) rewrites them, then weight decay (`regularization`, or a
ParamAttr's `regularizer`; regularizer.py) adds its term; each optimizer
then appends its update op per parameter (ops/optimizer_ops.py) and any
op it needs once the updates are in (`_finish_update`: Adamax's beta
power, DGC's step counter). The learning rate and the accumulators
(velocities, moments, beta powers) are persistable vars that the startup
program fills with `fill_constant`.

Recompute records its checkpoints on the backward op, and gradient merge
its accumulators and counter (`fluid/lowering.py` runs both). EMA's and
ModelAverage's `apply()` and `restore()` swap values into the tensors
the scope holds, in place on the device (`copy_`): the reference rebinds
scope entries, but a captured step writes into the tensors the scope
held when it was captured (`core/graphs.py DonatedStep`), so a rebind
would leave its replays training a stale tensor. After `restore()` the
replays go on training the live parameters.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

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
           "Ftrl", "Dpsgd", "DGCMomentumOptimizer", "ModelAverage",
           "ExponentialMovingAverage", "RecomputeOptimizer",
           "LookaheadOptimizer", "GradientMergeOptimizer",
           "PipelineOptimizer"]


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


def normalize_dgc_cfg(momentum, sparsity, rampup_begin_step):
    """The DGC config: the reference passes sparsity as a ramp-up list,
    whose last value is the steady-state sparsity the dgc op runs at."""
    if isinstance(sparsity, (list, tuple)):
        sparsity = sparsity[-1]
    return {"momentum": float(momentum), "sparsity": float(sparsity),
            "rampup_begin_step": float(rampup_begin_step)}


class DGCMomentumOptimizer(MomentumOptimizer):
    """Deep Gradient Compression momentum, its local half: the program
    carries the DGC config (``program._dgc_cfg``) and each parameter gets
    a `dgc_momentum` op (plain momentum before `rampup_begin_step`, SGD
    on the dgc-corrected gradient after) over one shared step counter,
    incremented once a step. The collective half (fleet's `dgc` knob,
    `transpile_collective` planting the `dgc` op before each gradient's
    all-reduce) is ROADMAP Queue 1 #10."""

    def __init__(self, learning_rate, momentum, rampup_begin_step=0,
                 rampup_step=1, sparsity=None, use_nesterov=False,
                 num_trainers=None, regularization=None, grad_clip=None,
                 name=None, **kwargs):
        super().__init__(learning_rate, momentum,
                         use_nesterov=use_nesterov,
                         regularization=regularization,
                         grad_clip=grad_clip, name=name, **kwargs)
        self._step_counter = None
        self._dgc_cfg = normalize_dgc_cfg(
            momentum, sparsity if sparsity else [0.75], rampup_begin_step)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        loss.block.program._dgc_cfg = self._dgc_cfg
        return super().minimize(loss, startup_program, parameter_list,
                                no_grad_set)

    def _append_optimize_op(self, block, param_and_grad):
        from .layers import tensor as _tensor

        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        if self._step_counter is None:
            self._step_counter = _tensor.create_global_var(
                [1], 0.0, "float32", persistable=True,
                name=unique_name("dgc_opt_step"))
        return block.append_op(
            type="dgc_momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._create_param_lr(param_and_grad)],
                    "CurrentStep": [self._step_counter]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov,
                   "rampup_begin_step": self._dgc_cfg["rampup_begin_step"]})

    def _finish_update(self, block, params_grads):
        # the shared step counter advances once a step
        if self._step_counter is not None:
            block.append_op(
                type="increment", inputs={"X": [self._step_counter]},
                outputs={"Out": [self._step_counter]}, attrs={"step": 1.0})
        return super()._finish_update(block, params_grads)


class _ParamSwapMixin:
    """`apply()`/`restore()` of EMA and ModelAverage: each parameter's
    value is swapped with its replacement inside the tensor the scope
    holds (`copy_` on the device), and the saved values are copied back
    by `restore()`. The tensors stay the scope's, so a captured step
    that holds them as its static buffers evaluates with the swapped
    values, and its replays after `restore()` train the live ones."""

    def _swap_in(self, replacements):
        from ..core.scope import global_scope

        scope = global_scope()
        self._saved = {}
        with torch.no_grad():
            for name, new in replacements.items():
                cur = scope.find_var(name)
                if cur is None:
                    continue
                self._saved[name] = cur.clone()
                cur.copy_(new.to(cur.dtype))

    def restore(self, executor=None):
        from ..core.scope import global_scope

        scope = global_scope()
        with torch.no_grad():
            for name, old in getattr(self, "_saved", {}).items():
                scope.find_var(name).copy_(old)
        self._saved = {}

    def apply(self, executor=None, need_restore=True):
        """A context manager: inside it the parameters hold their
        replacements; on leaving, `restore()` unless `need_restore` is
        False."""

        @contextlib.contextmanager
        def ctx():
            self._swap_in(self._replacements())
            try:
                yield
            finally:
                if need_restore:
                    self.restore(executor)

        return ctx()


def _scope_tensor(name):
    from ..core.scope import global_scope

    return global_scope().find_var(name)


class ModelAverage(Optimizer, _ParamSwapMixin):
    """The windowed running average of the parameters (reference:
    `optimizer.py:822`). Made after `minimize()`: it appends to the
    current main program, for each trainable parameter, the accumulation
    ops (sum_1 += p, a counter, and at `max_average_window` the rotation
    sum_3 <- sum_1 + sum_2, sum_1 = sum_2 = 0, old_num <- num, num <- 0,
    selected with a 0/1 flag instead of conditional blocks); `apply()`
    swaps each parameter for (sum_1 + sum_2 + sum_3) / (num + old_num),
    computed on the device."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, **kwargs):
        super().__init__(0.0, **kwargs)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self._accum = {}  # param name -> {accumulator: var name}
        block = framework.default_main_program().global_block()
        helper = LayerHelper("model_average")
        for p in [p for p in block.all_parameters() if p.trainable]:
            acc = {}
            for nm in ("sum_1", "sum_2", "sum_3"):
                acc[nm] = helper.create_global_variable(
                    name=unique_name("%s_%s" % (p.name, nm)),
                    shape=list(p.shape), dtype=p.dtype, persistable=True)
                helper.set_variable_initializer(acc[nm],
                                                ConstantInitializer(0.0))
            for nm in ("num_accumulates", "old_num_accumulates"):
                acc[nm] = helper.create_global_variable(
                    name=unique_name("%s_%s" % (p.name, nm)), shape=[1],
                    dtype="float32", persistable=True)
                helper.set_variable_initializer(acc[nm],
                                                ConstantInitializer(0.0))
            self._accum[p.name] = {k: v.name for k, v in acc.items()}
            self._append_accumulate(block, p, acc)

    def _append_accumulate(self, block, p, acc):
        def op(type_, ins, outs, attrs=None):
            block.append_op(type=type_, inputs=ins, outputs=outs,
                            attrs=attrs or {})

        def tmp(stem, shape, dtype):
            return block.create_var(name=unique_name(stem), shape=shape,
                                    dtype=dtype)

        s1, s2, s3 = acc["sum_1"], acc["sum_2"], acc["sum_3"]
        num, old = acc["num_accumulates"], acc["old_num_accumulates"]
        # sum_1 += p; num += 1
        op("elementwise_add", {"X": [s1], "Y": [p]}, {"Out": [s1]},
           {"axis": -1})
        one = tmp("ma_one", [1], "float32")
        op("fill_constant", {}, {"Out": [one]},
           {"shape": [1], "dtype": "float32", "value": 1.0})
        op("elementwise_add", {"X": [num], "Y": [one]}, {"Out": [num]},
           {"axis": -1})
        # the rotation where num >= max_average_window, as a 0/1 flag
        thresh = tmp("ma_thr", [1], "float32")
        op("fill_constant", {}, {"Out": [thresh]},
           {"shape": [1], "dtype": "float32",
            "value": float(self.max_average_window)})
        flag_b = tmp("ma_flagb", [1], "bool")
        op("greater_equal", {"X": [num], "Y": [thresh]}, {"Out": [flag_b]})
        flag = tmp("ma_flag", [1], "float32")
        op("cast", {"X": [flag_b]}, {"Out": [flag]},
           {"in_dtype": "bool", "out_dtype": "float32"})
        keep = tmp("ma_keep", [1], "float32")
        op("scale", {"X": [flag]}, {"Out": [keep]},
           {"scale": -1.0, "bias": 1.0, "bias_after_scale": True})

        def blend(dst, a, b):
            # dst = flag * a + keep * b
            ta, tb = tmp("ma_t", p.shape, p.dtype), tmp("ma_t", p.shape,
                                                         p.dtype)
            op("elementwise_mul", {"X": [a], "Y": [flag]}, {"Out": [ta]},
               {"axis": -1})
            op("elementwise_mul", {"X": [b], "Y": [keep]}, {"Out": [tb]},
               {"axis": -1})
            op("elementwise_add", {"X": [ta], "Y": [tb]}, {"Out": [dst]},
               {"axis": -1})

        s12 = tmp("ma_s12", p.shape, p.dtype)
        op("elementwise_add", {"X": [s1], "Y": [s2]}, {"Out": [s12]},
           {"axis": -1})
        blend(s3, s12, s3)
        op("elementwise_mul", {"X": [s1], "Y": [keep]}, {"Out": [s1]},
           {"axis": -1})
        op("elementwise_mul", {"X": [s2], "Y": [keep]}, {"Out": [s2]},
           {"axis": -1})
        # old_num <- flag * num + keep * old_num (replaced, not summed);
        # num <- keep * num
        tn, to = tmp("ma_t", [1], "float32"), tmp("ma_t", [1], "float32")
        op("elementwise_mul", {"X": [num], "Y": [flag]}, {"Out": [tn]},
           {"axis": -1})
        op("elementwise_mul", {"X": [old], "Y": [keep]}, {"Out": [to]},
           {"axis": -1})
        op("elementwise_add", {"X": [tn], "Y": [to]}, {"Out": [old]},
           {"axis": -1})
        op("elementwise_mul", {"X": [num], "Y": [keep]}, {"Out": [num]},
           {"axis": -1})

    def minimize(self, *a, **k):
        raise NotImplementedError(
            "ModelAverage wraps an inner optimizer; use apply()")

    def _replacements(self):
        out = {}
        for pname, acc in self._accum.items():
            s = _scope_tensor(acc["sum_1"]) + _scope_tensor(acc["sum_2"]) \
                + _scope_tensor(acc["sum_3"])
            n = _scope_tensor(acc["num_accumulates"]).reshape(()) \
                + _scope_tensor(acc["old_num_accumulates"]).reshape(())
            # no accumulation yet: the parameter stays
            out[pname] = torch.where(n > 0, s / n, _scope_tensor(pname))
        return out


class ExponentialMovingAverage(_ParamSwapMixin):
    """The exponential moving average of the parameters (reference:
    `optimizer.py:960`): `update()` appends a step counter and, for each
    trainable parameter, shadow = decay * shadow + (1 - decay) * param;
    `apply()` swaps each parameter for its bias-corrected shadow,
    shadow / (1 - decay^t), computed on the device."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._name = name or "ema"
        self._shadow = {}
        self._step_var = None

    def update(self):
        block = framework.default_main_program().global_block()
        helper = LayerHelper(self._name)
        if self._step_var is None:
            step = helper.create_global_variable(
                name=unique_name(self._name + "_step"), shape=[1],
                dtype="float32", persistable=True)
            helper.set_variable_initializer(step, ConstantInitializer(0.0))
            self._step_var = step
            one = block.create_var(name=unique_name("ema_one"), shape=[1],
                                   dtype="float32")
            block.append_op(type="fill_constant", inputs={},
                            outputs={"Out": [one]},
                            attrs={"shape": [1], "dtype": "float32",
                                   "value": 1.0})
            block.append_op(type="elementwise_add",
                            inputs={"X": [step], "Y": [one]},
                            outputs={"Out": [step]}, attrs={"axis": -1})
        for p in block.all_parameters():
            if not p.trainable:
                continue
            if p.name not in self._shadow:
                shadow = helper.create_global_variable(
                    name=unique_name(p.name + "_ema"), shape=list(p.shape),
                    dtype=p.dtype, persistable=True)
                helper.set_variable_initializer(shadow,
                                                ConstantInitializer(0.0))
                self._shadow[p.name] = shadow
            shadow = self._shadow[p.name]
            block.append_op(
                type="scale", inputs={"X": [shadow]},
                outputs={"Out": [shadow]},
                attrs={"scale": self._decay, "bias": 0.0,
                       "bias_after_scale": True})
            tmp = block.create_var(name=unique_name("ema_tmp"),
                                   shape=p.shape, dtype=p.dtype)
            block.append_op(
                type="scale", inputs={"X": [p]}, outputs={"Out": [tmp]},
                attrs={"scale": 1.0 - self._decay, "bias": 0.0,
                       "bias_after_scale": True})
            block.append_op(type="elementwise_add",
                            inputs={"X": [shadow], "Y": [tmp]},
                            outputs={"Out": [shadow]}, attrs={"axis": -1})

    def _replacements(self):
        corr = None
        if self._step_var is not None:
            t = _scope_tensor(self._step_var.name)
            if t is not None:
                # 1 - decay^t in float64 (float32 would cancel at small
                # t), then in float32 as the reference divides
                t = t.reshape(()).to(torch.float64)
                corr = torch.where(t > 0, 1.0 - self._decay ** t,
                                   torch.ones_like(t)).clamp_min(1e-12)
        out = {}
        for pname, shadow in self._shadow.items():
            sv = _scope_tensor(shadow.name)
            if sv is not None:
                out[pname] = sv if corr is None \
                    else sv / corr.to(sv.dtype)
        return out


class RecomputeOptimizer(Optimizer):
    """Activation recompute (reference: `optimizer.py:1037`): the inner
    optimizer's `minimize`, then the checkpoints recorded on the
    backward op. The lowering splits the forward at them and recomputes
    each segment's interior in the backward (`fluid/lowering.py
    _remat_segments`)."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints

    def __getattr__(self, item):
        return getattr(self._optimizer, item)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        result = self._optimizer.minimize(loss, startup_program,
                                          parameter_list, no_grad_set)
        if self._checkpoints:
            for op in loss.block.ops:
                if op.type == "backward":
                    op.attrs["checkpoints"] = [
                        v.name if isinstance(v, Variable) else v
                        for v in self._checkpoints]
        return result


class LookaheadOptimizer:
    """Lookahead (reference: `optimizer.py:1067`): a persistable slow copy
    of every parameter (assigned from it in the startup program) and a
    step counter; after the inner optimizer's updates, one
    `lookahead_step` op a parameter: every k steps the slow weights move
    `alpha` of the way to the fast ones and the fast ones snap back."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha must be in [0, 1], got %r" % (alpha,))
        if k < 1:
            raise ValueError("k must be at least 1, got %r" % (k,))
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k

    def __getattr__(self, item):
        return getattr(self.inner_optimizer, item)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        result = self.inner_optimizer.minimize(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set)
        block = loss.block
        startup = startup_program or framework.default_startup_program()
        helper = LayerHelper("lookahead")
        counter = helper.create_global_variable(
            name=unique_name("lookahead_counter"), shape=[1],
            dtype="int64", persistable=True)
        helper.set_variable_initializer(counter, ConstantInitializer(0))
        block.append_op(type="increment", inputs={"X": [counter]},
                        outputs={"Out": [counter]}, attrs={"step": 1.0})
        for param, _ in result[1]:
            slow = helper.create_global_variable(
                name=unique_name(param.name + "@SLOW"), shape=param.shape,
                dtype=param.dtype, persistable=True)
            # the slow weights start as a copy of the initialized params
            startup.global_block().create_var(
                name=slow.name, shape=slow.shape, dtype=slow.dtype,
                persistable=True)
            startup.global_block().append_op(
                type="assign", inputs={"X": [param.name]},
                outputs={"Out": [slow.name]}, attrs={})
            block.append_op(
                type="lookahead_step",
                inputs={"Param": [param], "SlowParam": [slow],
                        "Step": [counter]},
                outputs={"ParamOut": [param], "SlowParamOut": [slow]},
                attrs={"alpha": float(self.alpha), "k": int(self.k)})
        return result


class GradientMergeOptimizer:
    """k-step gradient accumulation (reference: `optimizer.py:1125`):
    float32 persistable accumulators, one a gradient, and a step counter,
    recorded on the backward op (``gradient_merge``: k_steps, avg, the
    grad -> accumulator map, the counter) and threaded as scope state
    through its ``GradMergeState`` slots. Every step adds the fresh
    gradients into the accumulators; every k-th the optimizer section
    runs once on the merged ones (divided by k when `avg`), the
    accumulators reset and the counter wraps (`fluid/lowering.py`)."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        if k_steps < 1:
            raise ValueError("k_steps must be at least 1, got %r"
                             % (k_steps,))
        self.inner_optimizer = inner_optimizer
        self.k_steps = k_steps
        self.avg = avg

    def __getattr__(self, item):
        return getattr(self.inner_optimizer, item)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        result = self.inner_optimizer.minimize(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set)
        if self.k_steps <= 1:
            return result
        block = loss.block
        bop = next((op for op in block.ops if op.type == "backward"), None)
        if bop is None:
            raise ValueError("gradient merge needs a backward section")
        helper = LayerHelper("gradient_merge")
        acc_map = {}
        for param, grad in result[1]:
            acc = helper.create_global_variable(
                name=unique_name(param.name + "@GRAD@MERGE"),
                shape=param.shape, dtype="float32", persistable=True)
            helper.set_variable_initializer(acc, ConstantInitializer(0.0))
            acc_map[grad.name] = acc.name
        counter = helper.create_global_variable(
            name=unique_name("gradient_merge_counter"), shape=[1],
            dtype="int64", persistable=True)
        helper.set_variable_initializer(counter, ConstantInitializer(0))
        bop.attrs["gradient_merge"] = {
            "k_steps": int(self.k_steps), "avg": bool(self.avg),
            "acc_map": acc_map, "counter": counter.name}
        # the accumulators and the counter ride the backward op, so the
        # block's dataflow analysis threads them as scope state
        extra = list(acc_map.values()) + [counter.name]
        bop.input_names["GradMergeState"] = list(extra)
        bop.output_names["GradMergeState"] = list(extra)
        return result


class PipelineOptimizer:
    """The pipeline-parallel program splitter (reference:
    `optimizer.py:1181`). Its engine, `parallel/pipeline.py` (GPipe over a
    pp mesh axis), is not ported (ROADMAP Queue 1 #10), so it raises."""

    def __init__(self, optimizer, *args, **kwargs):
        raise NotImplementedError(
            "PipelineOptimizer needs the GPipe engine of "
            "parallel/pipeline.py, which is not ported yet (ROADMAP "
            "Queue 1 #10)")


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
