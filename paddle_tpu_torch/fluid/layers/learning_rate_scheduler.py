"""Learning-rate schedules (counterpart:
`paddle_tpu/fluid/layers/learning_rate_scheduler.py`, all eight).

Each schedule is ordinary ops of the main program over the persistable
step counter `@LR_DECAY_COUNTER@`: an `increment` prepended to the
global block advances it first thing every run, and the learning rate
is computed from it as a float32 [1] var, which the optimizer reads as
its `LearningRate` input. The counter is int64 in the program and int32
on the device (`core/types.py`).
"""
from __future__ import annotations

import math

from .. import framework
from ..layer_helper import LayerHelper, apply_op
from ..initializer import ConstantInitializer
from . import nn
from . import tensor

__all__ = [
    "noam_decay", "exponential_decay", "natural_exp_decay",
    "inverse_time_decay", "polynomial_decay", "piecewise_decay",
    "cosine_decay", "linear_lr_warmup",
]

LR_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def _decay_step_counter(begin=0):
    """The step counter (starting at `begin`, incremented before
    anything else runs) as a float32 var."""
    helper = LayerHelper("global_step_counter")
    counter = helper.create_global_variable(
        name=LR_COUNTER_NAME, shape=[1], dtype="int64", persistable=True)
    helper.set_variable_initializer(counter, ConstantInitializer(begin))
    helper.main_program.global_block()._prepend_op(
        type="increment", inputs={"X": [counter]},
        outputs={"Out": [counter]}, attrs={"step": 1.0})
    return tensor.cast(counter, "float32")


def _single(op_type, ins, attrs, dtype="float32"):
    return apply_op(op_type, op_type, ins, attrs, ["Out"],
                    out_dtype=dtype)[0]


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    """lr * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5) (Vaswani
    et al. 2017), the step counted from 1."""
    step = _decay_step_counter(1)
    a = step ** -0.5
    b = step * float(warmup_steps) ** -1.5
    return learning_rate * (d_model ** -0.5) * nn.elementwise_min(a, b)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _decay_step_counter()
    ratio = step / float(decay_steps)
    if staircase:
        ratio = _single("floor", {"X": [ratio]}, {})
    return tensor.scale(_power(decay_rate, ratio), learning_rate, 0.0)


def _power(base, exponent_var):
    # base^x = exp(x * ln(base))
    return nn.exp(tensor.scale(exponent_var, math.log(base), 0.0))


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _decay_step_counter()
    ratio = step / float(decay_steps)
    if staircase:
        ratio = _single("floor", {"X": [ratio]}, {})
    return tensor.scale(nn.exp(tensor.scale(ratio, -decay_rate, 0.0)),
                        learning_rate, 0.0)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    step = _decay_step_counter()
    ratio = step / float(decay_steps)
    if staircase:
        ratio = _single("floor", {"X": [ratio]}, {})
    denom = tensor.scale(ratio, decay_rate, 1.0)
    lr = tensor.fill_constant([1], "float32", learning_rate)
    return lr / denom


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = _decay_step_counter()
    capped = nn.elementwise_min(
        step, tensor.fill_constant([1], "float32", float(decay_steps)))
    frac = tensor.scale(capped, 1.0 / float(decay_steps), 0.0)
    one_minus = tensor.scale(frac, -1.0, 1.0)
    powed = _single("elementwise_pow",
                    {"X": [one_minus],
                     "Y": [tensor.fill_constant([1], "float32", power)]},
                    {"axis": -1})
    return tensor.scale(powed, learning_rate - end_learning_rate,
                        end_learning_rate)


def piecewise_decay(boundaries, values):
    step = _decay_step_counter()
    lr = tensor.fill_constant([1], "float32", values[-1])
    # nested where() from the last boundary backwards
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        cond = _single("less_than",
                       {"X": [step],
                        "Y": [tensor.fill_constant([1], "float32",
                                                   float(b))]},
                       {}, dtype="bool")
        lr = nn.where(cond, tensor.fill_constant([1], "float32", v), lr)
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _decay_step_counter()
    epoch_f = _single("floor", {"X": [tensor.scale(
        step, 1.0 / step_each_epoch, 0.0)]}, {})
    frac = tensor.scale(epoch_f, math.pi / epochs, 0.0)
    return tensor.scale(nn.cos(frac), learning_rate * 0.5,
                        0.0) + learning_rate * 0.5


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    step = _decay_step_counter()
    warm = tensor.scale(step, (end_lr - start_lr) / float(warmup_steps),
                        start_lr)
    if not isinstance(learning_rate, framework.Variable):
        learning_rate = tensor.fill_constant([1], "float32",
                                             float(learning_rate))
    cond = _single("less_than",
                   {"X": [step],
                    "Y": [tensor.fill_constant([1], "float32",
                                               float(warmup_steps))]},
                   {}, dtype="bool")
    return nn.where(cond, warm, learning_rate)
