"""AMP decorator (counterpart:
`paddle_tpu/fluid/contrib/mixed_precision/decorator.py`).

`decorate()` marks the program with the white/black-list cast policy
that the lowering applies op by op (white-list ops in bf16, black-list
ops in float32) and, at amp_level "O2" (the default and the one level
ported), rewrites it for fp32 master weights: live params and their grads become bf16, every
optimizer op updates an fp32 ``<param>@MASTER`` var, and a trailing cast
re-derives the live param (`fp16_utils.rewrite_master_weights`).

bfloat16 shares float32's exponent range and needs no loss scaling.
float16 (dynamic or static loss scaling) and the fp8 tier are not
ported and raise.
"""
from __future__ import annotations

from ... import framework
from .fp16_lists import AutoMixedPrecisionLists
from .fp16_utils import rewrite_master_weights


class OptimizerWithMixedPrecision:
    def __init__(self, optimizer, amp_lists=None, amp_dtype="bfloat16",
                 amp_level="O2"):
        if amp_dtype != "bfloat16":
            raise NotImplementedError(
                "amp_dtype %r is not ported yet: float16 loss scaling and "
                "the fp8 tier come later (ROADMAP Queue 1 #5, #10); use "
                "bfloat16" % (amp_dtype,))
        if amp_level != "O2":
            raise NotImplementedError(
                "amp_level %r is not ported yet (ROADMAP Queue 1 #5); only "
                "O2, the default" % (amp_level,))
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._amp_dtype = amp_dtype
        self._master_of = {}

    def __getattr__(self, item):
        return getattr(self._optimizer, item)

    def get_master_weights(self):
        """{param_name: master_var_name} after minimize()."""
        return dict(self._master_of)

    def backward(self, loss, **kwargs):
        return self._optimizer.backward(loss, **kwargs)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        program = loss.block.program
        program._amp = True
        program._amp_lists = self._amp_lists
        program._amp_dtype = self._amp_dtype
        result = self._optimizer.minimize(loss, startup_program,
                                          parameter_list, no_grad_set)
        startup = startup_program or framework.default_startup_program()
        self._master_of = rewrite_master_weights(program, startup,
                                                 self._amp_dtype)
        program._amp_master_of = dict(self._master_of)
        program._version += 1
        return result


def decorate(optimizer, amp_lists=None, init_loss_scaling=2.**15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=True, amp_dtype="bfloat16",
             amp_level="O2"):
    """The reference's signature. Only ``amp_dtype="bfloat16"`` at
    ``amp_level="O2"`` (the cast policy plus bf16 live params over fp32
    master weights) is ported; bf16 needs no loss scaling, so the
    loss-scaling arguments, which belong to float16, are not read."""
    return OptimizerWithMixedPrecision(optimizer, amp_lists,
                                       amp_dtype=amp_dtype,
                                       amp_level=amp_level)
