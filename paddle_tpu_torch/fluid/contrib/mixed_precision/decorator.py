"""AMP decorator (counterpart:
`paddle_tpu/fluid/contrib/mixed_precision/decorator.py`).

`decorate()` marks the program with the white/black-list cast policy
that the lowering applies op by op (white-list ops in the 16-bit compute
dtype, black-list ops in float32). At amp_level "O2" (the default) it
also rewrites the program for fp32 master weights: live params and their
grads become 16-bit, every optimizer op updates an fp32
``<param>@MASTER`` var, and a trailing cast re-derives the live param
(`fp16_utils.rewrite_master_weights`). "O1" is the cast policy alone,
"O0" minimizes as if undecorated; `FLAGS_tpu_amp_level` overrides the
level and `FLAGS_tpu_amp_dtype` the dtype.

bfloat16 shares float32's exponent range and needs no loss scaling.
float16 does: with dynamic scaling (the default) the loss's cotangent is
scaled by a persistable scale var, the gradients are checked for
non-finite values (the count summed over the data-parallel ranks) and
unscaled in float32, an overflow step leaves every param, master,
moment and counter as it was, and the scale grows by `incr_ratio` after
`incr_every_n_steps` clean steps and shrinks by `decr_ratio` after
`decr_every_n_nan_or_inf` overflows (`fluid/lowering.py
_loss_scaled_post`); static scaling multiplies and divides by
`init_loss_scaling` and never skips. The fp8 tier is not ported and
raises (ROADMAP Queue 1 #10).
"""
from __future__ import annotations

import warnings

from ... import framework
from ....utils.flags import get_flag
from .fp16_lists import AutoMixedPrecisionLists
from .fp16_utils import rewrite_master_weights, wire_dynamic_loss_scaling

_FP8_ALIASES = ("float8_e4m3", "float8_e4m3fn", "float8", "fp8")


def _normalize_amp_dtype(amp_dtype):
    """"bfloat16" or "float16" (any spelling `normalize_dtype` takes);
    the fp8 tier raises, naming its queue item."""
    if isinstance(amp_dtype, str) and amp_dtype.lower() in _FP8_ALIASES:
        raise NotImplementedError(
            "amp_dtype %r: the fp8 tier is not ported yet (ROADMAP Queue "
            "1 #10); use bfloat16 or float16" % (amp_dtype,))
    from ....core.types import normalize_dtype

    d = normalize_dtype(amp_dtype)
    if d not in ("bfloat16", "float16"):
        raise ValueError("amp_dtype must be 'bfloat16', 'float16' or "
                         "'float8_e4m3', got %r" % (amp_dtype,))
    return d


class OptimizerWithMixedPrecision:
    def __init__(self, optimizer, amp_lists=None, init_loss_scaling=2.**15,
                 use_dynamic_loss_scaling=True, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, incr_ratio=2.0,
                 decr_ratio=0.8, amp_dtype="bfloat16", amp_level="O2"):
        if amp_level not in ("O0", "O1", "O2"):
            raise ValueError("amp_level must be one of O0/O1/O2, got %r"
                             % (amp_level,))
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._loss_scaling = float(init_loss_scaling)
        self._use_dynamic_loss_scaling = bool(use_dynamic_loss_scaling)
        self._incr_every_n_steps = int(incr_every_n_steps)
        self._decr_every_n_nan_or_inf = int(decr_every_n_nan_or_inf)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._amp_dtype = _normalize_amp_dtype(amp_dtype)
        self._amp_level = amp_level
        self._master_of = {}
        self._scale_state = None

    def __getattr__(self, item):
        return getattr(self._optimizer, item)

    def get_loss_scaling(self):
        """The current loss scale: the scope's value under dynamic
        scaling, the static init value otherwise."""
        if self._scale_state is not None:
            from ....core.scope import global_scope
            from ....core.types import to_numpy

            v = global_scope().find_var(self._scale_state["scale"])
            if v is not None:
                return float(to_numpy(v).reshape(-1)[0])
        return self._loss_scaling

    def get_master_weights(self):
        """{param_name: master_var_name} after minimize() at level O2."""
        return dict(self._master_of)

    def backward(self, loss, **kwargs):
        return self._optimizer.backward(loss, **kwargs)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def _effective_level(self):
        flag = str(get_flag("FLAGS_tpu_amp_level", "") or "").upper()
        return flag if flag in ("O0", "O1", "O2") else self._amp_level

    def _effective_dtype(self):
        flag = str(get_flag("FLAGS_tpu_amp_dtype", "") or "")
        return _normalize_amp_dtype(flag) if flag else self._amp_dtype

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        program = loss.block.program
        level = self._effective_level()
        if level == "O0":  # lowers exactly like an undecorated program
            return self._optimizer.minimize(loss, startup_program,
                                            parameter_list, no_grad_set)
        amp_dtype = self._effective_dtype()
        program._amp = True
        program._amp_lists = self._amp_lists
        program._amp_dtype = amp_dtype
        result = self._optimizer.minimize(loss, startup_program,
                                          parameter_list, no_grad_set)
        startup = startup_program or framework.default_startup_program()
        if level == "O2":
            self._master_of = rewrite_master_weights(program, startup,
                                                     amp_dtype)
            program._amp_master_of = dict(self._master_of)
        if amp_dtype == "float16":
            self._wire_loss_scaling(program, startup)
        program._version += 1
        return result

    def _wire_loss_scaling(self, program, startup):
        bop = next((op for op in program.global_block().ops
                    if op.type == "backward"), None)
        if bop is not None and bop.attrs.get("gradient_merge") is not None:
            warnings.warn(
                "fp16 loss scaling is not wired under gradient "
                "merge (the merged-grad cond owns the update "
                "cadence); training proceeds UNSCALED — expect "
                "fp16 gradient underflow. Use bfloat16 instead.")
        elif self._use_dynamic_loss_scaling:
            self._scale_state = wire_dynamic_loss_scaling(program, startup, {
                "init_loss_scaling": self._loss_scaling,
                "incr_every_n_steps": self._incr_every_n_steps,
                "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
                "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
            })
        elif bop is not None:
            # static scaling: the cotangent scaled and the gradients
            # unscaled by a constant, no skip
            bop.attrs["static_loss_scaling"] = self._loss_scaling


def decorate(optimizer, amp_lists=None, init_loss_scaling=2.**15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=True, amp_dtype="bfloat16",
             amp_level="O2"):
    """The reference's signature (without the fp8 tier's history
    length). `amp_dtype` "bfloat16" (the default, no loss scaling) or
    "float16" (dynamic or static loss scaling); `amp_level` "O1" is the
    cast policy only, "O2" (the default) adds 16-bit live params over
    fp32 master weights, "O0" leaves the program undecorated."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio,
        decr_ratio, amp_dtype=amp_dtype, amp_level=amp_level)
