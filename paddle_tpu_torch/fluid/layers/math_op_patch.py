"""Operator sugar for Variable (counterpart:
`paddle_tpu/fluid/layers/math_op_patch.py`): ``x + 1.0``, ``2 * x``,
``step ** -0.5``, ``x < y``. A scalar beside `+`, `-`, `*` or `/` (the
scalar not the divisor's numerator) becomes one `scale` op; any other
scalar a [1] `fill_constant` of the var's dtype."""
from __future__ import annotations

import numpy as np


def binary(x, other, op_type, reverse=False):
    from . import tensor as t
    from ..layer_helper import apply_op

    if np.isscalar(other):
        if op_type == "elementwise_add":
            return t.scale(x, 1.0, float(other))
        if op_type == "elementwise_sub" and not reverse:
            return t.scale(x, 1.0, -float(other))
        if op_type == "elementwise_sub" and reverse:
            return t.scale(x, -1.0, float(other))
        if op_type == "elementwise_mul":
            return t.scale(x, float(other), 0.0)
        if op_type == "elementwise_div" and not reverse:
            return t.scale(x, 1.0 / float(other), 0.0)
        other = t.fill_constant([1], x.dtype, float(other))
    a, b = (other, x) if reverse else (x, other)
    return apply_op(op_type, op_type, {"X": [a], "Y": [b]}, {"axis": -1},
                    ["Out"], out_dtype=x.dtype)[0]
