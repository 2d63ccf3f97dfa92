"""Dense math operators of the slice (counterpart:
`paddle_tpu/ops/math_ops.py`): `elementwise_add` with Paddle's `axis`
broadcast rule, `mul` (x_num_col_dims flattening), `scale`, `mean`.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register_op


def _bcast_pair(x, y, axis):
    """Paddle elementwise broadcast: align y into x at `axis`."""
    if x.ndim == y.ndim:
        return x, y
    if x.ndim < y.ndim:
        y2, x2 = _bcast_pair(y, x, axis)
        return x2, y2
    if axis < 0:
        axis = x.ndim - y.ndim
    new_shape = (1,) * axis + tuple(y.shape) + (1,) * (x.ndim - axis - y.ndim)
    return x, y.reshape(new_shape)


def _register_elementwise(name, fn):
    @register_op("elementwise_" + name)
    def _ew(ins, attrs, _fn=fn):
        x, y = ins["X"][0], ins["Y"][0]
        x, y = _bcast_pair(x, y, attrs.get("axis", -1))
        return {"Out": _fn(x, y)}


_register_elementwise("add", torch.add)


@register_op("mul")
def _mul(ins, attrs):
    # reference: operators/mul_op.cc — flatten x to 2-D by x_num_col_dims.
    x, y = ins["X"][0], ins["Y"][0]
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    x2 = x.reshape((int(np.prod(x.shape[:xn])), -1))
    y2 = y.reshape((int(np.prod(y.shape[:yn])), -1))
    out = x2 @ y2
    return {"Out": out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))}


def _scalar_of(x, v):
    # the reference casts the attr to x's dtype first (an integer x
    # truncates it)
    return v if x.is_floating_point() else int(v)


@register_op("scale")
def _scale(ins, attrs):
    x = ins["X"][0]
    scale = _scalar_of(x, attrs.get("scale", 1.0))
    bias = _scalar_of(x, attrs.get("bias", 0.0))
    if attrs.get("bias_after_scale", True):
        out = x * scale + bias
    else:
        out = (x + bias) * scale
    return {"Out": out}


@register_op("mean")
def _mean(ins, attrs):
    return {"Out": torch.mean(ins["X"][0]).reshape((1,))}
