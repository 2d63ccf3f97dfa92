"""Dense math operators of the slice (counterpart:
`paddle_tpu/ops/math_ops.py`): `elementwise_add`, `_sub`, `_mul`,
`_div`, `_max`, `_min`, `_pow`, `_mod` and `_floordiv` with Paddle's
`axis` broadcast rule, `mul` (x_num_col_dims flattening), `matmul`
(transpose_X/Y, alpha), `scale`, `mean`, `reduce_sum`, `cast`, the
comparisons (`equal` ... `greater_equal`, numpy broadcasting, bool out)
and `logical_and` / `_or` / `_xor` / `_not`. The products are plain
`torch.matmul`: the reference computes them outside any Pallas kernel.
`_mod` and `_floordiv` round toward minus infinity, as numpy does.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register_op
from ..core.types import to_torch_dtype


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
_register_elementwise("sub", torch.sub)
_register_elementwise("mul", torch.mul)
_register_elementwise("div", torch.div)
_register_elementwise("max", torch.maximum)
_register_elementwise("min", torch.minimum)
_register_elementwise("pow", torch.pow)
_register_elementwise("mod", torch.remainder)
_register_elementwise("floordiv", torch.floor_divide)


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


@register_op("matmul")
def _matmul(ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    if x.ndim == 1:
        x = x[None, :]
    if y.ndim == 1:
        y = y[:, None]
    if attrs.get("transpose_X", False):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False):
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}


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


@register_op("reduce_sum")
def _reduce_sum(ins, attrs):
    x = ins["X"][0]
    keep = attrs.get("keep_dim", False)
    dim = attrs.get("dim", [0])
    dim = [dim] if isinstance(dim, int) else list(dim)
    if attrs.get("reduce_all", False) or not dim:
        dim = range(x.ndim)
    out = torch.sum(x, dim=tuple(d % x.ndim for d in dim), keepdim=keep)
    return {"Out": out.reshape((1,)) if out.ndim == 0 else out}


@register_op("cast")
def _cast(ins, attrs):
    return {"Out": ins["X"][0].to(to_torch_dtype(attrs["out_dtype"]))}


def _register_cmp(name, fn):
    @register_op(name)
    def _cmp(ins, attrs, _fn=fn):
        return {"Out": _fn(ins["X"][0], ins["Y"][0])}


_register_cmp("equal", torch.eq)
_register_cmp("not_equal", torch.ne)
_register_cmp("less_than", torch.lt)
_register_cmp("less_equal", torch.le)
_register_cmp("greater_than", torch.gt)
_register_cmp("greater_equal", torch.ge)
_register_cmp("logical_and", torch.logical_and)
_register_cmp("logical_or", torch.logical_or)
_register_cmp("logical_xor", torch.logical_xor)


@register_op("logical_not")
def _lnot(ins, attrs):
    return {"Out": torch.logical_not(ins["X"][0])}
