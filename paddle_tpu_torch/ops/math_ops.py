"""Dense math operators (counterpart: `paddle_tpu/ops/math_ops.py`, all
of it): `elementwise_add`, `_sub`, `_mul`, `_div`, `_max`, `_min`,
`_pow`, `_mod` and `_floordiv` with Paddle's `axis` broadcast rule, `mul`
(x_num_col_dims flattening), `matmul` (transpose_X/Y, alpha),
`matmul_v2`, `scale`, `sum`, `mean`, the `reduce_*` family, `cast`, the
comparisons (`equal` ... `greater_equal`, numpy broadcasting, bool out),
`logical_and` / `_or` / `_xor` / `_not`, the finiteness tests, the norms
(`squared_l2_norm`, `p_norm`, `l1_norm`, `frobenius_norm`, `dist`,
`clip_by_norm`), `clip`, `maximum`, `minimum`, `pow`, `minus`, the
special functions (`lgamma`, `digamma`, `erfinv`), `lerp`, `frac`,
`trunc`, the indexing ops (`take`, `put_along_axis`, `masked_fill`,
`searchsorted`), and the loss-scaling ops (`amp_check_finite_and_scale`,
`check_finite_and_unscale`, `update_loss_scaling`). The products are
plain `torch.matmul`: the reference computes them outside any Pallas
kernel. `_mod` and `_floordiv` round toward minus infinity, as numpy
does. No op here reads a value on the host, so each runs inside a
captured CUDA graph; `take` fills an out-of-range index as `jnp.take`
does (NaN, or the type's extreme integer) instead of raising.
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


def _reduce_dims(x, attrs):
    """The reduced dims of a `reduce_*` op: every dim with `reduce_all`
    or an empty `dim` (default [0]), else `dim` taken modulo the rank."""
    dim = attrs.get("dim", [0])
    dim = [dim] if isinstance(dim, int) else list(dim)
    if attrs.get("reduce_all", False) or not dim:
        return tuple(range(x.ndim))
    return tuple(sorted({d % x.ndim for d in dim}))


def _over_dims(fn):
    """A reduction over a tuple of dims from a one-dim torch reduction
    (`torch.prod`, `any`, `all` take one dim), innermost first."""
    def red(x, dims, keep):
        for d in sorted(dims, reverse=True):
            x = fn(x, dim=d, keepdim=keep)
        return x
    return red


_REDUCERS = {
    "sum": lambda x, dims, keep: torch.sum(x, dim=dims, keepdim=keep),
    "mean": lambda x, dims, keep: torch.mean(x, dim=dims, keepdim=keep),
    "max": lambda x, dims, keep: torch.amax(x, dim=dims, keepdim=keep),
    "min": lambda x, dims, keep: torch.amin(x, dim=dims, keepdim=keep),
    "prod": _over_dims(torch.prod),
    "any": lambda x, dims, keep: _over_dims(torch.any)(
        x.to(torch.bool), dims, keep),
    "all": lambda x, dims, keep: _over_dims(torch.all)(
        x.to(torch.bool), dims, keep),
}


def _register_reduce(name, fn):
    @register_op("reduce_" + name)
    def _red(ins, attrs, _fn=fn):
        x = ins["X"][0]
        dims = _reduce_dims(x, attrs)
        out = _fn(x, dims, attrs.get("keep_dim", False)) if dims else x
        return {"Out": out.reshape((1,)) if out.ndim == 0 else out}


for _name, _fn in _REDUCERS.items():
    _register_reduce(_name, _fn)


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


@register_op("matmul_v2")
def _matmul_v2(ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("trans_x", False):
        x = x.transpose(-1, -2)
    if attrs.get("trans_y", False):
        y = y.transpose(-1, -2)
    return {"Out": torch.matmul(x, y)}


@register_op("sum")
def _sum(ins, attrs):
    """The sum of the X inputs, left to right (`fc` over several
    inputs)."""
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("minus")
def _minus(ins, attrs):
    return {"Out": ins["X"][0] - ins["Y"][0]}


@register_op("maximum")
def _maximum(ins, attrs):
    return {"Out": torch.maximum(ins["X"][0], ins["Y"][0])}


@register_op("minimum")
def _minimum(ins, attrs):
    return {"Out": torch.minimum(ins["X"][0], ins["Y"][0])}


@register_op("pow")
def _pow(ins, attrs):
    x = ins["X"][0]
    factor = ins["FactorTensor"][0] if ins.get("FactorTensor") else \
        attrs.get("factor", 1.0)
    return {"Out": torch.pow(x, factor)}


@register_op("clip")
def _clip(ins, attrs):
    return {"Out": torch.clamp(ins["X"][0], attrs.get("min"),
                               attrs.get("max"))}


@register_op("clip_by_norm")
def _clip_by_norm(ins, attrs):
    """x scaled by max_norm / ||x|| where ||x|| (in x's dtype) exceeds
    max_norm."""
    x = ins["X"][0]
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12),
                        torch.ones_like(norm))
    return {"Out": x * scale.to(x.dtype)}


@register_op("squared_l2_norm")
def _squared_l2_norm(ins, attrs):
    return {"Out": torch.sum(torch.square(ins["X"][0])).reshape((1,))}


@register_op("p_norm")
def _p_norm(ins, attrs):
    x = ins["X"][0]
    p = attrs.get("porder", 2.0)
    out = torch.sum(torch.abs(x) ** p, dim=attrs.get("axis", -1),
                    keepdim=attrs.get("keepdim", False))
    return {"Out": out ** (1.0 / p)}


@register_op("l1_norm")
def _l1_norm(ins, attrs):
    return {"Out": torch.sum(torch.abs(ins["X"][0]))}


@register_op("frobenius_norm")
def _frobenius_norm(ins, attrs):
    x = ins["X"][0]
    dims = attrs.get("dim", None) or tuple(range(x.ndim))
    return {"Out": torch.sqrt(torch.sum(x * x, dim=tuple(dims),
                                        keepdim=attrs.get("keep_dim",
                                                          False)))}


@register_op("dist")
def _dist(ins, attrs):
    """The p-norm of |X - Y| (broadcast); inf the max, -inf the min, 0
    the count of non-zeros."""
    z = torch.abs(ins["X"][0] - ins["Y"][0])
    p = float(attrs.get("p", 2.0))
    if p == float("inf"):
        return {"Out": torch.amax(z)}
    if p == float("-inf"):
        return {"Out": torch.amin(z)}
    if p == 0.0:
        return {"Out": torch.sum((z != 0).to(z.dtype))}
    return {"Out": torch.pow(torch.sum(torch.pow(z, p)), 1.0 / p)}


@register_op("isfinite")
def _isfinite(ins, attrs):
    """Whether every element is finite, as a [1] bool."""
    return {"Out": torch.all(torch.isfinite(ins["X"][0])).reshape((1,))}


@register_op("isfinite_v2")
def _isfinite_v2(ins, attrs):
    return {"Out": torch.isfinite(ins["X"][0])}


@register_op("isnan_v2")
def _isnan_v2(ins, attrs):
    return {"Out": torch.isnan(ins["X"][0])}


@register_op("isinf_v2")
def _isinf_v2(ins, attrs):
    return {"Out": torch.isinf(ins["X"][0])}


def _found_inf(xs):
    """[1] bool: some element of some tensor of `xs` is not finite."""
    finite = torch.ones((), dtype=torch.bool, device=xs[0].device)
    for x in xs:
        finite = finite & torch.all(torch.isfinite(x))
    return torch.logical_not(finite).reshape((1,))


@register_op("amp_check_finite_and_scale")
def _amp_check_finite_and_scale(ins, attrs):
    """Every X times Scale (in its dtype), and FoundInfinite, a [1] bool:
    whether any X held a non-finite value."""
    scale = ins["Scale"][0]
    return {"Out": [x * scale.to(x.dtype) for x in ins["X"]],
            "FoundInfinite": _found_inf(ins["X"])}


@register_op("check_finite_and_unscale")
def _check_finite_and_unscale(ins, attrs):
    """Every X times 1 / Scale (in its dtype), and FoundInfinite."""
    inv = 1.0 / ins["Scale"][0]
    return {"Out": [x * inv.to(x.dtype) for x in ins["X"]],
            "FoundInfinite": _found_inf(ins["X"])}


@register_op("update_loss_scaling")
def _update_loss_scaling(ins, attrs):
    """The dynamic loss scale's state machine, the reference's
    `update_loss_scaling`: an overflow counts a bad step and clears the
    good ones, a clean step the reverse; `decr_every_n_nan_or_inf` bad
    steps multiply the scale by `decr_ratio`, `incr_every_n_steps` good
    ones by `incr_ratio` (each count then restarts), and the scale never
    falls below 1. Every X is zeroed on an overflow."""
    found = ins["FoundInfinite"][0].reshape(()).to(torch.bool)
    scale = ins["PrevLossScaling"][0]
    good, bad = ins["InGoodSteps"][0], ins["InBadSteps"][0]
    new_bad = torch.where(found, bad + 1, torch.zeros_like(bad))
    new_good = torch.where(found, torch.zeros_like(good), good + 1)
    dec = new_bad >= attrs.get("decr_every_n_nan_or_inf", 2)
    inc = new_good >= attrs.get("incr_every_n_steps", 1000)
    new_scale = torch.where(
        dec, scale * attrs.get("decr_ratio", 0.5),
        torch.where(inc, scale * attrs.get("incr_ratio", 2.0), scale))
    new_scale = torch.clamp(new_scale, min=1.0)
    return {"Out": [torch.where(found, torch.zeros_like(x), x)
                    for x in ins["X"]],
            "LossScaling": new_scale,
            "OutGoodSteps": torch.where(inc, torch.zeros_like(good),
                                        new_good),
            "OutBadSteps": torch.where(dec, torch.zeros_like(bad),
                                       new_bad)}


@register_op("lgamma")
def _lgamma(ins, attrs):
    return {"Out": torch.lgamma(ins["X"][0])}


@register_op("digamma")
def _digamma(ins, attrs):
    return {"Out": torch.digamma(ins["X"][0])}


@register_op("erfinv")
def _erfinv(ins, attrs):
    return {"Out": torch.erfinv(ins["X"][0])}


@register_op("lerp")
def _lerp(ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    w = ins["Weight"][0] if ins.get("Weight") else attrs.get("weight", 0.5)
    return {"Out": x + w * (y - x)}


@register_op("frac")
def _frac(ins, attrs):
    x = ins["X"][0]
    return {"Out": x - torch.trunc(x)}


@register_op("trunc")
def _trunc(ins, attrs):
    return {"Out": torch.trunc(ins["X"][0])}


def _fill_value(dtype):
    """What `jnp.take` gives for an out-of-range index."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min if dtype.is_signed else \
        torch.iinfo(dtype).max


@register_op("take")
def _take(ins, attrs):
    """Elements of the flattened X at Index: a negative index counts from
    the end, one out of range gives `_fill_value` (as `jnp.take`)."""
    flat = ins["X"][0].reshape(-1)
    n = flat.numel()
    idx = ins["Index"][0].to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    out = flat[idx.clamp(0, max(n - 1, 0))]
    fill = torch.full((), _fill_value(flat.dtype), dtype=flat.dtype,
                      device=flat.device)
    return {"Out": torch.where(valid, out, fill)}


@register_op("put_along_axis")
def _put_along_axis(ins, attrs):
    """Input with Value scattered along `axis` at Index (`reduce` "add"
    adds, else sets)."""
    x, idx, v = ins["Input"][0], ins["Index"][0], ins["Value"][0]
    axis = attrs.get("Axis", attrs.get("axis", 0))
    reduce = attrs.get("Reduce", attrs.get("reduce", "assign"))
    idx = idx.to(torch.int64)
    v = torch.broadcast_to(v.to(x.dtype), idx.shape)
    if reduce == "add":
        return {"Result": x.scatter_add(axis, idx, v)}
    return {"Result": x.scatter(axis, idx, v)}


@register_op("masked_fill")
def _masked_fill(ins, attrs):
    x, mask = ins["X"][0], ins["Mask"][0]
    value = torch.full((), attrs.get("value", 0.0), dtype=x.dtype,
                       device=x.device)
    return {"Out": torch.where(mask.to(torch.bool), value, x)}


@register_op("searchsorted")
def _searchsorted(ins, attrs):
    seq, values = ins["SortedSequence"][0], ins["Values"][0]
    return {"Out": torch.searchsorted(seq.reshape(-1).contiguous(),
                                      values.contiguous(),
                                      right=bool(attrs.get("right", False)))
            .to(torch.int64)}
