"""Linear-algebra and extended math operators (counterpart:
`paddle_tpu/ops/linalg_ops.py`): `bmm`, `dot`, `kron`, `cross`, `trace`,
`cholesky`, `inverse`, `matrix_power`, `addmm`, `addcmul`, `logsumexp`,
`bilinear_tensor_product`, `histogram`, `bincount`, `cumprod`, `mv`,
`outer`, `matmul_transpose`, `triangular_solve`, `cholesky_solve`,
`determinant` and `slogdeterminant`. The factorizations and solves are
`torch.linalg`'s (cuSOLVER and cuBLAS on the card). `cholesky`,
`inverse` and `matrix_power` call the `_ex` factorizations, which read
no error flag on the host, so a block holding them is captured; a
matrix that is singular or not positive definite gives non-finite
values, as in the reference.

`histogram` with `min` = `max` = 0 takes its range from the data on the
device (its length is always `bins`). `bincount`'s length is the
largest of `minlength`, 1 and max(X) + 1, read on the host as the
reference's eager op reads it, so a block holding it runs eagerly
(`fluid/lowering.py capture_blocker`); on meta tensors (shape
inference) the length is max(minlength, 1), the reference's traced
answer.
"""
from __future__ import annotations

import torch

from .registry import register_op


def _x(ins):
    return ins["Input"][0] if ins.get("Input") else ins["X"][0]


@register_op("bmm")
def _bmm(ins, attrs):
    return {"Out": torch.matmul(ins["X"][0], ins["Y"][0])}


@register_op("dot")
def _dot(ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": torch.sum(x * y, dim=-1, keepdim=x.ndim == 1)}


@register_op("kron")
def _kron(ins, attrs):
    return {"Out": torch.kron(ins["X"][0], ins["Y"][0])}


@register_op("cross")
def _cross(ins, attrs):
    """The cross product along `dim`; the reference's sentinel 9 means
    the first axis of extent 3."""
    x, y = ins["X"][0], ins["Y"][0]
    axis = attrs.get("dim", attrs.get("axis", 9))
    if axis == 9:
        axis = next(i for i, d in enumerate(x.shape) if d == 3)
    return {"Out": torch.linalg.cross(x, y, dim=axis)}


@register_op("trace")
def _trace(ins, attrs):
    return {"Out": torch.diagonal(
        _x(ins), offset=attrs.get("offset", 0), dim1=attrs.get("axis1", 0),
        dim2=attrs.get("axis2", 1)).sum(-1)}


@register_op("cholesky")
def _cholesky(ins, attrs):
    """The Cholesky factor; a matrix that is not positive definite gets
    NaN below the diagonal, as the reference's factor does (no check
    read on the host)."""
    low, info = torch.linalg.cholesky_ex(ins["X"][0])
    bad = (info != 0)[..., None, None]
    low = torch.where(bad, torch.full_like(low, float("nan")).tril(), low)
    return {"Out": low.transpose(-1, -2) if attrs.get("upper", False)
            else low}


@register_op("inverse")
def _inverse(ins, attrs):
    """The inverse, a singular matrix's non-finite (no check read on
    the host)."""
    return {"Output": torch.linalg.inv_ex(_x(ins)).inverse}


@register_op("matrix_power")
def _matrix_power(ins, attrs):
    """X^n; n < 0 is the inverse's power (no check read on the host)."""
    x, n = ins["X"][0], attrs.get("n", 1)
    if n < 0:
        x, n = torch.linalg.inv_ex(x).inverse, -n
    return {"Out": torch.linalg.matrix_power(x, n)}


@register_op("addmm")
def _addmm(ins, attrs):
    inp, x, y = ins["Input"][0], ins["X"][0], ins["Y"][0]
    alpha = attrs.get("Alpha", attrs.get("alpha", 1.0))
    beta = attrs.get("Beta", attrs.get("beta", 1.0))
    return {"Out": beta * inp + alpha * (x @ y)}


@register_op("addcmul")
def _addcmul(ins, attrs):
    return {"Out": ins["Input"][0] + attrs.get("value", 1.0)
            * ins["Tensor1"][0] * ins["Tensor2"][0]}


@register_op("logsumexp")
def _logsumexp(ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", attrs.get("dim", None))
    if axis in (None, [], ()):
        axis = tuple(range(x.ndim))
    elif isinstance(axis, int):
        axis = (axis,)
    return {"Out": torch.logsumexp(x, dim=tuple(axis),
                                   keepdim=attrs.get("keepdim", False))}


@register_op("bilinear_tensor_product")
def _bilinear_tensor_product(ins, attrs):
    """Out[b, k] = X[b] Weight[k] Y[b]^T (+ Bias)."""
    out = torch.einsum("bi,kij,bj->bk", ins["X"][0], ins["Weight"][0],
                       ins["Y"][0])
    if ins.get("Bias"):
        out = out + ins["Bias"][0]
    return {"Out": out}


@register_op("histogram")
def _histogram(ins, attrs):
    """Counts of X in `bins` equal bins over [min, max] (the data's own
    range where both are 0; a range of one value widened by 0.5 each
    side), the last bin closed, values outside dropped; edges and bins
    as `jnp.histogram` makes them, in X's float dtype (float32 for
    integer X). int64 counts (int32 on the device)."""
    x = ins["X"][0].reshape(-1)
    if not x.is_floating_point():
        x = x.float()
    bins = int(attrs.get("bins", 100))
    lo, hi = attrs.get("min", 0), attrs.get("max", 0)
    if lo == 0 and hi == 0:
        lo, hi = torch.min(x), torch.max(x)
    else:
        lo, hi = (torch.full((), float(v), dtype=x.dtype, device=x.device)
                  for v in (lo, hi))
    same = hi == lo
    lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5, hi)
    step = torch.arange(bins, dtype=x.dtype, device=x.device) / bins
    edges = torch.cat([lo * (1 - step) + hi * step, hi.reshape(1)])
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], bins, idx)
    counts = torch.zeros(bins + 2, dtype=torch.int32,
                         device=x.device).index_add(
        0, idx, torch.ones_like(idx, dtype=torch.int32))
    return {"Out": counts[1:bins + 1]}


@register_op("bincount")
def _bincount(ins, attrs):
    """Counts (or the summed Weights) of each non-negative id in X, of
    length max(minlength, 1, max(X) + 1) (max(X) read on the host)."""
    x = ins["X"][0].reshape(-1).long()
    length = max(attrs.get("minlength", 0), 1)
    if x.device.type != "meta" and x.numel():
        length = max(length, int(x.max()) + 1)
    if ins.get("Weights"):
        w = ins["Weights"][0].reshape(-1)
        return {"Out": torch.zeros(length, dtype=w.dtype,
                                   device=w.device).index_add(0, x, w)}
    return {"Out": torch.zeros(length, dtype=torch.int32,
                               device=x.device).index_add(
        0, x, torch.ones_like(x, dtype=torch.int32))}


class _CumProd(torch.autograd.Function):
    """`torch.cumprod` along `dim` with a gradient that reads nothing on
    the host (torch's own checks X for zeros on the host to pick its
    formula, which a captured step cannot do). dX_k = prod_{j<k} X_j *
    S_k, where S_k = G_k + X_{k+1} S_{k+1} is summed by a
    log2(n)-step scan of the affine maps, with no division, so zeros
    in X need no other path."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        ctx.save_for_backward(x)
        return torch.cumprod(x, dim)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        xs, gs = x.movedim(ctx.dim, -1), g.movedim(ctx.dim, -1)
        n = xs.shape[-1]
        ones = torch.ones_like(xs[..., :1])
        before = torch.cumprod(torch.cat([ones, xs[..., :-1]], -1), -1)
        # S in reverse order: y_r = a_r y_{r-1} + b_r, a_0 = 0
        a = torch.cat([torch.zeros_like(ones), xs[..., 1:].flip(-1)], -1)
        b = gs.flip(-1)
        d = 1
        while d < n:
            b = torch.cat([b[..., :d],
                           b[..., d:] + a[..., d:] * b[..., :-d]], -1)
            a = torch.cat([a[..., :d], a[..., d:] * a[..., :-d]], -1)
            d *= 2
        return (before * b.flip(-1)).movedim(-1, ctx.dim), None


@register_op("cumprod")
def _cumprod(ins, attrs):
    x = ins["X"][0]
    dim = attrs.get("dim", attrs.get("axis", -1)) % max(x.ndim, 1)
    return {"Out": _CumProd.apply(x, dim) if x.requires_grad and x.ndim
            else torch.cumprod(x, dim)}


@register_op("mv")
def _mv(ins, attrs):
    return {"Out": ins["X"][0] @ ins["Vec"][0]}


@register_op("outer")
def _outer(ins, attrs):
    return {"Out": torch.outer(ins["X"][0], ins["Y"][0])}


@register_op("matmul_transpose")
def _matmul_transpose(ins, attrs):
    return {"Out": ins["X"][0] @ ins["Y"][0].transpose(-1, -2)}


@register_op("triangular_solve")
def _triangular_solve(ins, attrs):
    """Solves X Out = Y for triangular X (`upper`), or X^T Out = Y with
    `transpose`; `unitriangular` takes X's diagonal as ones."""
    x, y = ins["X"][0], ins["Y"][0]
    upper = attrs.get("upper", True)
    if attrs.get("transpose", False):
        x, upper = x.transpose(-1, -2), not upper
    return {"Out": torch.linalg.solve_triangular(
        x, y, upper=upper, unitriangular=attrs.get("unitriangular", False))}


@register_op("cholesky_solve")
def _cholesky_solve(ins, attrs):
    """Solves A Out = X, with A's Cholesky factor Y (`upper` or lower):
    two triangular solves, so that only Y's triangle is read (and has a
    gradient), as in the reference's `cho_solve`."""
    x, y = ins["X"][0], ins["Y"][0]
    upper = attrs.get("upper", False)
    z = torch.linalg.solve_triangular(y.transpose(-1, -2) if upper else y,
                                      x, upper=False)
    return {"Out": torch.linalg.solve_triangular(
        y if upper else y.transpose(-1, -2), z, upper=True)}


@register_op("determinant")
def _determinant(ins, attrs):
    return {"Out": torch.linalg.det(_x(ins))}


@register_op("slogdeterminant")
def _slogdeterminant(ins, attrs):
    sign, logdet = torch.linalg.slogdet(_x(ins))
    return {"Out": torch.stack([sign, logdet])}
