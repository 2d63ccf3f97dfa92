"""Tensor creation / selection operators of the slice (counterpart:
`paddle_tpu/ops/tensor_ops.py`): `fill_constant`, `top_k`, `assign`,
`reshape2`, `transpose2`, `slice`, `take_along_axis`, `gather` and
`scatter`.

`reshape2`, `transpose2` and `slice` return views where torch can make
one, so a head split (`reshape2` then `transpose2` of a slice of the
fused qkv projection) reaches the flash kernels without a copy; as in
the reference, their `XShape` output is an empty [0, *x.shape] tensor.
`take_along_axis`'s gradient is the scatter-add of `torch.gather`'s.
"""
from __future__ import annotations

import torch

from .registry import register_op
from ..core.types import to_torch_dtype


@register_op("fill_constant")
def _fill_constant(ins, attrs):
    shape = attrs.get("shape", [1])
    value = attrs.get("value", 0.0)
    if isinstance(value, str):
        value = float(value)
    return {"Out": torch.full(
        tuple(int(d) for d in shape), value,
        dtype=to_torch_dtype(attrs.get("dtype", "float32")),
        device=attrs["_device"])}


@register_op("top_k")
def _top_k(ins, attrs):
    """The k largest along the last axis, the lower index first among
    equal values (as `jax.lax.top_k`): a stable descending sort, where
    `torch.topk` promises no order among ties."""
    x = ins["X"][0]
    k = attrs.get("k", 1)
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return {"Out": vals[..., :k],
            "Indices": idx[..., :k].to(to_torch_dtype("int64"))}


def _xshape(x):
    return torch.empty((0,) + tuple(x.shape), dtype=x.dtype,
                       device=x.device)


@register_op("assign")
def _assign(ins, attrs):
    return {"Out": ins["X"][0]}


@register_op("reshape2")
def _reshape2(ins, attrs):
    x = ins["X"][0]
    shape = [int(d) for d in attrs["shape"]]
    # Paddle's rule: 0 copies the input's dim at that position
    shape = [x.shape[i] if d == 0 else d for i, d in enumerate(shape)]
    return {"Out": x.reshape(shape), "XShape": _xshape(x)}


@register_op("transpose2")
def _transpose2(ins, attrs):
    x = ins["X"][0]
    return {"Out": x.permute(*attrs["axis"]), "XShape": _xshape(x)}


@register_op("slice")
def _slice(ins, attrs):
    x = ins["Input"][0]
    idx = [slice(None)] * x.ndim
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    out = x[tuple(idx)]
    for a in sorted(attrs.get("decrease_axis", []), reverse=True):
        out = out.squeeze(a)
    return {"Out": out}


@register_op("take_along_axis")
def _take_along_axis(ins, attrs):
    x, idx = ins["Input"][0], ins["Index"][0]
    return {"Result": torch.take_along_dim(x, idx.long(),
                                           dim=attrs.get("Axis", 0))}


@register_op("gather")
def _gather(ins, attrs):
    """The slices of X along `axis` at Index's positions, Index's shape
    in place of that axis (`numpy.take`)."""
    x, idx = ins["X"][0], ins["Index"][0]
    axis = attrs.get("axis", 0) % x.ndim
    out = torch.index_select(x, axis, idx.reshape(-1).long())
    return {"Out": out.reshape(x.shape[:axis] + idx.shape
                               + x.shape[axis + 1:])}


@register_op("scatter")
def _scatter(ins, attrs):
    """X with the rows at Ids replaced by (`overwrite`) or increased by
    the rows of Updates, as a new tensor."""
    x, ids, updates = ins["X"][0], ins["Ids"][0], ins["Updates"][0]
    ids = ids.reshape(-1).long()
    if attrs.get("overwrite", True):
        return {"Out": x.index_copy(0, ids, updates)}
    return {"Out": x.index_add(0, ids, updates)}
