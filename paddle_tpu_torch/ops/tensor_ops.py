"""Tensor creation / selection operators of the slice (counterpart:
`paddle_tpu/ops/tensor_ops.py`): `fill_constant`,
`fill_constant_batch_size_like`, `top_k`, `assign`, `assign_value`,
`reshape2`, `squeeze2`, `unsqueeze2`, `transpose2`, `stack`, `split`,
`expand`, `slice`, `take_along_axis`, `gather`, `scatter`, `where`,
`cumsum` and `increment`.

`reshape2`, `transpose2` and `slice` return views where torch can make
one, so a head split (`reshape2` then `transpose2` of a slice of the
fused qkv projection) reaches the flash kernels without a copy; as in
the reference, their `XShape` output is an empty [0, *x.shape] tensor.
`take_along_axis`'s gradient is the scatter-add of `torch.gather`'s.
"""
from __future__ import annotations

import torch

import collections

import numpy as np

from .registry import register_op
from ..core.types import to_numpy_dtype, to_torch_dtype


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


@register_op("fill_constant_batch_size_like")
def _fill_constant_bsl(ins, attrs):
    """`fill_constant` whose dim `output_dim_idx` is the Input's dim
    `input_dim_idx` (its batch)."""
    ref = ins["Input"][0]
    shape = [int(d) for d in attrs["shape"]]
    shape[attrs.get("output_dim_idx", 0)] = ref.shape[
        attrs.get("input_dim_idx", 0)]
    return {"Out": torch.full(
        tuple(shape), attrs.get("value", 0.0),
        dtype=to_torch_dtype(attrs.get("dtype", "float32")),
        device=ref.device)}


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


#: (id of the values list, device, dtype) -> (values, tensor): an
#: `assign_value` op's constant is made on the device once, not on every
#: run (the list is kept so its id cannot be reused)
_ASSIGN_VALUE_CACHE = collections.OrderedDict()
_ASSIGN_VALUE_CACHE_SIZE = 64


@register_op("assign_value")
def _assign_value(ins, attrs):
    """A constant from the program: the attrs' value list
    (`fp32_values`, `int32_values`, `int64_values` or `values`) in
    `shape` and `dtype`."""
    dtype = attrs.get("dtype", "float32")
    shape = tuple(int(d) for d in attrs["shape"])
    device = attrs["_device"]
    tdtype = to_torch_dtype(dtype)
    if torch.device(device).type == "meta":
        return {"Out": torch.empty(shape, dtype=tdtype, device=device)}
    values = attrs.get("fp32_values") or attrs.get("int32_values") \
        or attrs.get("int64_values") or attrs.get("values")
    key = (id(values), str(device), dtype)
    hit = _ASSIGN_VALUE_CACHE.get(key)
    if hit is None or hit[0] is not values:
        arr = np.asarray(values, to_numpy_dtype(dtype)).reshape(shape)
        hit = (values, torch.tensor(arr, dtype=tdtype, device=device))
        _ASSIGN_VALUE_CACHE[key] = hit
        while len(_ASSIGN_VALUE_CACHE) > _ASSIGN_VALUE_CACHE_SIZE:
            _ASSIGN_VALUE_CACHE.popitem(last=False)
    else:
        _ASSIGN_VALUE_CACHE.move_to_end(key)
    return {"Out": hit[1]}


@register_op("reshape2")
def _reshape2(ins, attrs):
    x = ins["X"][0]
    shape = [int(d) for d in attrs["shape"]]
    # Paddle's rule: 0 copies the input's dim at that position
    shape = [x.shape[i] if d == 0 else d for i, d in enumerate(shape)]
    return {"Out": x.reshape(shape), "XShape": _xshape(x)}


@register_op("squeeze2")
def _squeeze2(ins, attrs):
    """Drops the size-1 dims among `axes` (every size-1 dim when `axes`
    is empty); a listed dim that is not 1 stays."""
    x = ins["X"][0]
    axes = attrs.get("axes", [])
    if not axes:
        out = x.squeeze()
    else:
        dims = tuple(a % x.ndim for a in axes if x.shape[a % x.ndim] == 1)
        out = x.squeeze(dims) if dims else x
    return {"Out": out, "XShape": _xshape(x)}


@register_op("unsqueeze2")
def _unsqueeze2(ins, attrs):
    """A size-1 dim inserted at each of `axes`, in ascending order."""
    x = ins["X"][0]
    out = x
    for a in sorted(attrs["axes"]):
        out = out.unsqueeze(a)
    return {"Out": out, "XShape": _xshape(x)}


@register_op("transpose2")
def _transpose2(ins, attrs):
    x = ins["X"][0]
    return {"Out": x.permute(*attrs["axis"]), "XShape": _xshape(x)}


@register_op("stack")
def _stack(ins, attrs):
    return {"Y": torch.stack(ins["X"], dim=attrs.get("axis", 0))}


@register_op("split")
def _split(ins, attrs):
    """X split along `axis` into `num` equal parts or the `sections`
    sizes."""
    x = ins["X"][0]
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        return {"Out": list(torch.split(x, list(sections), dim=axis))}
    return {"Out": list(torch.chunk(x, attrs.get("num", 0), dim=axis))}


@register_op("expand")
def _expand(ins, attrs):
    """X tiled `expand_times` along each axis."""
    return {"Out": ins["X"][0].repeat(*attrs["expand_times"])}


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


@register_op("where")
def _where(ins, attrs):
    return {"Out": torch.where(ins["Condition"][0], ins["X"][0],
                               ins["Y"][0])}


@register_op("increment")
def _increment(ins, attrs):
    """X + `step`, the step taken in X's dtype first (an integer counter
    truncates it)."""
    x = ins["X"][0]
    step = attrs.get("step", 1.0)
    step = float(torch.tensor(step, dtype=x.dtype)) \
        if x.is_floating_point() else int(step)
    return {"Out": x + step}


@register_op("cumsum")
def _cumsum(ins, attrs):
    """Running sums along `axis` (over the flattened X with `flatten`);
    `exclusive` leaves out each element itself; `reverse` sums from the
    end (and then, as in the reference, is never exclusive)."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    if attrs.get("flatten", False):
        x = x.reshape(-1)
        axis = 0
    if attrs.get("reverse", False):
        return {"Out": torch.flip(torch.cumsum(
            torch.flip(x, (axis,)), dim=axis, dtype=x.dtype), (axis,))}
    # in X's dtype (torch widens integer sums to int64 otherwise)
    out = torch.cumsum(x, dim=axis, dtype=x.dtype)
    if attrs.get("exclusive", False):
        out = out - x
    return {"Out": out}
