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

from .nn_ops import mode_pad
from .registry import register_op
from .rng_ops import device_normal
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


#: (key, device) -> (anchor, tensor): constants a program holds (an
#: `assign_value` or `fill` op's value list, a `shape` op's shape), made
#: on the device once, not on every run, so a captured step reads them
#: without a copy from pageable host memory; a key that holds an
#: object's id keeps the object (its anchor) so the id cannot be reused
_CONST_CACHE = collections.OrderedDict()
_CONST_CACHE_SIZE = 64


def _device_const(key, device, dtype, make, anchor=None):
    """The device tensor of `make()` (a numpy array) in torch dtype
    `dtype`, made once per (key, device)."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(make().shape, dtype=dtype, device=device)
    k = (key, str(device))
    hit = _CONST_CACHE.get(k)
    if hit is None:
        hit = (anchor, torch.tensor(make(), dtype=dtype, device=device))
        _CONST_CACHE[k] = hit
        while len(_CONST_CACHE) > _CONST_CACHE_SIZE:
            _CONST_CACHE.popitem(last=False)
    else:
        _CONST_CACHE.move_to_end(k)
    return hit[1]


@register_op("assign_value")
def _assign_value(ins, attrs):
    """A constant from the program: the attrs' value list
    (`fp32_values`, `int32_values`, `int64_values` or `values`) in
    `shape` and `dtype`."""
    dtype = attrs.get("dtype", "float32")
    shape = tuple(int(d) for d in attrs["shape"])
    values = attrs.get("fp32_values") or attrs.get("int32_values") \
        or attrs.get("int64_values") or attrs.get("values")
    return {"Out": _device_const(
        ("assign_value", id(values), shape, dtype), attrs["_device"],
        to_torch_dtype(dtype),
        lambda: np.asarray(values, to_numpy_dtype(dtype)).reshape(shape),
        anchor=values)}


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


# ---------------------------------------------------------------------------
# The rest of the reference's tensor ops (creation, shape, selection,
# sorting and the host-side ops with value-dependent shapes).
# ---------------------------------------------------------------------------

_INT64 = to_torch_dtype("int64")

def _int_scalar(n, like):
    """An int32 0-d tensor of `n` on `like`'s device (a fill)."""
    return torch.full((), int(n), dtype=_INT64, device=like.device)


def _reshape_rule(x, shape):
    """Paddle's rule: 0 copies the input's dim at that position."""
    shape = [int(d) for d in shape]
    return [x.shape[i] if d == 0 else d for i, d in enumerate(shape)]


@register_op("reshape")
def _reshape(ins, attrs):
    x = ins["X"][0]
    return {"Out": x.reshape(_reshape_rule(x, attrs["shape"]))}


@register_op("transpose")
def _transpose(ins, attrs):
    return {"Out": ins["X"][0].permute(*attrs["axis"])}


def _squeeze_axes(x, axes):
    if not axes:
        return x.squeeze()
    dims = tuple(a % x.ndim for a in axes if x.shape[a % x.ndim] == 1)
    return x.squeeze(dims) if dims else x


@register_op("squeeze")
def _squeeze(ins, attrs):
    return {"Out": _squeeze_axes(ins["X"][0], attrs.get("axes", []))}


@register_op("unsqueeze")
def _unsqueeze(ins, attrs):
    out = ins["X"][0]
    for a in sorted(attrs["axes"]):
        out = out.unsqueeze(a)
    return {"Out": out}


def _flatten_2d(x, axis):
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    return x.reshape(lead, -1)


@register_op("flatten")
def _flatten(ins, attrs):
    """X as [prod(dims before `axis`), the rest]."""
    return {"Out": _flatten_2d(ins["X"][0], attrs.get("axis", 1))}


@register_op("flatten2")
def _flatten2(ins, attrs):
    x = ins["X"][0]
    return {"Out": _flatten_2d(x, attrs.get("axis", 1)),
            "XShape": _xshape(x)}


@register_op("flatten_contiguous_range")
def _flatten_contiguous_range(ins, attrs):
    """The dims `start_axis` to `stop_axis` merged into one."""
    x = ins["X"][0]
    nd = max(x.ndim, 1)
    start = attrs.get("start_axis", 1) % nd
    stop = attrs.get("stop_axis", -1) % nd
    shape = tuple(x.shape[:start]) + (-1,) + tuple(x.shape[stop + 1:])
    return {"Out": x.reshape(shape), "XShape": _xshape(x)}


@register_op("concat")
def _concat(ins, attrs):
    return {"Out": torch.cat(ins["X"], dim=attrs.get("axis", 0))}


@register_op("unstack")
def _unstack(ins, attrs):
    return {"Y": list(ins["X"][0].unbind(attrs.get("axis", 0)))}


@register_op("unbind")
def _unbind(ins, attrs):
    return {"Out": list(ins["X"][0].unbind(attrs.get("axis", 0)))}


def _slice_along(x, axis, start, end, step):
    """`x[start:end:step]` along `axis`, numpy's rules, negative steps
    too (torch slices step forward only: a negative step slices the
    flipped axis)."""
    dim = x.shape[axis]
    idx = range(*slice(start, end, step).indices(dim))
    sl = [slice(None)] * x.ndim
    if len(idx) == 0:
        sl[axis] = slice(0, 0)
        return x[tuple(sl)]
    if step > 0:
        sl[axis] = slice(idx[0], idx[-1] + 1, step)
        return x[tuple(sl)]
    sl[axis] = slice(dim - 1 - idx[0], dim - idx[-1], -step)
    return x.flip(axis)[tuple(sl)]


@register_op("strided_slice")
def _strided_slice(ins, attrs):
    x = ins["Input"][0]
    for a, s, e, st in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                           attrs["strides"]):
        x = _slice_along(x, a, s, e, st)
    return {"Out": x}


def _index_tuple(idx):
    """The index tensor's last dim as a tuple of long index tensors."""
    idx = idx.long()
    return tuple(idx[..., i] for i in range(idx.shape[-1]))


@register_op("gather_nd")
def _gather_nd(ins, attrs):
    """X at the coordinates in Index's last dim (a partial coordinate
    takes the remaining dims whole)."""
    x, idx = ins["X"][0], ins["Index"][0]
    return {"Out": x[_index_tuple(idx)]}


@register_op("scatter_nd_add")
def _scatter_nd_add(ins, attrs):
    x, idx, updates = ins["X"][0], ins["Index"][0], ins["Updates"][0]
    return {"Out": x.index_put(_index_tuple(idx), updates,
                               accumulate=True)}


@register_op("scatter_nd")
def _scatter_nd(ins, attrs):
    """Zeros of `shape` with Updates summed in at Index's coordinates."""
    idx, updates = ins["Index"][0], ins["Updates"][0]
    zeros = torch.zeros(tuple(int(d) for d in attrs["shape"]),
                        dtype=updates.dtype, device=updates.device)
    return {"Out": zeros.index_put(_index_tuple(idx), updates,
                                   accumulate=True)}


@register_op("index_select")
def _index_select(ins, attrs):
    x, idx = ins["X"][0], ins["Index"][0]
    return {"Out": torch.index_select(x, attrs.get("dim", 0) % x.ndim,
                                      idx.long())}


@register_op("index_sample")
def _index_sample(ins, attrs):
    return {"Out": torch.take_along_dim(ins["X"][0], ins["Index"][0].long(),
                                        dim=1)}


@register_op("expand_v2")
def _expand_v2(ins, attrs):
    """X broadcast to `shape` (-1 keeps X's dim; missing leading dims
    are new)."""
    x = ins["X"][0]
    shape = [int(d) for d in attrs["shape"]]
    xs = (1,) * (len(shape) - x.ndim) + tuple(x.shape)
    return {"Out": x.reshape(xs).expand(
        tuple(xs[i] if d == -1 else d for i, d in enumerate(shape)))}


@register_op("expand_as_v2")
def _expand_as_v2(ins, attrs):
    x = ins["X"][0]
    shape = attrs.get("target_shape")
    if shape is None:
        shape = ins["Y"][0].shape
    return {"Out": x.expand(tuple(int(d) for d in shape))}


@register_op("expand_as")
def _expand_as(ins, attrs):
    y = ins["target_tensor"][0] if ins.get("target_tensor") else ins["Y"][0]
    return {"Out": ins["X"][0].expand(tuple(y.shape))}


@register_op("broadcast_to")
def _broadcast_to(ins, attrs):
    return {"Out": ins["X"][0].expand(tuple(int(d) for d in attrs["shape"]))}


@register_op("tile")
def _tile(ins, attrs):
    return {"Out": ins["X"][0].tile(tuple(attrs["repeat_times"]))}


@register_op("flip")
def _flip(ins, attrs):
    return {"Out": torch.flip(ins["X"][0], tuple(attrs["axis"]))}


@register_op("reverse")
def _reverse(ins, attrs):
    axis = attrs.get("axis", [0])
    if isinstance(axis, int):
        axis = [axis]
    return {"Out": torch.flip(ins["X"][0], tuple(axis))}


@register_op("roll")
def _roll(ins, attrs):
    """X rolled by `shifts` along `axis`; with no axis, over the
    flattened X."""
    x = ins["X"][0]
    shifts = attrs["shifts"]
    shifts = list(shifts) if isinstance(shifts, (list, tuple)) else [shifts]
    axis = attrs.get("axis", None)
    if not axis:
        return {"Out": torch.roll(x.reshape(-1), sum(shifts)).reshape(
            x.shape)}
    return {"Out": torch.roll(x, shifts, tuple(axis))}


@register_op("tril_triu")
def _tril_triu(ins, attrs):
    x, diag = ins["X"][0], attrs.get("diagonal", 0)
    return {"Out": torch.tril(x, diag) if attrs.get("lower", True)
            else torch.triu(x, diag)}


@register_op("diag_v2")
def _diag_v2(ins, attrs):
    return {"Out": torch.diag(ins["X"][0], attrs.get("offset", 0))}


@register_op("diag")
def _diag(ins, attrs):
    x = ins["Diagonal"][0] if ins.get("Diagonal") else ins["X"][0]
    return {"Out": torch.diag(x.reshape(-1))}


@register_op("diag_embed")
def _diag_embed(ins, attrs):
    """Each last-dim vector on the `offset` diagonal of an [n, n] plane
    (n its length plus |offset|), the planes then moved to dims `dim1`,
    `dim2` of the result."""
    x = ins["Input"][0] if ins.get("Input") else ins["X"][0]
    d1, d2 = attrs.get("dim1", -2), attrs.get("dim2", -1)
    out = torch.diag_embed(x, offset=attrs.get("offset", 0))
    if (d1, d2) not in ((-2, -1), (x.ndim - 1, x.ndim)):
        out = torch.movedim(out, (-2, -1), (d1, d2))
    return {"Out": out}


@register_op("diagonal")
def _diagonal(ins, attrs):
    x = ins["Input"][0] if ins.get("Input") else ins["X"][0]
    return {"Out": torch.diagonal(x, attrs.get("offset", 0),
                                  attrs.get("axis1", 0),
                                  attrs.get("axis2", 1))}


@register_op("eye")
def _eye(ins, attrs):
    rows = int(attrs["num_rows"])
    cols = int(attrs.get("num_columns", -1))
    return {"Out": torch.eye(rows, cols if cols > 0 else rows,
                             dtype=to_torch_dtype(attrs.get("dtype",
                                                            "float32")),
                             device=attrs["_device"])}


@register_op("fill")
def _fill(ins, attrs):
    """`value` (a list) in `shape` and `dtype`, made on the device once."""
    shape = tuple(int(d) for d in attrs["shape"])
    dtype = attrs.get("dtype", "float32")
    values = attrs["value"]
    return {"Out": _device_const(
        ("fill", id(values), shape, dtype), attrs["_device"],
        to_torch_dtype(dtype),
        lambda: np.asarray(values, np.float64).astype(
            to_numpy_dtype(dtype)).reshape(shape), anchor=values)}


@register_op("fill_any_like")
def _fill_any_like(ins, attrs):
    x = ins["X"][0]
    dtype = attrs.get("dtype", None)
    dt = x.dtype if dtype in (None, -1) else to_torch_dtype(dtype)
    return {"Out": torch.full(tuple(x.shape), attrs.get("value", 0.0),
                              dtype=dt, device=x.device)}


@register_op("fill_zeros_like")
def _fill_zeros_like(ins, attrs):
    return {"Out": torch.zeros_like(ins["X"][0])}


@register_op("fill_zeros_like2")
def _fill_zeros_like2(ins, attrs):
    x = ins["X"][0]
    dtype = attrs.get("dtype")
    return {"Out": torch.zeros(
        tuple(x.shape), dtype=x.dtype if dtype is None
        else to_torch_dtype(dtype), device=x.device)}


@register_op("shape")
def _shape(ins, attrs):
    """X's shape as an int32 vector (a device constant per shape)."""
    x = ins["Input"][0]
    shape = tuple(int(d) for d in x.shape)
    return {"Out": _device_const(("shape", shape), x.device, torch.int32,
                                 lambda: np.asarray(shape, np.int32))}


@register_op("is_empty")
def _is_empty(ins, attrs):
    """[X has no element] (shapes are static: a fill)."""
    x = ins["X"][0]
    return {"Out": torch.full((1,), x.numel() == 0, dtype=torch.bool,
                              device=x.device)}


@register_op("size")
def _size(ins, attrs):
    x = ins["Input"][0] if ins.get("Input") else ins["X"][0]
    return {"Out": _int_scalar(x.numel(), x)}


@register_op("numel")
def _numel(ins, attrs):
    x = ins["Input"][0] if ins.get("Input") else ins["X"][0]
    return {"Out": _int_scalar(x.numel(), x)}


@register_op("rank")
def _rank(ins, attrs):
    x = ins["X"][0]
    return {"Out": torch.full((), x.ndim, dtype=torch.int32,
                              device=x.device)}


@register_op("allclose")
def _allclose(ins, attrs):
    x, y = ins["Input"][0], ins["Other"][0]
    return {"Out": torch.isclose(
        x, y, rtol=float(attrs.get("rtol", 1e-5)),
        atol=float(attrs.get("atol", 1e-8)),
        equal_nan=attrs.get("equal_nan", False)).all()}


@register_op("isclose")
def _isclose(ins, attrs):
    x, y = ins["Input"][0], ins["Other"][0]
    return {"Out": torch.isclose(
        x, y, rtol=float(attrs.get("rtol", 1e-5)),
        atol=float(attrs.get("atol", 1e-8)),
        equal_nan=attrs.get("equal_nan", False))}


def _host_scalar(t):
    """A one-element tensor's value on the host (a synchronization)."""
    return t.reshape(-1)[0].item()


@register_op("linspace")
def _linspace(ins, attrs):
    """`Num` values from Start to Stop (read on the host, as the
    reference reads them)."""
    start = float(_host_scalar(ins["Start"][0]))
    stop = float(_host_scalar(ins["Stop"][0]))
    num = int(_host_scalar(ins["Num"][0]))
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": torch.linspace(start, stop, num, dtype=torch.float32,
                                  device=ins["Start"][0].device).to(dtype)}


@register_op("logspace")
def _logspace(ins, attrs):
    """base ** linspace(start, stop, num)."""
    start = float(_host_scalar(ins["Start"][0])) if ins.get("Start") \
        else float(attrs["start"])
    stop = float(_host_scalar(ins["Stop"][0])) if ins.get("Stop") \
        else float(attrs["stop"])
    num = int(_host_scalar(ins["Num"][0])) if ins.get("Num") \
        else int(attrs["num"])
    device = ins["Start"][0].device if ins.get("Start") \
        else attrs["_device"]
    base = float(attrs.get("base", 10.0))
    return {"Out": torch.pow(base, torch.linspace(
        start, stop, num, dtype=torch.float32, device=device))}


@register_op("range", no_jit=True)
def _range(ins, attrs):
    """[start, end) by step: from the Start, End and Step inputs (read on
    the host: the length depends on their values) in Start's dtype, or
    from attrs (`dtype`, default int64)."""
    if ins.get("Start"):
        start = float(_host_scalar(ins["Start"][0]))
        end = float(_host_scalar(ins["End"][0]))
        step = float(_host_scalar(ins["Step"][0]))
        dtype, device = ins["Start"][0].dtype, ins["Start"][0].device
    else:
        start, end, step = attrs["start"], attrs["end"], attrs["step"]
        dtype = to_torch_dtype(attrs.get("dtype", "int64"))
        device = attrs["_device"]
    return {"Out": torch.arange(start, end, step, dtype=torch.float64,
                                device=device).to(dtype)}


@register_op("crop")
def _crop(ins, attrs):
    """X[offsets : offsets + shape] (offsets from the Offsets input, read
    on the host, else the attr; shape from Y, else the attr)."""
    x = ins["X"][0]
    offsets = attrs.get("offsets")
    if ins.get("Offsets"):
        offsets = [int(v) for v in ins["Offsets"][0].reshape(-1).tolist()]
    shape = attrs.get("shape")
    if ins.get("Y"):
        shape = ins["Y"][0].shape
    starts = offsets or [0] * x.ndim
    return {"Out": x[tuple(slice(int(s), int(s) + int(d))
                           for s, d in zip(starts, shape))]}


@register_op("crop_tensor")
def _crop_tensor(ins, attrs):
    return _crop(ins, attrs)


@register_op("pad_constant_like")
def _pad_constant_like(ins, attrs):
    """Y padded at the end of each dim to X's shape with `pad_value`."""
    x, y = ins["X"][0], ins["Y"][0]
    pads = []
    for xd, yd in reversed(list(zip(x.shape, y.shape))):
        pads += [0, int(xd - yd)]
    return {"Out": torch.nn.functional.pad(
        y, pads, value=float(attrs.get("pad_value", 0.0)))}


_PAD_MODES = {"reflect": "reflect", "replicate": "replicate",
              "circular": "circular"}


@register_op("pad3d")
def _pad3d(ins, attrs):
    """NCDHW X padded by `paddings` [left, right, top, bottom, front,
    back]: a constant, or "reflect", "replicate" or "circular"."""
    x = ins["X"][0]
    p = [int(v) for v in attrs.get("paddings", [0] * 6)]
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return {"Out": torch.nn.functional.pad(
            x, p, value=float(attrs.get("value", 0.0)))}
    return {"Out": mode_pad(x, p, _PAD_MODES[mode])}


@register_op("shard_index")
def _shard_index(ins, attrs):
    """Index within the shard where X's shard (X // shard size) is
    `shard_id`, else `ignore_value`."""
    x = ins["X"][0]
    size = (attrs["index_num"] + attrs["nshards"] - 1) // attrs["nshards"]
    return {"Out": torch.where(x // size == attrs["shard_id"], x % size,
                               torch.full_like(x, attrs.get(
                                   "ignore_value", -1)))}


@register_op("partial_sum")
def _partial_sum(ins, attrs):
    start = attrs.get("start_index", 0)
    length = attrs.get("length", -1)
    xs = ins["X"]
    end = start + length if length > 0 else xs[0].shape[1]
    out = xs[0][:, start:end]
    for x in xs[1:]:
        out = out + x[:, start:end]
    return {"Out": out}


@register_op("partial_concat")
def _partial_concat(ins, attrs):
    start = attrs.get("start_index", 0)
    length = attrs.get("length", -1)
    xs = ins["X"]
    end = start + length if length > 0 else xs[0].shape[1]
    return {"Out": torch.cat([x[:, start:end] for x in xs], dim=1)}


@register_op("meshgrid")
def _meshgrid(ins, attrs):
    return {"Out": list(torch.meshgrid(*ins["X"], indexing="ij"))}


def _to_index(t):
    return t.to(_INT64)


@register_op("arg_max")
def _arg_max(ins, attrs):
    """The first index of the largest value along `axis`."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    return {"Out": _to_index(torch.argmax(
        x, dim=axis, keepdim=bool(attrs.get("keepdims", False))))}


@register_op("arg_min")
def _arg_min(ins, attrs):
    """The first index of the smallest value along `axis` (keepdims is
    not read, as in the reference)."""
    return {"Out": _to_index(torch.argmin(ins["X"][0],
                                          dim=attrs.get("axis", -1)))}


@register_op("argsort")
def _argsort(ins, attrs):
    """A stable sort along `axis` (descending: the stable ascending sort
    of -X, as the reference sorts): the values and their indices."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    key = -x if attrs.get("descending", False) else x
    _, idx = torch.sort(key, dim=axis, stable=True)
    return {"Out": torch.take_along_dim(x, idx, dim=axis),
            "Indices": _to_index(idx)}


@register_op("top_k_v2")
def _top_k_v2(ins, attrs):
    """The k largest (or, `largest` off, smallest) along `axis`, the
    lower index first among equal values."""
    x = ins["X"][0]
    k = attrs.get("k", 1)
    axis = attrs.get("axis", -1) % x.ndim
    largest = attrs.get("largest", True)
    xm = torch.movedim(x, axis, -1)
    if not largest:
        xm = -xm
    vals, idx = torch.sort(xm, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    if not largest:
        vals = -vals
    return {"Out": torch.movedim(vals, -1, axis),
            "Indices": _to_index(torch.movedim(idx, -1, axis))}


@register_op("split_ids")
def _split_ids(ins, attrs):
    """Ids routed to N shards by modulo: each output holds its shard's
    ids first, in order, then zeros (the reference's fixed-size form)."""
    ids = ins["Ids"][0].reshape(-1)
    n = len(ins.get("Out_shapes", [])) or attrs.get("num_shards", 1)
    pos = torch.arange(ids.shape[0], device=ids.device)
    outs = []
    for shard in range(n):
        mask = (ids % n) == shard
        order = torch.sort((~mask).to(torch.int8), stable=True)[1]
        g = ids[order]
        outs.append(torch.where(pos < mask.sum(), g, torch.zeros_like(g)))
    return {"Out": outs}


@register_op("merge_ids")
def _merge_ids(ins, attrs):
    """The rows of every X, taken in the order of their ids."""
    rows = torch.cat([r.reshape(-1) for r in ins["Ids"]])
    vals = torch.cat(list(ins["X"]), dim=0)
    return {"Out": vals[torch.sort(rows, stable=True)[1]]}


@register_op("where_index", no_jit=True, dynamic_shape=True)
def _where_index(ins, attrs):
    """The coordinates of Condition's true elements, [n, ndim]."""
    return {"Out": _to_index(torch.nonzero(ins["Condition"][0]))}


@register_op("masked_select", no_jit=True, dynamic_shape=True)
def _masked_select(ins, attrs):
    return {"Y": ins["X"][0][ins["Mask"][0].bool()]}


def _np_unique(x):
    """numpy's unique of X on the host (the reference's own call)."""
    return np.unique(x.detach().cpu().numpy(), return_index=True,
                     return_inverse=True, return_counts=True)


@register_op("unique", no_jit=True, dynamic_shape=True)
def _unique(ins, attrs):
    """The sorted distinct values, the inverse map (Index), each value's
    first position (Indices) and its count (Counts), found on the host
    with numpy's unique, as the reference finds them."""
    x = ins["X"][0]
    out, first, inverse, counts = _np_unique(x)
    dev = x.device
    return {"Out": torch.as_tensor(out, dtype=x.dtype).to(dev),
            "Index": torch.as_tensor(inverse, dtype=_INT64).to(dev),
            "Indices": torch.as_tensor(first, dtype=_INT64).to(dev),
            "Counts": torch.as_tensor(counts, dtype=_INT64).to(dev)}


@register_op("unique_with_counts", no_jit=True, dynamic_shape=True)
def _unique_with_counts(ins, attrs):
    x = ins["X"][0]
    out, _, inverse, counts = _np_unique(x.reshape(-1))
    dev = x.device
    return {"Out": torch.as_tensor(out, dtype=x.dtype).to(dev),
            "Index": torch.as_tensor(inverse, dtype=_INT64).to(dev),
            "Count": torch.as_tensor(counts, dtype=_INT64).to(dev)}


@register_op("gaussian_random_batch_size_like", rng="device")
def _gaussian_random_bsl(ins, attrs):
    """Normal draws (`mean`, `std`) of `shape` with dim `input_dim_idx`
    taken from Input's, from the op's device seed."""
    ref = ins["Input"][0]
    i = attrs.get("input_dim_idx", 0)
    shape = [int(d) for d in attrs.get("shape", ref.shape)]
    shape[i] = ref.shape[i]
    out = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * device_normal(
        attrs["_rng_seed"], shape)
    return {"Out": out.to(to_torch_dtype(attrs.get("dtype", "float32")))}
