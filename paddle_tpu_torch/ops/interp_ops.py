"""Interpolation (resize) operators (counterpart:
`paddle_tpu/ops/interp_ops.py`): `linear_interp`, `bilinear_interp`,
`trilinear_interp`, `bicubic_interp` and `nearest_interp`, with the
reference's `align_corners` / `align_mode` source-index rules:

- align_corners=True:          src = dst * (in - 1) / (out - 1)
- align_corners=False, mode 0: src = (dst + 0.5) * in / out - 0.5
- align_corners=False, mode 1: src = dst * in / out
- nearest, align_corners:      floor(dst * (in - 1) / (out - 1) + 0.5)
- nearest otherwise:           floor(dst * in / out)
- bicubic: the half-pixel rule when align_corners is off, a = -0.75.

Each resize is a separable per-axis gather plus a weighted sum. The
source coordinates are computed in float32 on X's device, as the
reference computes them (each ratio rounded to float32 first), so the
rows at the edges are the reference's; `F.interpolate`'s rules differ.
The output sizes are static (attrs `out_d`/`out_h`/`out_w`, else
`scale`) and nothing is read on the host. Every gather's gradient is
summed in a fixed order (`take`): an accumulating `index_put_` under
PyTorch's deterministic algorithms, never atomics.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register_op
from ..core.place import deterministic_algorithms


def f32(v):
    """A Python number rounded to float32, as JAX rounds a weakly typed
    scalar that meets a float32 array."""
    return float(np.float32(v))


def consts(values, device, dtype=torch.float32):
    """A 1-D tensor of Python numbers (each rounded to float32 first) on
    `device`, made by fills: nothing is copied from the host, so a CUDA
    graph captures it."""
    return torch.stack([torch.full((), f32(v), dtype=dtype, device=device)
                        for v in values])


class _SortedTake(torch.autograd.Function):
    """`index_select` along `axis` whose gradient is summed into each
    source row in a fixed order (an accumulating `index_put_` under
    PyTorch's deterministic algorithms: sort the indices, then sum). The
    default backward adds with atomics on the card, so two runs of a
    gather that repeats a row differ in the last bits."""

    @staticmethod
    def forward(ctx, x, idx, axis):
        ctx.save_for_backward(idx)
        ctx.axis, ctx.shape = axis, x.shape
        return x.index_select(axis, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        moved = g.movedim(ctx.axis, 0)
        gx = g.new_zeros((ctx.shape[ctx.axis],) + tuple(moved.shape[1:]))
        with deterministic_algorithms():
            gx.index_put_((idx,), moved, accumulate=True)
        return gx.movedim(0, ctx.axis), None, None


def take(x, idx, axis):
    """x gathered at the long indices `idx` along `axis`, its gradient
    summed in a fixed order."""
    if x.requires_grad:
        return _SortedTake.apply(x, idx, axis)
    return x.index_select(axis, idx)


def _arange(n, x):
    return torch.arange(n, dtype=torch.float32, device=x.device)


def _src_index(x, out_size, in_size, align_corners, align_mode):
    """Fractional source coordinates for one axis (linear family);
    out_size 1 gives ratio 0 (source 0), as the reference."""
    i = _arange(out_size, x)
    if out_size <= 1:
        return torch.zeros_like(i)
    if align_corners:
        src = i * f32((in_size - 1.0) / (out_size - 1.0))
    elif align_mode == 1:
        src = i * f32(in_size / out_size)
    else:
        src = (i + 0.5) * f32(in_size / out_size) - 0.5
    return src.clamp(0.0, in_size - 1.0)


def _bcast(v, ndim, axis, dtype):
    shape = [1] * ndim
    shape[axis] = -1
    return v.to(dtype).reshape(shape)


def _linear_axis(x, axis, out_size, align_corners, align_mode):
    in_size = x.shape[axis]
    src = _src_index(x, out_size, in_size, align_corners, align_mode)
    i0 = torch.floor(src).long()
    i1 = torch.clamp(i0 + 1, max=in_size - 1)
    w1 = src - i0
    w0 = 1.0 - w1
    return (take(x, i0, axis) * _bcast(w0, x.ndim, axis, x.dtype)
            + take(x, i1, axis) * _bcast(w1, x.ndim, axis, x.dtype))


def _cubic_weight(t):
    """The cubic convolution kernel, a = -0.75."""
    a = -0.75
    t = t.abs()
    inner = ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0
    outer = ((a * t - 5.0 * a) * t + 8.0 * a) * t - 4.0 * a
    return torch.where(t <= 1.0, inner,
                       torch.where(t < 2.0, outer, torch.zeros_like(t)))


def _cubic_axis(x, axis, out_size, align_corners):
    in_size = x.shape[axis]
    i = _arange(out_size, x)
    if out_size <= 1:
        src = torch.zeros_like(i)
    elif align_corners:
        src = i * f32((in_size - 1.0) / (out_size - 1.0))
    else:
        src = (i + 0.5) * f32(in_size / out_size) - 0.5
    i0 = torch.floor(src).long()
    frac = src - i0
    out = 0.0
    for k in range(-1, 3):
        idx = torch.clamp(i0 + k, 0, in_size - 1)
        w = _bcast(_cubic_weight(frac - k), x.ndim, axis, x.dtype)
        out = out + take(x, idx, axis) * w
    return out


def _nearest_axis(x, axis, out_size, align_corners):
    in_size = x.shape[axis]
    i = _arange(out_size, x)
    if out_size <= 1:
        idx = torch.zeros_like(i)
    elif align_corners:
        # Paddle rounds half up: static_cast<int>(ratio * k + 0.5)
        idx = torch.floor(i * f32((in_size - 1.0) / (out_size - 1.0))
                          + 0.5)
    else:
        idx = torch.floor(i * f32(in_size / out_size))
    return take(x, idx.long().clamp(0, in_size - 1), axis)


def _layout_axes(x, attrs, n_spatial):
    """The spatial axes and the requested output sizes for NCX / NXC
    layouts."""
    channel_last = attrs.get("data_layout", "NCHW") in ("NHWC", "NDHWC",
                                                        "NWC")
    first = 1 if channel_last else 2
    axes = list(range(first, first + n_spatial))
    keys = {1: ["out_w"], 2: ["out_h", "out_w"],
            3: ["out_d", "out_h", "out_w"]}[n_spatial]
    scale = attrs.get("scale", 0.0)
    sizes = []
    for key, ax in zip(keys, axes):
        out = int(attrs.get(key, -1) or -1)
        if out <= 0:
            if not scale or scale <= 0:
                raise ValueError(
                    "interp op needs %s or a positive scale attr" % key)
            out = int(x.shape[ax] * scale)
        sizes.append(out)
    return axes, sizes


def _linear_family(ins, attrs, n_spatial):
    x = ins["X"][0]
    axes, sizes = _layout_axes(x, attrs, n_spatial)
    ac = bool(attrs.get("align_corners", True))
    am = int(attrs.get("align_mode", 1))
    for ax, size in zip(axes, sizes):
        x = _linear_axis(x, ax, size, ac, am)
    return {"Out": x}


@register_op("linear_interp")
def _linear_interp(ins, attrs):
    return _linear_family(ins, attrs, 1)


@register_op("bilinear_interp")
def _bilinear_interp(ins, attrs):
    return _linear_family(ins, attrs, 2)


@register_op("trilinear_interp")
def _trilinear_interp(ins, attrs):
    return _linear_family(ins, attrs, 3)


@register_op("bicubic_interp")
def _bicubic_interp(ins, attrs):
    x = ins["X"][0]
    axes, sizes = _layout_axes(x, attrs, 2)
    ac = bool(attrs.get("align_corners", True))
    for ax, size in zip(axes, sizes):
        x = _cubic_axis(x, ax, size, ac)
    return {"Out": x}


@register_op("nearest_interp")
def _nearest_interp(ins, attrs):
    x = ins["X"][0]
    axes, sizes = _layout_axes(x, attrs, 2)
    ac = bool(attrs.get("align_corners", True))
    for ax, size in zip(axes, sizes):
        x = _nearest_axis(x, ax, size, ac)
    return {"Out": x}
