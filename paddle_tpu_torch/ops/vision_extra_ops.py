"""Vision extras (counterpart: `paddle_tpu/ops/vision_extra_ops.py`):
`unpool`, `max_pool3d_with_index`, `depthwise_conv2d_transpose`,
`conv_shift`, `deformable_conv` and `deformable_conv_v1`, `prroi_pool`,
`psroi_pool` and `bilateral_slice` (reference: paddle/fluid/operators/
unpool_op.cc, max_pool_with_index_op.cc, conv_transpose_op.cc,
conv_shift_op.cc, deformable_conv_op.cc, deformable_conv_v1_op.cc,
detection/prroi_pool_op.cc, psroi_pool_op.cc, bilateral_slice_op.cc).

Everything stays dense and statically shaped, as in the reference, and
nothing is read on the host. Every gather on a differentiable path sums
its gradient in a fixed order (`interp_ops.take`, an accumulating
`index_put_` under PyTorch's deterministic algorithms): the four
bilinear taps of `bilinear_taps` (deformable convolution, and
`detection_extra_ops`' deformable PSRoI pooling and perspective
transform), the trilinear taps of `bilateral_slice`, `conv_shift`'s
circular gather, and the per-RoI image gather of the RoI pools. The
bilinear sampler zeroes the taps that fall outside the map and clamps
their indices, as the reference's `_bilinear_sample_nchw`.

`unpool` scatters X into zeros at Indices. Duplicate indices (which
`max_pool2d_with_index` gives overlapping windows that share a maximum)
carry one value, so the forward does not depend on which write lands;
each X cell's gradient is the output gradient at its index, every
duplicate included, as Paddle's Unpool2dMaxGradFunctor gives it (the
reference's `.at[].set` gives it to one duplicate only: ROADMAP Queue 3,
reference-side). `max_pool3d_with_index` pads with -inf, gives the first
maximum of a window on a tie and shares Out's gradient among tied cells
(as `jnp.max`); its Mask is the flat (d * H + h) * W + w index in the
unpadded input, int64 narrowed to int32. `depthwise_conv2d_transpose`
is `F.conv_transpose2d` with groups = C (cuDNN, deterministic under
`FLAGS_cudnn_deterministic`). `prroi_pool` is the closed-form integral of
the bilinear hat over each bin, with a 1e-6 floor on the bin size;
`psroi_pool` rounds the RoI before scaling and takes masked means with a
count floor of 1. Their RoIs map to images through `BatchRoINums` or
`RoisNum`, else all to image 0 (`roi_batch_ids`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .interp_ops import take
from .registry import register_op
from ..core.types import to_torch_dtype


def _pair(v):
    return [int(v)] * 2 if isinstance(v, int) else [int(a) for a in v]


@register_op("unpool")
def _unpool(ins, attrs):
    """X [N, C, h, w] written into zeros [N, C, oh, ow] at Indices (flat
    positions within each plane)."""
    x, idx = ins["X"][0], ins["Indices"][0]
    oh, ow = int(attrs["unpooled_height"]), int(attrs["unpooled_width"])
    n, c = x.shape[:2]
    flat = idx.reshape(n, c, -1).to(torch.int64)
    return {"Out": _Unpool.apply(x.reshape(n, c, -1), flat,
                                 oh * ow).reshape(n, c, oh, ow)}


class _Unpool(torch.autograd.Function):
    """The scatter-set of `unpool`, whose gradient is the gather of the
    output gradient at each index (a gather: no atomics)."""

    @staticmethod
    def forward(ctx, x, idx, size):
        ctx.save_for_backward(idx)
        return x.new_zeros(tuple(x.shape[:2]) + (size,)).scatter_(2, idx, x)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return torch.gather(g, 2, idx), None, None


@register_op("max_pool3d_with_index")
def _max_pool3d_with_index(ins, attrs):
    x = ins["X"][0]
    kd, kh, kw = (int(k) for k in attrs.get("ksize", [2, 2, 2]))
    sd, sh, sw = (int(s) for s in attrs.get("strides", [kd, kh, kw]))
    pd, ph, pw = (int(p) for p in attrs.get("paddings", [0, 0, 0]))
    h, w = x.shape[3], x.shape[4]
    xp = F.pad(x, (pw, pw, ph, ph, pd, pd), value=float("-inf"))
    # [n, c, od, oh, ow, kd * kh * kw]
    wins = xp.unfold(2, kd, sd).unfold(3, kh, sh).unfold(4, kw, sw) \
        .flatten(-3)
    amax = torch.argmax(wins, dim=-1)
    od, oh, ow = wins.shape[2:5]
    dev = x.device
    d0 = (torch.arange(od, device=dev) * sd - pd)[:, None, None]
    h0 = (torch.arange(oh, device=dev) * sh - ph)[None, :, None]
    w0 = (torch.arange(ow, device=dev) * sw - pw)[None, None, :]
    rd = torch.div(amax, kh * kw, rounding_mode="floor") + d0
    rh = torch.remainder(torch.div(amax, kw, rounding_mode="floor"),
                         kh) + h0
    rw = torch.remainder(amax, kw) + w0
    mask = (rd * h + rh) * w + rw
    return {"Out": torch.amax(wins, dim=-1),
            "Mask": mask.to(to_torch_dtype("int64"))}


@register_op("depthwise_conv2d_transpose")
def _depthwise_conv2d_transpose(ins, attrs):
    """Transposed convolution with groups = C, filter [C, 1, kh, kw]."""
    x, w = ins["Input"][0], ins["Filter"][0]
    return {"Output": F.conv_transpose2d(
        x, w, stride=_pair(attrs.get("strides", [1, 1])),
        padding=_pair(attrs.get("paddings", [0, 0])),
        dilation=_pair(attrs.get("dilations", [1, 1])),
        groups=x.shape[1])}


@register_op("conv_shift")
def _conv_shift(ins, attrs):
    """Circular correlation: X [B, N], Y [B, M] (M odd),
    out[b, j] = sum_k X[b, (j + k - M // 2) mod N] * Y[b, k]."""
    x, y = ins["X"][0], ins["Y"][0]
    b, n = x.shape
    m = y.shape[1]
    k = torch.arange(m, device=x.device) - m // 2
    idx = torch.remainder(torch.arange(n, device=x.device)[:, None]
                          + k[None, :], n)
    cols = take(x, idx.reshape(-1), 1).reshape(b, n, m)
    return {"Out": torch.einsum("bnm,bm->bn", cols, y)}


def bilinear_taps(py, px, h, w):
    """The four taps of bilinear sampling at the fractional points (py,
    px) of an h x w map, in the reference's order: (flat index y * w + x
    with y and x clamped into the map, weight; a tap outside the map
    weighs 0)."""
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = py - y0, px - x0
    zero = torch.zeros((), dtype=py.dtype, device=py.device)
    for dy, wyy in ((0, 1.0 - wy), (1, wy)):
        for dx, wxx in ((0, 1.0 - wx), (1, wx)):
            yy = (y0 + dy).to(torch.int64)
            xx = (x0 + dx).to(torch.int64)
            valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            yield (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1),
                   torch.where(valid, wyy * wxx, zero))


def bilinear_sample(x, py, px, batch=None):
    """x [B, C, H, W] sampled at the fractional points (py, px) [R, ...],
    row r of them on image `batch[r]` (r itself without `batch`):
    [R, C, ...] (`bilinear_taps`). One row gather a tap (x laid out
    [B*H*W, C]), its gradient summed in a fixed order; the taps summed
    in the reference's order."""
    b, c, h, w = x.shape
    rows = x.permute(0, 2, 3, 1).reshape(b * h * w, c)
    r, lead = py.shape[0], tuple(py.shape[1:])
    if batch is None:
        batch = torch.arange(r, device=x.device)
    base = (batch * (h * w)).reshape((r,) + (1,) * len(lead))
    out = None
    for idx, wt in bilinear_taps(py, px, h, w):
        v = take(rows, (base + idx).reshape(-1), 0).reshape(
            (r,) + lead + (c,))
        term = v * wt[..., None]
        out = term if out is None else out + term
    return out.movedim(-1, 1)


def _deformable_conv(ins, attrs, modulated):
    x, offset, weight = ins["Input"][0], ins["Offset"][0], ins["Filter"][0]
    mask = ins["Mask"][0] if (modulated and ins.get("Mask")) else None
    stride = _pair(attrs.get("strides", [1, 1]))
    pad = _pair(attrs.get("paddings", [0, 0]))
    dil = _pair(attrs.get("dilations", [1, 1]))
    groups = int(attrs.get("groups", 1))
    dg = int(attrs.get("deformable_groups", 1))
    n, c, h, w = x.shape
    cout, c_g, kh, kw = weight.shape
    k = kh * kw
    ho = (h + 2 * pad[0] - (dil[0] * (kh - 1) + 1)) // stride[0] + 1
    wo = (w + 2 * pad[1] - (dil[1] * (kw - 1) + 1)) // stride[1] + 1
    dev, dt = x.device, x.dtype
    off = offset.reshape(n, dg, k, 2, ho, wo)
    base_y = (torch.arange(ho, device=dev) * stride[0] - pad[0]).to(dt)
    base_x = (torch.arange(wo, device=dev) * stride[1] - pad[1]).to(dt)
    kk = torch.arange(k, device=dev)
    ky = (torch.div(kk, kw, rounding_mode="floor") * dil[0]).to(dt)
    kx = (torch.remainder(kk, kw) * dil[1]).to(dt)
    py = base_y[None, :, None] + ky[:, None, None] + off[:, :, :, 0]
    px = base_x[None, None, :] + kx[:, None, None] + off[:, :, :, 1]
    # [n * dg, c / dg, K, ho, wo]
    cols = bilinear_sample(x.reshape(n * dg, c // dg, h, w),
                           py.reshape(n * dg, k, ho, wo),
                           px.reshape(n * dg, k, ho, wo))
    if mask is not None:
        cols = cols * mask.reshape(n * dg, 1, k, ho, wo)
    wg = weight.reshape(groups, cout // groups, c_g * k)
    colsg = cols.reshape(n, groups, c_g * k, ho, wo)
    out = torch.einsum("gok,ngkhw->ngohw", wg, colsg)
    return {"Output": out.reshape(n, cout, ho, wo)}


@register_op("deformable_conv")
def _deformable_conv_v2(ins, attrs):
    """Modulated deformable convolution: Offset [N, dg * K * 2, ho, wo]
    laid out [dg, K, (y, x)], Mask [N, dg * K, ho, wo] multiplying the
    sampled columns, one grouped einsum."""
    return _deformable_conv(ins, attrs, modulated=True)


@register_op("deformable_conv_v1")
def _deformable_conv_v1(ins, attrs):
    return _deformable_conv(ins, attrs, modulated=False)


def roi_batch_ids(ins, n_rois, device):
    """The image of each RoI from the per-image counts in `BatchRoINums`
    or `RoisNum` (reference prroi_pool_op.h:282-289); with neither,
    image 0 for all."""
    counts = next((ins[s][0].reshape(-1) for s in ("BatchRoINums",
                                                   "RoisNum")
                   if ins.get(s)), None)
    if counts is None:
        return torch.zeros((n_rois,), dtype=torch.int64, device=device)
    bounds = torch.cumsum(counts.to(torch.int64), 0)
    return (torch.arange(n_rois, device=device)[:, None]
            >= bounds[None, :]).sum(1)


def _hat_integral(lo, hi, p):
    """The integral of max(0, 1 - |t - p|) over [lo, hi], closed form."""
    def anti(t):
        t = t.clamp(-1.0, 1.0)
        return torch.where(t >= 0, t - 0.5 * t * t, t + 0.5 * t * t)

    return anti(hi - p) - anti(lo - p)


@register_op("prroi_pool")
def _prroi_pool(ins, attrs):
    """Precise RoI pooling: the exact integral of the bilinearly
    interpolated map over each bin, divided by the bin's area."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = float(attrs.get("spatial_scale", 1.0))
    n, c, h, w = x.shape
    r = rois.shape[0]
    feat = take(x, roi_batch_ids(ins, r, x.device), 0)      # [R, C, H, W]
    x1, y1 = rois[:, 0] * scale, rois[:, 1] * scale
    x2, y2 = rois[:, 2] * scale, rois[:, 3] * scale
    floor = torch.full((), 1e-6, dtype=x.dtype, device=x.device)
    bw = torch.maximum((x2 - x1) / pw, floor)
    bh = torch.maximum((y2 - y1) / ph, floor)
    i = torch.arange(ph, dtype=x.dtype, device=x.device)
    j = torch.arange(pw, dtype=x.dtype, device=x.device)
    y_lo = y1[:, None] + i[None, :] * bh[:, None]            # [R, ph]
    x_lo = x1[:, None] + j[None, :] * bw[:, None]
    gy = torch.arange(h, dtype=x.dtype, device=x.device)
    gx = torch.arange(w, dtype=x.dtype, device=x.device)
    wy = _hat_integral(y_lo[..., None], (y_lo + bh[:, None])[..., None],
                       gy)                                   # [R, ph, H]
    wx = _hat_integral(x_lo[..., None], (x_lo + bw[:, None])[..., None],
                       gx)                                   # [R, pw, W]
    out = torch.einsum("rih,rjw,rchw->rcij", wy, wx, feat)
    return {"Out": out / (bw * bh)[:, None, None, None]}


@register_op("psroi_pool")
def _psroi_pool(ins, attrs):
    """Position-sensitive RoI pooling: X has output_channels * ph * pw
    channels; bin (i, j) of output channel k averages channel (k, i, j)
    over its cells (floor and ceil bin edges, count floor 1)."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    out_c = int(attrs["output_channels"])
    scale = float(attrs.get("spatial_scale", 1.0))
    n, c, h, w = x.shape
    r = rois.shape[0]
    dt, dev = x.dtype, x.device
    feat = take(x, roi_batch_ids(ins, r, dev), 0).reshape(
        r, out_c, ph, pw, h, w)
    x1 = torch.round(rois[:, 0]) * scale
    y1 = torch.round(rois[:, 1]) * scale
    x2 = torch.round(rois[:, 2] + 1.0) * scale
    y2 = torch.round(rois[:, 3] + 1.0) * scale
    floor = torch.full((), 0.1, dtype=dt, device=dev)
    bw = torch.maximum(x2 - x1, floor) / pw
    bh = torch.maximum(y2 - y1, floor) / ph
    i = torch.arange(ph, dtype=dt, device=dev)
    j = torch.arange(pw, dtype=dt, device=dev)
    hs = torch.floor(y1[:, None] + i * bh[:, None])
    he = torch.ceil(y1[:, None] + (i + 1.0) * bh[:, None])
    ws = torch.floor(x1[:, None] + j * bw[:, None])
    we = torch.ceil(x1[:, None] + (j + 1.0) * bw[:, None])
    ys = torch.arange(h, dtype=dt, device=dev)
    xs = torch.arange(w, dtype=dt, device=dev)
    my = ((ys >= hs[..., None]) & (ys < he[..., None])).to(dt)   # [R,ph,H]
    mx = ((xs >= ws[..., None]) & (xs < we[..., None])).to(dt)   # [R,pw,W]
    s = torch.einsum("rih,rjw,rkijhw->rkij", my, mx, feat)
    cnt = torch.clamp(my.sum(2)[:, :, None] * mx.sum(2)[:, None, :],
                      min=1.0)
    return {"Out": s / cnt[:, None]}


@register_op("bilateral_slice")
def _bilateral_slice(ins, attrs):
    """HDRNet's bilateral slicing: the affine coefficients of Grid
    [N, gc, gd, gh, gw] sampled trilinearly at (guide, y, x) (indices
    clamped, each tap weighted max(0, 1 - |d|)) and applied to X."""
    x, grid, guide = ins["X"][0], ins["Grid"][0], ins["Guide"][0]
    has_offset = bool(attrs.get("has_offset", False))
    n, c_in, h, w = x.shape
    _, gc, gd, gh, gw = grid.shape
    stride = c_in + 1 if has_offset else c_in
    c_out = gc // stride
    dt, dev = x.dtype, x.device
    gy = (torch.arange(h, dtype=dt, device=dev) + 0.5) * gh / h - 0.5
    gx = (torch.arange(w, dtype=dt, device=dev) + 0.5) * gw / w - 0.5
    z = guide * gd - 0.5                                     # [N, H, W]
    y = gy[:, None].expand(h, w)
    xg = gx[None, :].expand(h, w)
    rows = grid.permute(0, 2, 3, 4, 1).reshape(n * gd * gh * gw, gc)
    base = (torch.arange(n, device=dev) * (gd * gh * gw))[:, None, None]
    z0, y0, x0 = torch.floor(z), torch.floor(y), torch.floor(xg)
    zero = torch.zeros((), dtype=dt, device=dev)
    acc = None
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                zz = torch.clamp(z0 + dz, 0, gd - 1).to(torch.int64)
                yy = torch.clamp(y0 + dy, 0, gh - 1).to(torch.int64)
                xx = torch.clamp(x0 + dx, 0, gw - 1).to(torch.int64)
                wgt = (torch.maximum(zero, 1.0 - torch.abs(z - (z0 + dz)))
                       * torch.maximum(zero,
                                       1.0 - torch.abs(y - (y0 + dy)))
                       * torch.maximum(zero,
                                       1.0 - torch.abs(xg - (x0 + dx))))
                flat = base + (zz * gh + yy) * gw + xx       # [N, H, W]
                v = take(rows, flat.reshape(-1), 0).reshape(n, h, w, gc)
                term = v * wgt[..., None]
                acc = term if acc is None else acc + term
    co = acc.permute(0, 3, 1, 2).reshape(n, c_out, stride, h, w)
    out = torch.einsum("nochw,nchw->nohw", co[:, :, :c_in], x)
    if has_offset:
        out = out + co[:, :, c_in]
    return {"Out": out}
