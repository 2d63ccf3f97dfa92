"""Sequence operators over padded [batch, time, ...] tensors with an
optional Length input (counterpart: `paddle_tpu/ops/sequence_ops.py`):
`sequence_mask`, `sequence_pool`, `sequence_softmax`, `sequence_expand`,
`sequence_reshape`, `sequence_concat`, `sequence_reverse`,
`sequence_pad`, `sequence_unpad`, `sequence_slice`, `sequence_erase`,
`sequence_expand_as`, `sequence_enumerate`, `sequence_conv`,
`sequence_scatter`, `lod_reset`, `sequence_number_count` and
`ctc_align`.

Paddle's sequence ops take LoDTensors (ragged rows); here, as in the
reference, a batch is dense padding plus a Length vector, turned into a
mask on the device, so every op but `ctc_align` (host numpy, `no_jit`,
as the reference's) is captured with its block. `sequence_slice` and
`sequence_erase` compact the kept steps to the front with a stable sort
on the device. `sequence_scatter` sums its updates in a fixed order
(`core/selected_rows.py ordered_row_sum`), so two runs and a captured
replay agree bit for bit.

Where the reference departs from Paddle the port follows the reference
(ROADMAP Queue 3, reference-side): `sequence_mask` with a negative
`maxlen` is [B, B] (the reference takes `x.shape[0]` for any array),
`sequence_conv` ignores Length (padded steps enter the context window),
and `sequence_pool`'s MaxIndex is zeros.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register_op
from ..core.selected_rows import ordered_row_sum
from ..core.types import from_numpy, to_numpy, to_torch_dtype


def _mask(x, ins, time_axis=1):
    """[B, T] bool: step t of row b is within Length[b], or None."""
    if not ins.get("Length"):
        return None
    length = ins["Length"][0].reshape(-1)
    t = x.shape[time_axis]
    return torch.arange(t, device=x.device)[None, :] < length[:, None]


def _trail(m, x):
    """`m` [B, T] reshaped to broadcast over x's trailing dims."""
    return m.reshape(tuple(m.shape) + (1,) * (x.ndim - 2))


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


@register_op("sequence_mask")
def _sequence_mask(ins, attrs):
    x = ins["X"][0].reshape(-1)
    maxlen = attrs.get("maxlen", -1)
    if maxlen < 0:
        # the reference's rule for any device array (its `.aval` branch)
        maxlen = x.shape[0]
    dtype = to_torch_dtype(attrs.get("out_dtype", "int64"))
    out = torch.arange(maxlen, device=x.device)[None, :] < x[:, None]
    return {"Y": out.to(dtype)}


@register_op("sequence_pool")
def _sequence_pool(ins, attrs):
    """padded [B, T, D] (+ Length) -> pooled [B, D]."""
    x = ins["X"][0]
    ptype = attrs.get("pooltype", "SUM").upper()
    m = _mask(x, ins)
    if m is not None:
        mf = m.to(x.dtype)[..., None]
        x_masked = x * mf
        denom = torch.clamp_min(torch.sum(mf, dim=1), 1.0)
    else:
        x_masked = x
        denom = torch.full((), x.shape[1], dtype=x.dtype, device=x.device)
    if ptype == "SUM":
        out = torch.sum(x_masked, dim=1)
    elif ptype in ("AVERAGE", "MEAN"):
        out = torch.sum(x_masked, dim=1) / denom
    elif ptype == "MAX":
        neg = torch.finfo(x.dtype).min if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        xm = torch.where(m[..., None], x, torch.full(
            (), neg, dtype=x.dtype, device=x.device)) if m is not None \
            else x
        out = torch.amax(xm, dim=1)
    elif ptype == "SQRT":
        out = torch.sum(x_masked, dim=1) / torch.sqrt(denom)
    elif ptype == "LAST":
        if m is not None:
            idx = torch.clamp_min(torch.sum(m.to(torch.int32), dim=1) - 1, 0)
            out = torch.take_along_dim(
                x, idx[:, None, None].to(torch.int64), dim=1)[:, 0]
        else:
            out = x[:, -1]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        # reference InEnum (sequence_pool_op.cc:69); layers.sequence_pool
        # already validates at construction, this backstops direct use
        raise ValueError("sequence_pool: unknown pooltype %r" % (ptype,))
    return {"Out": out, "MaxIndex": torch.zeros(
        tuple(out.shape), dtype=torch.int32, device=x.device)}


@register_op("sequence_softmax")
def _sequence_softmax(ins, attrs):
    x = ins["X"][0]
    m = _mask(x, ins)
    if m is None:
        e = torch.exp(x)
        return {"Out": e / torch.sum(e, dim=1, keepdim=True)}
    xm = torch.where(m, x, torch.full((), torch.finfo(x.dtype).min,
                                      dtype=x.dtype, device=x.device))
    e = torch.exp(xm - torch.amax(xm, dim=1, keepdim=True))
    e = torch.where(m, e, _zero(e))
    return {"Out": e / torch.clamp_min(torch.sum(e, dim=1, keepdim=True),
                                       1e-9)}


@register_op("sequence_expand")
def _sequence_expand(ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    reps = y.shape[1] if y.ndim > 1 else 1
    return {"Out": torch.repeat_interleave(x, reps, dim=0)}


@register_op("sequence_reshape")
def _sequence_reshape(ins, attrs):
    return {"Out": ins["X"][0].reshape(-1, attrs["new_dim"])}


@register_op("sequence_concat")
def _sequence_concat(ins, attrs):
    return {"Out": torch.cat(list(ins["X"]), dim=1)}


@register_op("sequence_reverse")
def _sequence_reverse(ins, attrs):
    """Each row's first Length[b] steps reversed, the padding in place."""
    x = ins["X"][0]
    m = _mask(x, ins)
    if m is None:
        return {"Y": torch.flip(x, dims=(1,))}
    length = torch.sum(m.to(torch.int32), dim=1)
    idx = torch.arange(x.shape[1], device=x.device)[None, :]
    rev = torch.where(idx < length[:, None], length[:, None] - 1 - idx, idx)
    return {"Y": torch.take_along_dim(x, _trail(rev, x).to(torch.int64),
                                      dim=1)}


@register_op("sequence_pad")
def _sequence_pad(ins, attrs):
    """The padded layout already: the padding set to PadValue, and the
    lengths (T for every row without Length)."""
    x = ins["X"][0]
    m = _mask(x, ins)
    pad_value = ins["PadValue"][0].reshape(()).to(x.dtype) \
        if ins.get("PadValue") else _zero(x)
    if m is None:
        return {"Out": x, "Length": torch.full(
            (x.shape[0],), x.shape[1], dtype=to_torch_dtype("int64"),
            device=x.device)}
    return {"Out": torch.where(_trail(m, x), x, pad_value),
            "Length": torch.sum(m, dim=1, dtype=to_torch_dtype("int64"))}


@register_op("sequence_unpad")
def _sequence_unpad(ins, attrs):
    """The padded layout kept (static shapes), the tail zeroed."""
    x = ins["X"][0]
    length = ins["Length"][0].reshape(-1)
    m = torch.arange(x.shape[1], device=x.device)[None, :] < length[:, None]
    return {"Out": torch.where(_trail(m, x), x, _zero(x))}


def _to_front(x, keep):
    """The steps of each row where `keep`, moved to the front in order
    (a stable sort on the device), and the rest after them."""
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True)[1]
    return torch.take_along_dim(x, _trail(order, x), dim=1)


@register_op("sequence_slice")
def _sequence_slice(ins, attrs):
    """Row b's steps [Offset[b], Offset[b] + Length[b]) at the front, the
    rest zeros."""
    x = ins["X"][0]
    offset = ins["Offset"][0].reshape(-1)
    length = ins["Length"][0].reshape(-1)
    idx = torch.arange(x.shape[1], device=x.device)[None, :]
    sel = (idx >= offset[:, None]) & (idx < (offset + length)[:, None])
    keep = idx < length[:, None]
    return {"Out": torch.where(_trail(keep, x), _to_front(x, sel),
                               _zero(x))}


@register_op("sequence_erase")
def _sequence_erase(ins, attrs):
    """The steps not in `tokens`, compacted to the front; their count."""
    x = ins["X"][0]
    keep = torch.ones(tuple(x.shape), dtype=torch.bool, device=x.device)
    for tok in attrs.get("tokens", []):
        keep = keep & (x != tok)
    count = torch.sum(keep, dim=1, dtype=torch.int32)
    m = torch.arange(x.shape[1], device=x.device)[None, :] < count[:, None]
    return {"Out": torch.where(m, _to_front(x, keep), _zero(x)),
            "Length": count.to(to_torch_dtype("int64"))}


@register_op("sequence_expand_as")
def _sequence_expand_as(ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": torch.repeat_interleave(x, y.shape[0] // x.shape[0],
                                           dim=0)}


@register_op("sequence_enumerate")
def _sequence_enumerate(ins, attrs):
    """[N, T] -> [N, T, win]: step t's window t .. t + win - 1, past the
    end `pad_value`."""
    x = ins["X"][0]
    win = attrs.get("win_size", 2)
    t = x.shape[-1] if x.ndim > 1 else x.shape[0]
    x2 = x.reshape(-1, t)
    pad = torch.full((x2.shape[0], win), attrs.get("pad_value", 0),
                     dtype=x.dtype, device=x.device)
    xp = torch.cat([x2, pad], dim=1)
    return {"Out": torch.stack([xp[:, i:i + t] for i in range(win)],
                               dim=-1)}


@register_op("sequence_conv")
def _sequence_conv(ins, attrs):
    """The context-window convolution over time (reference:
    sequence_conv_op.cc): steps contextStart .. contextStart +
    contextLength - 1 around each step, zeros past either end,
    concatenated and multiplied by Filter [contextLength * D, F]."""
    x, filt = ins["X"][0], ins["Filter"][0]
    ctx_len = attrs.get("contextLength", 3)
    ctx_start = attrs.get("contextStart", -(ctx_len // 2))
    b, t, d = x.shape
    cols = []
    for i in range(ctx_len):
        off = ctx_start + i
        if off < 0:
            cols.append(torch.cat([x.new_zeros((b, min(-off, t), d)),
                                   x[:, :max(t + off, 0)]], dim=1))
        elif off > 0:
            cols.append(torch.cat([x[:, min(off, t):],
                                   x.new_zeros((b, min(off, t), d))], dim=1))
        else:
            cols.append(x)
    return {"Out": torch.matmul(torch.cat(cols, dim=-1), filt)}


@register_op("sequence_scatter")
def _sequence_scatter(ins, attrs):
    """X with the rows of Updates added at Ids, summed in a fixed
    order."""
    x, ids, updates = ins["X"][0], ins["Ids"][0], ins["Updates"][0]
    return {"Out": ordered_row_sum(x, ids.reshape(-1),
                                   updates.reshape((-1,) + tuple(x.shape[1:])))}


@register_op("lod_reset")
def _lod_reset(ins, attrs):
    # LoD is host metadata (core/lod.py); the data passes through
    return {"Out": ins["X"][0]}


@register_op("sequence_number_count")
def _sequence_number_count(ins, attrs):
    x = ins["X"][0]
    return {"Out": torch.full((), x.numel(), dtype=to_torch_dtype("int64"),
                              device=x.device)}


@register_op("ctc_align", no_jit=True)
def _ctc_align(ins, attrs):
    """CTC decode alignment: merge repeats, then drop blanks (reference:
    operators/ctc_align_op.cc), on the host; the ragged output compacted
    to rows padded with `padding_value`."""
    x = to_numpy(ins["Input"][0])
    blank = attrs.get("blank", 0)
    merge = attrs.get("merge_repeated", True)
    out = np.full_like(x, attrs.get("padding_value", 0))
    in_len = to_numpy(ins["InputLength"][0]).reshape(-1) \
        if ins.get("InputLength") else np.full((x.shape[0],), x.shape[1])
    lengths = np.zeros((x.shape[0],), np.int64)
    for b in range(x.shape[0]):
        prev, k = None, 0
        for t in x[b, :int(in_len[b])]:
            t = int(t)
            if merge and prev == t:
                continue
            prev = t
            if t != blank:
                out[b, k] = t
                k += 1
        lengths[b] = k
    dev = attrs["_device"]
    return {"Output": from_numpy(out, dev),
            "OutputLength": from_numpy(lengths.reshape(-1, 1), dev)}
