"""Fake-quantization operators for quantization-aware training and
post-training quantization (counterpart: `paddle_tpu/ops/quant_ops.py`):
`fake_quantize_abs_max`, `fake_quantize_dequantize_abs_max`,
`fake_channel_wise_quantize_abs_max`,
`fake_quantize_moving_average_abs_max`,
`fake_quantize_dequantize_moving_average_abs_max`,
`fake_quantize_range_abs_max`, `fake_dequantize_max_abs`,
`fake_channel_wise_dequantize_max_abs`, `dequantize_abs_max`,
`dequantize_log` and `moving_average_abs_max_scale` (reference:
paddle/fluid/operators/fake_quantize_op.cc, fake_dequantize_op.cc,
dequantize_abs_max_op.cc, dequantize_log_op.cc).

The straight-through estimator is written as the reference writes it,
`x + (q - x).detach()`, so the forward is the reference's bit for bit on
equal inputs (in float32 `x + (q - x)` is not always `q`) and the
gradient is the identity. Rounding is half to even in both packages;
the clip comes before the rescale and the scale is at least 1e-8.

The scale state (`InScale`/`OutScale` of the moving-average types,
`fake_quantize_range_abs_max`'s window `InScales`/`OutScales` and its
`Iter`) comes in as inputs and goes out as new tensors, as
`batch_norm`'s running statistics do, so a captured step updates it on
the device and reads nothing on the host. `is_test` freezes every
stateful type; a `static_scale` attr (post-training quantization)
overrides the dynamic abs-max.
"""
from __future__ import annotations

import torch

from .interp_ops import f32
from .registry import register_op


def _qdq(x, scale, bit_length):
    """Quantize, then dequantize, with the straight-through gradient."""
    bnt = (1 << (bit_length - 1)) - 1
    s = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(x / s * bnt), -bnt, bnt) * s / bnt
    return x + (q - x).detach()


def _abs_max(x):
    return torch.amax(torch.abs(x))


def _ma(in_scale, cur, rate):
    """The moving average of the abs-max, or `cur` at the first step."""
    return torch.where(in_scale > 0,
                       in_scale * f32(rate) + cur * f32(1 - rate), cur)


@register_op("fake_quantize_abs_max")
def _fake_quantize_abs_max(ins, attrs):
    x = ins["X"][0]
    bits = attrs.get("bit_length", 8)
    static = attrs.get("static_scale")
    scale = torch.full((), static, dtype=torch.float32, device=x.device) \
        if static is not None else _abs_max(x)
    return {"Out": _qdq(x, scale, bits), "OutScale": scale.reshape(1)}


@register_op("fake_quantize_dequantize_abs_max")
def _fake_qdq_abs_max(ins, attrs):
    return _fake_quantize_abs_max(ins, attrs)


@register_op("fake_channel_wise_quantize_abs_max")
def _fake_cw_quantize_abs_max(ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("quant_axis", 0)
    red = tuple(i for i in range(x.ndim) if i != axis)
    scale = torch.amax(torch.abs(x), dim=red, keepdim=True)
    return {"Out": _qdq(x, scale, attrs.get("bit_length", 8)),
            "OutScale": scale.reshape(-1)}


@register_op("fake_quantize_moving_average_abs_max")
def _fake_quantize_ma_abs_max(ins, attrs):
    x = ins["X"][0]
    in_scale = ins["InScale"][0].reshape(())
    if attrs.get("is_test", False):
        scale = in_scale
    else:
        scale = _ma(in_scale, _abs_max(x), attrs.get("moving_rate", 0.9))
    return {"Out": _qdq(x, scale, attrs.get("bit_length", 8)),
            "OutScale": scale.reshape(1)}


@register_op("fake_quantize_dequantize_moving_average_abs_max")
def _fake_qdq_ma_abs_max(ins, attrs):
    return _fake_quantize_ma_abs_max(ins, attrs)


@register_op("fake_dequantize_max_abs")
def _fake_dequantize_max_abs(ins, attrs):
    x = ins["X"][0].to(torch.float32)
    scale = ins["Scale"][0].reshape(())
    return {"Out": x * scale / attrs.get("max_range", 127.0)}


@register_op("fake_quantize_range_abs_max")
def _fake_quantize_range_abs_max(ins, attrs):
    """The window-max QAT quantizer (reference: fake_quantize_op.h:157
    FakeQuantizeRangeAbsMaxKernel): slot `Iter % window` of the window
    buffer (`InScales` in, `OutScales` out) takes this batch's abs-max;
    the scale becomes that abs-max where it exceeds the last scale, the
    maximum over the filled slots where the evicted slot held the last
    scale, else stays. The slot is written by comparison with an
    arange, so nothing is read on the host."""
    x = ins["X"][0]
    bits = attrs.get("bit_length", 8)
    in_scale = ins["InScale"][0].reshape(())
    if attrs.get("is_test", False):
        return {"Out": _qdq(x, in_scale, bits),
                "OutScale": in_scale.reshape(1)}
    window = int(attrs.get("window_size", 10000))
    it = ins["Iter"][0].reshape(()).to(torch.int32) if ins.get("Iter") \
        else torch.zeros((), dtype=torch.int32, device=x.device)
    prev = ins["InScales"][0] if ins.get("InScales") \
        else torch.zeros(window, dtype=torch.float32, device=x.device)
    cur = _abs_max(x).to(torch.float32)
    slot = torch.remainder(it, window)
    slots = torch.arange(window, dtype=torch.int32, device=x.device)
    removed = prev.gather(0, slot.long().reshape(1)).reshape(())
    arr = torch.where(slots == slot, cur, prev)
    # the window holds min(it + 1, window) entries, the new one included
    size = torch.clamp(it + 1, 1, window)
    win_max = torch.amax(arr * (slots < size).to(torch.float32))
    scale = torch.where(
        in_scale < cur, cur,
        torch.where(torch.abs(removed - in_scale) < 1e-6, win_max,
                    in_scale))
    return {"Out": _qdq(x, scale, bits), "OutScale": scale.reshape(1),
            "OutScales": arr}


@register_op("fake_channel_wise_dequantize_max_abs")
def _fake_cw_dequantize_max_abs(ins, attrs):
    """One scale tensor: the weight path, a scale per output channel
    (dim 0); two: the activation path, scales along dim 1 times a
    scalar scale (reference: fake_dequantize_op.h:58)."""
    x = ins["X"][0].to(torch.float32)
    scales = ins["Scales"]
    bits = [int(b) for b in attrs.get("quant_bits", [8])]
    if len(scales) == 1:
        bnt = (1 << (bits[0] - 1)) - 1
        return {"Out": x * scales[0].reshape((-1,) + (1,) * (x.ndim - 1))
                / bnt}
    bnt0, bnt1 = ((1 << (b - 1)) - 1 for b in bits[:2])
    s0 = scales[0].reshape((1, -1) + (1,) * (x.ndim - 2))
    return {"Out": x * s0 * scales[1].reshape(()) / (bnt0 * bnt1)}


@register_op("dequantize_abs_max")
def _dequantize_abs_max(ins, attrs):
    """int8 codes to float32 by a scalar scale."""
    x = ins["X"][0].to(torch.float32)
    scale = ins["Scale"][0].reshape(())
    return {"Out": scale * x / attrs.get("max_range", 127.0)}


@register_op("dequantize_log")
def _dequantize_log(ins, attrs):
    """int8 codes to float32 through a 128-entry log dictionary: a
    negative code x reads -Dict[x + 128]."""
    x = ins["X"][0].to(torch.int64)
    table = ins["Dict"][0].reshape(-1)
    last = table.shape[0] - 1
    neg = -table[torch.clamp(x + 128, 0, last)]
    pos = table[torch.clamp(x, 0, last)]
    return {"Out": torch.where(x < 0, neg, pos)}


@register_op("moving_average_abs_max_scale")
def _ma_abs_max_scale(ins, attrs):
    """X passed through; OutScale the moving abs-max (frozen by
    `is_test`)."""
    x = ins["X"][0]
    in_scale = ins["InScale"][0].reshape(()) if ins.get("InScale") \
        else torch.zeros((), dtype=torch.float32, device=x.device)
    if attrs.get("is_test", False):
        return {"Out": x, "OutScale": in_scale.reshape(1)}
    return {"Out": x, "OutScale": _ma(in_scale, _abs_max(x),
                                      attrs.get("moving_rate", 0.9))
            .reshape(1)}
