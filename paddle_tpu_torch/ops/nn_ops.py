"""Neural-network operators of the slice (counterpart:
`paddle_tpu/ops/nn_ops.py`): `relu`, `tanh`, `gelu`, `sign`, `softmax`,
`softmax_with_cross_entropy` (hard labels with `ignore_index`, or soft
labels), `conv2d` / `depthwise_conv2d`, `pool2d`, `batch_norm`,
`layer_norm`, `dropout`, the embedding lookups and
`scaled_dot_product_attention`.

`conv2d` is `F.conv2d` (cuDNN on the card), NCHW input and OIHW filter.
`pool2d` pads as the reference's `lax.reduce_window` does (the left
padding, then on the right exactly what the last window needs, so
`ceil_mode` windows end where the reference's do) and pools the padded
tensor. `batch_norm` keeps Paddle's running-statistics convention, not
PyTorch's: the biased batch variance, `mean_out = mean * momentum +
batch_mean * (1 - momentum)`, `SavedVariance = 1/sqrt(var + eps)`, new
tensors for every output and no gradient through the statistics.

A hard label outside the classes gives the reference's answer without a
host sync or a device-side assert: a negative label counts from the last
class, one beyond the classes a NaN loss, an `ignore_index` label a zero
loss.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register_op
from ..utils.flags import get_flag


@register_op("relu")
def _relu(ins, attrs):
    return {"Out": torch.relu(ins["X"][0])}


@register_op("tanh")
def _tanh(ins, attrs):
    return {"Out": torch.tanh(ins["X"][0])}


@register_op("gelu")
def _gelu(ins, attrs):
    return {"Out": F.gelu(ins["X"][0], approximate="tanh" if attrs.get(
        "approximate", False) else "none")}


@register_op("sign")
def _sign(ins, attrs):
    return {"Out": torch.sign(ins["X"][0])}


@register_op("softmax")
def _softmax(ins, attrs):
    return {"Out": torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))}


@register_op("softmax_with_cross_entropy")
def _softmax_ce(ins, attrs):
    logits, label = ins["Logits"][0], ins["Label"][0]
    axis = attrs.get("axis", -1) % logits.ndim
    softmax = torch.softmax(logits, dim=axis)
    logp = torch.log_softmax(logits, dim=axis)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        idx = label.to(torch.int32)
        if idx.ndim == logits.ndim and idx.shape[axis] == 1:
            idx = idx.squeeze(axis)
        idx = idx.unsqueeze(axis)
        n_cls = logits.shape[axis]
        valid = (idx >= -n_cls) & (idx < n_cls)
        loss = -torch.gather(logp, axis, torch.remainder(idx, n_cls).long())
        loss = loss.masked_fill(~valid, float("nan")).masked_fill(
            idx == attrs.get("ignore_index", -100), 0.0)
    return {"Softmax": softmax, "Loss": loss}


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


@register_op("conv2d")
def _conv2d(ins, attrs):
    """NCHW input, OIHW filter; `paddings` is [ph, pw] or [top, bottom,
    left, right]. The result is in the promoted dtype of the two (under
    AMP both are bf16)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    dt = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(dt), w.to(dt)
    pads = _pair(attrs.get("paddings", [0, 0]))
    if len(pads) == 4 and (pads[0] != pads[1] or pads[2] != pads[3]):
        x = F.pad(x, (pads[2], pads[3], pads[0], pads[1]))
        pads = [0, 0]
    elif len(pads) == 4:
        pads = [pads[0], pads[2]]
    return {"Output": F.conv2d(
        x, w, None, stride=_pair(attrs.get("strides", [1, 1])),
        padding=pads, dilation=_pair(attrs.get("dilations", [1, 1])),
        groups=int(attrs.get("groups", 1)))}


@register_op("depthwise_conv2d")
def _depthwise_conv2d(ins, attrs):
    return _conv2d(ins, attrs)


def _pool_pads(dims, ksize, strides, paddings, ceil_mode):
    """The reference's (left, right) padding of each spatial dim: the
    left is the attr, the right what the last window needs beyond the
    input (`ceil_mode` counts one more window where a partial one
    remains)."""
    pads = []
    for dim, k, s, p in zip(dims, ksize, strides, paddings):
        span = dim + 2 * p - k
        out = (-(-span // s) if ceil_mode else span // s) + 1
        pads.append((p, max(0, (out - 1) * s + k - dim - p)))
    return pads


@register_op("pool2d")
def _pool2d(ins, attrs):
    """max or avg over NCHW windows; `global_pooling` (or adaptive to 1 x
    1) reduces H and W; `adaptive` splits H and W into equal windows;
    otherwise the padded input is pooled with no further padding, and
    an `exclusive` average divides by the window's count of input
    cells."""
    x = ins["X"][0]
    is_max = attrs.get("pooling_type", "max") == "max"
    ksize = _pair(attrs.get("ksize", [2, 2]))
    adaptive = attrs.get("adaptive", False)
    if attrs.get("global_pooling", False) or (
            adaptive and tuple(ksize) == (1, 1)):
        return {"Out": torch.amax(x, dim=(2, 3), keepdim=True) if is_max
                else torch.mean(x, dim=(2, 3), keepdim=True)}
    if adaptive:
        n, c, h, w = x.shape
        oh, ow = ksize
        if h % oh or w % ow:
            raise ValueError("adaptive pool2d needs H and W divisible by "
                             "the output size, got %s and %s"
                             % ((h, w), (oh, ow)))
        xr = x.reshape(n, c, oh, h // oh, ow, w // ow)
        return {"Out": torch.amax(xr, dim=(3, 5)) if is_max
                else torch.mean(xr, dim=(3, 5))}
    strides = _pair(attrs.get("strides", ksize))
    (pt, pb), (pl, pr) = _pool_pads(
        x.shape[2:], ksize, strides, _pair(attrs.get("paddings", [0, 0])),
        attrs.get("ceil_mode", False))
    if is_max:
        xp = F.pad(x, (pl, pr, pt, pb), value=float("-inf"))
        return {"Out": F.max_pool2d(xp, ksize, strides)}
    out = F.avg_pool2d(F.pad(x, (pl, pr, pt, pb)), ksize, strides,
                       divisor_override=1)
    if attrs.get("exclusive", True):
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        cnt = F.avg_pool2d(F.pad(ones, (pl, pr, pt, pb)), ksize, strides,
                           divisor_override=1)
        return {"Out": out / cnt}
    return {"Out": out / float(ksize[0] * ksize[1])}


@register_op("batch_norm")
def _batch_norm(ins, attrs):
    """Batch norm over every axis but the channel's (NCHW: 1; NHWC: the
    last), in float32 whatever X's dtype; Y in X's dtype. Training uses
    the batch's statistics and moves the running ones by Paddle's rule;
    `is_test` or `use_global_stats` normalizes with the running ones and
    passes them through. `fused_act` "relu" applies a relu to Y."""
    x = ins["X"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    use_running = attrs.get("is_test", False) or attrs.get(
        "use_global_stats", False)
    xf = x.float()
    if attrs.get("data_layout", "NCHW") != "NCHW":
        xf = xf.movedim(-1, 1)
    y, bmean, invstd = torch.native_batch_norm(
        xf, ins["Scale"][0].float(), ins["Bias"][0].float(),
        mean.float() if use_running else None,
        var.float() if use_running else None, not use_running, 0.0, eps)
    if attrs.get("data_layout", "NCHW") != "NCHW":
        y = y.movedim(1, -1)
    if attrs.get("fused_act") == "relu":
        y = torch.relu(y)
    with torch.no_grad():
        if use_running:
            saved = (mean, torch.reciprocal(torch.sqrt(var + eps)))
            stats = (mean, var)
        else:
            # the biased variance the normalization used
            bvar = torch.reciprocal(torch.square(invstd)) - eps
            saved = (bmean, invstd)
            stats = (mean * momentum + bmean.to(mean.dtype) * (1 - momentum),
                     var * momentum + bvar.to(var.dtype) * (1 - momentum))
    return {"Y": y.to(x.dtype), "MeanOut": stats[0],
            "VarianceOut": stats[1], "SavedMean": saved[0],
            "SavedVariance": saved[1]}


@register_op("layer_norm")
def _layer_norm(ins, attrs):
    """Normalizes over the axes from begin_norm_axis on, in float32
    whatever x's dtype; Y in x's dtype, Mean and Variance float32 over
    the leading axes."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    norm_shape = tuple(x.shape[begin:])
    scale = ins["Scale"][0].float().reshape(norm_shape) \
        if ins.get("Scale") else None
    bias = ins["Bias"][0].float().reshape(norm_shape) \
        if ins.get("Bias") else None
    y, mean, rstd = torch.native_layer_norm(x.float(), norm_shape, scale,
                                            bias, eps)
    red_shape = tuple(x.shape[:begin])
    with torch.no_grad():
        var = torch.reciprocal(torch.square(rstd)) - eps
    return {"Y": y.to(x.dtype), "Mean": mean.detach().reshape(red_shape),
            "Variance": var.reshape(red_shape)}


def _keep(shape, p, device, generator):
    """Bernoulli(1 - p) keep mask of `shape`, drawn from `generator`."""
    return torch.rand(shape, generator=generator, device=device) >= p


@register_op("dropout", needs_rng=True)
def _dropout(ins, attrs):
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    upscale = attrs.get("dropout_implementation",
                        "downgrade_in_infer") == "upscale_in_train"
    if attrs.get("is_test", False):
        return {"Out": x if upscale else x * (1.0 - p),
                "Mask": torch.ones(x.shape, dtype=torch.uint8,
                                   device=x.device)}
    keep = _keep(x.shape, p, x.device, attrs["_rng_generator"])
    kept = x / (1.0 - p) if upscale else x
    return {"Out": torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                                       device=x.device)),
            "Mask": keep.to(torch.uint8)}


def _lookup(w, ids, padding_idx):
    out = F.embedding(ids, w)
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype,
                                      device=out.device), out)
    return out


@register_op("lookup_table")
def _lookup_table(ins, attrs):
    w, ids = ins["W"][0], ins["Ids"][0]
    # v1 ids carry a trailing [..., 1] dim; squeeze it
    if ids.ndim > 1 and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    return {"Out": _lookup(w, ids, attrs.get("padding_idx", -1))}


@register_op("lookup_table_v2")
def _lookup_table_v2(ins, attrs):
    return {"Out": _lookup(ins["W"][0], ins["Ids"][0],
                           attrs.get("padding_idx", -1))}


@register_op("embedding")
def _embedding(ins, attrs):
    return _lookup_table_v2(ins, attrs)


@register_op("scaled_dot_product_attention", needs_rng=True)
def _sdpa(ins, attrs):
    """Attention over Q, K, V [B, H, S, D] with an optional additive key
    bias KeyBias [B, Sk] or a full Mask (bool: True attends; float:
    added), in the reference's order:

    - on the card, with no Mask and Sk >= FLAGS_flash_attention_min_seq:
      the flash kernels, with dropout inside them (their hash of a seed
      taken on the host from the op's seed, so no device sync);
      ``attrs["flash_impl"] = "reference"`` runs their plain version
      with the same hash instead;
    - with dropout off: `reference_attention` (float32);
    - otherwise the unfused path: float32 scores and softmax, dropout
      on the probabilities, and the probabilities in V's dtype for the
      second product.

    The reference takes the kernel on the TPU only; the port on CUDA."""
    from .kernels.flash_attention import flash_attention, \
        reference_attention

    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    bias = ins["KeyBias"][0] if ins.get("KeyBias") else None
    mask = ins["Mask"][0] if ins.get("Mask") else None
    causal = attrs.get("causal", False)
    sm_scale = attrs.get("sm_scale", None)
    if sm_scale is not None and sm_scale <= 0:
        sm_scale = None
    p_drop = attrs.get("attn_dropout_prob", 0.0)
    drop_active = not attrs.get("is_test", False) and p_drop > 0.0

    if mask is None:
        if q.device.type == "cuda" and k.shape[-2] >= int(
                get_flag("FLAGS_flash_attention_min_seq")):
            seed = (attrs["_rng_seed"] >> 32) & 0x7FFFFFFF \
                if drop_active else None
            return {"Out": flash_attention(
                q, k, v, key_bias=bias, causal=causal, sm_scale=sm_scale,
                dropout_p=p_drop if drop_active else 0.0,
                dropout_seed=seed, impl=attrs.get("flash_impl", "auto"))}
        if not drop_active:
            return {"Out": reference_attention(q, k, v, key_bias=bias,
                                               causal=causal,
                                               sm_scale=sm_scale)}

    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias[:, None, None, :].float()
    if mask is not None:
        # [Sq, Sk] -> [1, 1, Sq, Sk]; [B, Sq, Sk] -> [B, 1, Sq, Sk]
        mask = mask[None, None] if mask.ndim == 2 else (
            mask[:, None] if mask.ndim == 3 else mask)
        s = torch.where(mask, s, torch.full((), -1e30, device=s.device)) \
            if mask.dtype == torch.bool else s + mask.float()
    if causal:
        Sq, Sk = s.shape[-2], s.shape[-1]
        rows = torch.arange(Sq, device=s.device)[:, None]
        cols = torch.arange(Sk, device=s.device)[None, :]
        s = torch.where(rows >= cols, s, torch.full((), -1e30,
                                                    device=s.device))
    probs = torch.softmax(s, dim=-1)
    if drop_active:
        keep = _keep(probs.shape, p_drop, probs.device,
                     attrs["_rng_generator"])
        probs = torch.where(keep, probs / (1.0 - p_drop),
                            torch.zeros((), device=probs.device))
    return {"Out": torch.matmul(probs.to(q.dtype), v).to(q.dtype)}
