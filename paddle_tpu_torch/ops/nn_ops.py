"""Neural-network operators of the slice (counterpart:
`paddle_tpu/ops/nn_ops.py`): `relu`, `tanh`, `gelu`, `softmax`,
`softmax_with_cross_entropy` (hard labels with `ignore_index`, or soft
labels), `layer_norm`, `dropout`, the embedding lookups and
`scaled_dot_product_attention`.

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
