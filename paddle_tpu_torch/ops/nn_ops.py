"""Neural-network operators of the slice (counterpart:
`paddle_tpu/ops/nn_ops.py`): `relu`, `softmax` and
`softmax_with_cross_entropy` (hard labels with `ignore_index`, or soft
labels).

A hard label outside the classes gives the reference's answer without a
host sync or a device-side assert: a negative label counts from the last
class, one beyond the classes a NaN loss, an `ignore_index` label a zero
loss.
"""
from __future__ import annotations

import torch

from .registry import register_op


@register_op("relu")
def _relu(ins, attrs):
    return {"Out": torch.relu(ins["X"][0])}


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
