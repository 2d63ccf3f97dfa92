"""Metric operators of the slice (counterpart:
`paddle_tpu/ops/metric_ops.py`): `accuracy`.
"""
from __future__ import annotations

import torch

from .registry import register_op


@register_op("accuracy")
def _accuracy(ins, attrs):
    # reference: metrics/accuracy_op.cc — inputs Out (topk values),
    # Indices (topk indices [N,k]), Label [N,1]
    indices = ins["Indices"][0]
    label = ins["Label"][0].reshape((-1, 1)).to(indices.dtype)
    correct_row = torch.any(indices == label, dim=1)
    num_correct = torch.sum(correct_row.to(torch.int32)).to(torch.int32)
    total = indices.shape[0]
    acc = (num_correct.to(torch.float32) / total).reshape((1,))
    return {"Accuracy": acc,
            "Correct": num_correct.reshape((1,)),
            "Total": torch.full((1,), total, dtype=torch.int32,
                                device=indices.device)}
