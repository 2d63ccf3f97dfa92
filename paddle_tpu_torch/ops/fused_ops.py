"""Fused operators of the slice (counterpart: `paddle_tpu/ops/fused_ops.py`):
`fc`.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register_op


@register_op("fc")
def _fc(ins, attrs):
    """Fused FC (reference: fc_op.h:49): flatten Input at
    in_num_col_dims, matmul W, optional Bias broadcast-add, optional
    relu. padding_weights (a cuDNN alignment layout) is rejected, as in
    the reference."""
    if attrs.get("padding_weights", False):
        raise NotImplementedError(
            "fc padding_weights is a cuDNN alignment layout; store W "
            "unpadded")
    x = ins["Input"][0]
    w = ins["W"][0]
    ncd = int(attrs.get("in_num_col_dims", 1))
    lead = tuple(x.shape[:ncd])
    x2 = x.reshape((-1, int(np.prod(x.shape[ncd:]))
                    if x.ndim > ncd else x.shape[-1]))
    out = x2 @ w
    if ins.get("Bias"):
        out = out + ins["Bias"][0].reshape((1, -1))
    if attrs.get("activation_type", "") == "relu":
        out = torch.relu(out)
    return {"Out": out.reshape(lead + (w.shape[1],))}
