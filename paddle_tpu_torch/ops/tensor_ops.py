"""Tensor creation / selection operators of the slice (counterpart:
`paddle_tpu/ops/tensor_ops.py`): `fill_constant` and `top_k`.
"""
from __future__ import annotations

import torch

from .registry import register_op
from ..core.types import to_torch_dtype


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
