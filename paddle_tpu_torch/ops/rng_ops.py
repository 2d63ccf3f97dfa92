"""Random initializer operators of the slice (counterpart:
`paddle_tpu/ops/rng_ops.py`): `uniform_random`, `gaussian_random` and
`truncated_gaussian_random` (a standard normal truncated to [-2, 2],
then scaled and shifted, as the reference draws it).

Each draws from `attrs["_rng_generator"]`, a `torch.Generator` seeded by
the lowering from the program's seed and the op's index
(`core/rng.py`). As in the reference, the op's own `seed` attr is not
read.
"""
from __future__ import annotations

import torch

from .registry import register_op
from ..core.types import to_torch_dtype


def _draw(attrs):
    return torch.empty(tuple(int(d) for d in attrs["shape"]),
                       dtype=torch.float32, device=attrs["_device"])


@register_op("uniform_random", needs_rng=True)
def _uniform_random(ins, attrs):
    out = _draw(attrs).uniform_(attrs.get("min", -1.0),
                                attrs.get("max", 1.0),
                                generator=attrs["_rng_generator"])
    return {"Out": out.to(to_torch_dtype(attrs.get("dtype", "float32")))}


@register_op("gaussian_random", needs_rng=True)
def _gaussian_random(ins, attrs):
    out = _draw(attrs).normal_(attrs.get("mean", 0.0), attrs.get("std", 1.0),
                               generator=attrs["_rng_generator"])
    return {"Out": out.to(to_torch_dtype(attrs.get("dtype", "float32")))}


@register_op("truncated_gaussian_random", needs_rng=True)
def _truncated_gaussian_random(ins, attrs):
    out = torch.nn.init.trunc_normal_(
        _draw(attrs), 0.0, 1.0, -2.0, 2.0,
        generator=attrs["_rng_generator"])
    out = out * attrs.get("std", 1.0) + attrs.get("mean", 0.0)
    return {"Out": out.to(to_torch_dtype(attrs.get("dtype", "float32")))}
