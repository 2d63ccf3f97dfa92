"""Flash attention (counterpart: `paddle_tpu/ops/pallas/flash_attention.py`).

Only the plain `reference_attention` is ported so far: the serving
slice's `dense_decode_reference` needs it. The flash forward and its two
backward kernels come with the training slice."""
from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def reference_attention(q, k, v, key_bias=None, causal=False,
                        sm_scale=None):
    """Naive attention over [B, H, S, D] inputs, computed in float32
    (golden reference); returns q's dtype."""
    D = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if key_bias is not None:
        s = s + key_bias[:, None, None, :].float()
    if causal:
        Sq, Sk = s.shape[-2], s.shape[-1]
        rows = torch.arange(Sq, device=s.device)[:, None]
        cols = torch.arange(Sk, device=s.device)[None, :]
        s = torch.where(rows >= cols, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
