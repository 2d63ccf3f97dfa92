"""Specialty operators (counterpart: `paddle_tpu/ops/specialty_ops.py`).

Ported so far: `sync_batch_norm` (`:515`), the batch norm whose moments
are averaged over the data-parallel ring (reference:
sync_batch_norm_op.cu, ncclAllReduce of the moments).
"""
from __future__ import annotations

import torch

from . import collective_ops
from .registry import get_op, register_op
from ..parallel import env as penv


class _AllReduceMean(torch.autograd.Function):
    """The mean over the ring, with the mean over the ring of the
    cotangent as its backward: the transpose of the reference's
    `lax.pmean` inside `shard_map`, so each member's gradient sees every
    member's loss through the shared moments."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return collective_ops.all_reduce_mean(x, ring)

    @staticmethod
    def backward(ctx, g):
        return collective_ops.all_reduce_mean(g, ctx.ring), None


@register_op("sync_batch_norm")
def _sync_batch_norm(ins, attrs):
    """`batch_norm` whose batch mean and mean square are averaged over the
    live data-parallel ring (one all-reduce of both, forward and
    backward). Without an `axis_name` attr, in `is_test` or
    `use_global_stats` mode, or where no ring is live, it is
    `batch_norm`."""
    ring = penv.ring_for(0) if attrs.get("axis_name") else None
    if ring is None or attrs.get("is_test", False) \
            or attrs.get("use_global_stats", False):
        return get_op("batch_norm").compute(ins, attrs)
    x = ins["X"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    caxis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.ndim - 1
    axes = tuple(i for i in range(x.ndim) if i != caxis)
    cshape = [1] * x.ndim
    cshape[caxis] = -1
    f32 = x.float()
    moments = _AllReduceMean.apply(
        torch.cat([f32.mean(axes), f32.square().mean(axes)]), ring)
    bmean, bsq = moments.chunk(2)
    bvar = bsq - bmean.square()
    inv = torch.reciprocal(torch.sqrt(bvar + eps))
    y = ((f32 - bmean.reshape(cshape)) * inv.reshape(cshape)
         * ins["Scale"][0].float().reshape(cshape)
         + ins["Bias"][0].float().reshape(cshape))
    if attrs.get("fused_act") == "relu":
        y = torch.relu(y)
    with torch.no_grad():
        bm, bv = bmean.detach(), bvar.detach()
        mean_out = mean * momentum + bm.to(mean.dtype) * (1 - momentum)
        var_out = var * momentum + bv.to(var.dtype) * (1 - momentum)
    return {"Y": y.to(x.dtype), "MeanOut": mean_out,
            "VarianceOut": var_out, "SavedMean": bm,
            "SavedVariance": inv.detach()}
