"""Fused operators of the slice (counterpart: `paddle_tpu/ops/fused_ops.py`):
`fc` and `fused_linear_softmax_xent`.
"""
from __future__ import annotations

import math

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


def _mm32(a, b):
    """``a @ b`` of two operands of one dtype, accumulated and returned in
    float32 (the reference's ``preferred_element_type``): on the card a
    bfloat16 product goes through cuBLAS with a float32 output; on the
    CPU the operands are widened first (bfloat16 products are exact in
    float32)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunk_logits(x2, w, bias, start, chunk):
    """float32 logits of vocab columns [start, start + chunk)."""
    logits = _mm32(x2, w[:, start:start + chunk])
    return logits if bias is None else logits + bias[start:start + chunk]


class _LinearSoftmaxXent(torch.autograd.Function):
    """Per-row ``lse(x w + b) - (x w + b)[label]`` over vocab chunks with
    an online logsumexp. Only x, w, b, the labels and the [N] lse are
    kept for the backward, which recomputes each chunk's logits, so the
    [N, V] logits never exist. The last chunk is narrower where V is not
    a multiple of the chunk: the same sums as the reference's padded
    columns of bias -1e30, whose exp is exactly 0."""

    @staticmethod
    def forward(ctx, x2, w, bias, lbl, chunk):
        n, vocab = x2.shape[0], w.shape[1]
        f32 = dict(dtype=torch.float32, device=x2.device)
        m = torch.full((n,), -math.inf, **f32)
        s = torch.zeros((n,), **f32)
        picked = torch.zeros((n,), **f32)
        for start in range(0, vocab, chunk):
            logits = _chunk_logits(x2, w, bias, start, chunk)
            cm = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - cm) + torch.exp(
                logits - cm[:, None]).sum(dim=-1)
            m = cm
            rel = lbl - start
            inside = (rel >= 0) & (rel < logits.shape[1])
            pick = logits.gather(1, rel.clamp(0, logits.shape[1] - 1)
                                 .long()[:, None])[:, 0]
            picked = picked + torch.where(inside, pick, 0.0)
        lse = m + torch.log(s)
        ctx.save_for_backward(x2, w, bias, lbl, lse)
        ctx.chunk = chunk
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        x2, w, bias, lbl, lse = ctx.saved_tensors
        chunk = ctx.chunk
        dx = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
        dw = torch.empty_like(w)
        db = None if bias is None else torch.empty_like(bias)
        g = g.float()
        for start in range(0, w.shape[1], chunk):
            logits = _chunk_logits(x2, w, bias, start, chunk)
            width = logits.shape[1]
            # d loss / d logits = g (softmax - onehot(label))
            dlog = torch.exp(logits - lse[:, None])
            rel = lbl.long() - start
            inside = (rel >= 0) & (rel < width)
            dlog.scatter_add_(1, rel.clamp(0, width - 1)[:, None],
                              -inside.float()[:, None])
            dlog = dlog * g[:, None]
            if db is not None:
                db[start:start + width] = dlog.sum(dim=0).to(db.dtype)
            dlog = dlog.to(x2.dtype)
            dx += _mm32(dlog, w[:, start:start + width].t())
            dw[:, start:start + width] = _mm32(x2.t(), dlog).to(w.dtype)
        return dx.to(x2.dtype), dw, db, None, None


@register_op("fused_linear_softmax_xent")
def _fused_linear_softmax_xent(ins, attrs):
    """Classifier head fused with softmax cross-entropy: Loss [..., 1] =
    -log softmax(X W + Bias)[Label], float32, streamed over vocab chunks
    of ``chunk_size`` (`_LinearSoftmaxXent`). The chunk products take
    X's and W's dtype (bfloat16 under AMP) and accumulate in float32."""
    x, w = ins["X"][0], ins["W"][0]
    bias = ins["Bias"][0].float() if ins.get("Bias") else None
    lead = tuple(x.shape[:-1])
    chunk = min(int(attrs.get("chunk_size", 8192)), w.shape[1])
    loss = _LinearSoftmaxXent.apply(x.reshape(-1, x.shape[-1]), w, bias,
                                    ins["Label"][0].reshape(-1), chunk)
    return {"Loss": loss.reshape(lead + (1,))}
