"""Optimizer update operators of the slice (counterpart:
`paddle_tpu/ops/optimizer_ops.py`): `sgd` and `adam`.

Param/Grad/<state> inputs, ParamOut/<state>Out outputs. Each update is
functional: it returns new tensors and the lowering rebinds the names
(ParamOut names the same var as Param), so no tensor that autograd saved
is changed in place.
"""
from __future__ import annotations

import torch

from .registry import register_op


def _lr(ins):
    return ins["LearningRate"][0].reshape(()).to(torch.float32)


@register_op("sgd")
def _sgd(ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = _lr(ins).to(p.dtype)
    return {"ParamOut": p - lr * g.to(p.dtype)}


@register_op("adam")
def _adam(ins, attrs):
    """The reference's Adam: alpha = lr * sqrt(1 - b2p * b2) /
    (1 - b1p * b1), with the beta powers of after this step."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    lr = _lr(ins)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    gf = g.to(torch.float32)
    m1o = b1 * m1 + (1 - b1) * gf
    m2o = b2 * m2 + (1 - b2) * torch.square(gf)
    b1pf = b1p.reshape(()).to(torch.float32)
    b2pf = b2p.reshape(()).to(torch.float32)
    alpha = lr * torch.sqrt(1 - b2pf * b2) / (1 - b1pf * b1)
    p_out = p.to(torch.float32) - alpha * m1o / (torch.sqrt(m2o) + eps)
    return {"ParamOut": p_out.to(p.dtype), "Moment1Out": m1o,
            "Moment2Out": m2o, "Beta1PowOut": b1p * b1,
            "Beta2PowOut": b2p * b2}
