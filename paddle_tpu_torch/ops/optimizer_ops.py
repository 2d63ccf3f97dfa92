"""Optimizer update operators of the slice (counterpart:
`paddle_tpu/ops/optimizer_ops.py`): `sgd`, `momentum` (with Nesterov),
`adam`, and `fused_sgd`, `fused_momentum` and `fused_adam`, each over a
group of parameters as `fluid.fuse_optimizer_ops` plants it.

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


@register_op("momentum")
def _momentum(ins, attrs):
    """v' = mu * v + g; p' = p - lr * v', or with Nesterov
    p' = p - (g + mu * v') * lr (the gradient and lr in p's dtype)."""
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    lr = _lr(ins).to(p.dtype)
    mu = attrs.get("mu", 0.9)
    g = g.to(p.dtype)
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": p_out, "VelocityOut": v_out}


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


@register_op("fused_sgd")
def _fused_sgd(ins, attrs):
    """`sgd` over a group of parameters (`torch._foreach_*`)."""
    ps = ins["Param"]
    lr = _lr(ins).to(ps[0].dtype)
    upd = torch._foreach_mul([g.to(p.dtype) for g, p in zip(ins["Grad"], ps)],
                             lr)
    return {"ParamOut": torch._foreach_sub(ps, upd)}


@register_op("fused_momentum")
def _fused_momentum(ins, attrs):
    """`momentum` over a group of parameters (`torch._foreach_*`; the
    reference concatenates the group into one vector, the arithmetic is
    the same elementwise)."""
    ps = ins["Param"]
    lr = _lr(ins).to(ps[0].dtype)
    mu = attrs.get("mu", 0.9)
    gs = [g.to(p.dtype) for g, p in zip(ins["Grad"], ps)]
    v_out = torch._foreach_mul(ins["Velocity"], mu)
    torch._foreach_add_(v_out, gs)
    if attrs.get("use_nesterov", False):
        upd = torch._foreach_mul(v_out, mu)
        torch._foreach_add_(upd, gs)
    else:
        upd = v_out
    return {"ParamOut": torch._foreach_sub(ps, torch._foreach_mul(upd, lr)),
            "VelocityOut": v_out}


@register_op("fused_adam")
def _fused_adam(ins, attrs):
    """`adam` over a group of parameters with `torch._foreach_*` updates
    (the reference concatenates the group into one vector; the arithmetic
    is the same elementwise). Each parameter keeps its own beta powers,
    so its step size is its own."""
    ps, gs = ins["Param"], ins["Grad"]
    b1ps, b2ps = ins["Beta1Pow"], ins["Beta2Pow"]
    lr = _lr(ins)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    gf = [g.to(torch.float32) for g in gs]
    m1o = torch._foreach_mul(ins["Moment1"], b1)
    torch._foreach_add_(m1o, gf, alpha=1 - b1)
    m2o = torch._foreach_mul(ins["Moment2"], b2)
    torch._foreach_addcmul_(m2o, gf, gf, value=1 - b2)
    b1pf = torch.cat([b.reshape(1) for b in b1ps]).to(torch.float32)
    b2pf = torch.cat([b.reshape(1) for b in b2ps]).to(torch.float32)
    alphas = (lr * torch.sqrt(1 - b2pf * b2) / (1 - b1pf * b1)).unbind(0)
    denom = torch._foreach_sqrt(m2o)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(m1o, denom)
    torch._foreach_mul_(upd, alphas)
    p_out = torch._foreach_sub([p.to(torch.float32) for p in ps], upd)
    return {"ParamOut": [o.to(p.dtype) for o, p in zip(p_out, ps)],
            "Moment1Out": m1o, "Moment2Out": m2o,
            "Beta1PowOut": torch._foreach_mul(b1ps, b1),
            "Beta2PowOut": torch._foreach_mul(b2ps, b2)}
