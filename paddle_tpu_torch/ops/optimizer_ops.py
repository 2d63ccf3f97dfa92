"""Optimizer update operators (counterpart:
`paddle_tpu/ops/optimizer_ops.py`, all of it): `sgd`, `momentum` (with
Nesterov), `lars_momentum`, `adam`, `adamw`, `adamax`, `adagrad`,
`decayed_adagrad`, `adadelta`, `rmsprop` (centered or not), `ftrl`,
`lamb`, `dpsgd`, `proximal_gd`, `proximal_adagrad`, `lookahead_step`,
`average_accumulates` (ModelAverage's window), `dgc_momentum`,
`dgc_clip_by_norm`, and `fused_sgd`, `fused_momentum` and `fused_adam`,
each over a group of parameters as `fluid.fuse_optimizer_ops` plants it.

Param/Grad/<state> inputs, ParamOut/<state>Out outputs. Each update is
functional: it returns new tensors and the lowering rebinds the names
(ParamOut names the same var as Param), so no tensor that autograd saved
is changed in place. The state machines (`lookahead_step`,
`average_accumulates`, the DGC ramp-up) select with `torch.where` on
device values, never on the host, so every op runs inside a captured
CUDA graph. `dpsgd`'s Gaussian noise comes from the op's device seed
(`core/rng.py keep_hash` and a Box-Muller transform), not from JAX's
stream: the two packages agree on it only in distribution.
"""
from __future__ import annotations

import math

import torch

from .registry import register_op
from ..core.rng import keep_hash


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


@register_op("lars_momentum")
def _lars_momentum(ins, attrs):
    """Momentum with a layer-wise learning rate: lr * coeff * ||p|| /
    (||g|| + wd ||p|| + eps) where both norms are positive, else lr."""
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    lr = _lr(ins)
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    wd = attrs.get("lars_weight_decay", 0.0005)
    eps = attrs.get("epsilon", 0.0)
    pf, gf = p.to(torch.float32), g.to(torch.float32)
    p_norm = torch.sqrt(torch.sum(torch.square(pf)))
    g_norm = torch.sqrt(torch.sum(torch.square(gf)))
    local_lr = torch.where((p_norm > 0) & (g_norm > 0),
                           lr * coeff * p_norm / (g_norm + wd * p_norm + eps),
                           lr)
    v_out = mu * v.to(torch.float32) + local_lr * (gf + wd * pf)
    return {"ParamOut": (pf - v_out).to(p.dtype),
            "VelocityOut": v_out.to(v.dtype)}


@register_op("adamw")
def _adamw(ins, attrs):
    """Adam, then (with `with_decay`) p -= lr * coeff * p_before."""
    coeff = attrs.get("coeff", attrs.get("weight_decay", 0.01))
    outs = _adam(ins, attrs)
    if attrs.get("with_decay", True):
        p = ins["Param"][0]
        decayed = outs["ParamOut"].to(torch.float32) \
            - _lr(ins) * coeff * p.to(torch.float32)
        outs["ParamOut"] = decayed.to(p.dtype)
    return outs


@register_op("adamax")
def _adamax(ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m, n = ins["Moment"][0], ins["InfNorm"][0]
    b1p = ins["Beta1Pow"][0].reshape(()).to(torch.float32)
    lr = _lr(ins)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    gf = g.to(torch.float32)
    m_out = b1 * m + (1 - b1) * gf
    n_out = torch.maximum(b2 * n, torch.abs(gf))
    p_out = p.to(torch.float32) - (lr / (1 - b1p)) * (m_out / (n_out + eps))
    return {"ParamOut": p_out.to(p.dtype), "MomentOut": m_out,
            "InfNormOut": n_out}


@register_op("adagrad")
def _adagrad(ins, attrs):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    eps = attrs.get("epsilon", 1e-6)
    gf = g.to(torch.float32)
    m_out = m + torch.square(gf)
    p_out = p.to(torch.float32) - _lr(ins) * gf / (torch.sqrt(m_out) + eps)
    return {"ParamOut": p_out.to(p.dtype), "MomentOut": m_out}


@register_op("decayed_adagrad")
def _decayed_adagrad(ins, attrs):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    gf = g.to(torch.float32)
    m_out = decay * m + (1 - decay) * torch.square(gf)
    p_out = p.to(torch.float32) - _lr(ins) * gf / (torch.sqrt(m_out) + eps)
    return {"ParamOut": p_out.to(p.dtype), "MomentOut": m_out}


@register_op("adadelta")
def _adadelta(ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    avg_g, avg_u = ins["AvgSquaredGrad"][0], ins["AvgSquaredUpdate"][0]
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    gf = g.to(torch.float32)
    g_acc = rho * avg_g + (1 - rho) * torch.square(gf)
    update = -torch.sqrt((avg_u + eps) / (g_acc + eps)) * gf
    u_acc = rho * avg_u + (1 - rho) * torch.square(update)
    return {"ParamOut": (p.to(torch.float32) + update).to(p.dtype),
            "AvgSquaredGradOut": g_acc, "AvgSquaredUpdateOut": u_acc}


@register_op("rmsprop")
def _rmsprop(ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    gf = g.to(torch.float32)
    ms_out = rho * ms + (1 - rho) * torch.square(gf)
    outs = {"MeanSquareOut": ms_out}
    if attrs.get("centered", False):
        mg_out = rho * ins["MeanGrad"][0] + (1 - rho) * gf
        denom = ms_out - torch.square(mg_out) + eps
        outs["MeanGradOut"] = mg_out
    else:
        denom = ms_out + eps
    mom_out = attrs.get("momentum", 0.0) * mom \
        + _lr(ins) * gf / torch.sqrt(denom)
    outs.update(ParamOut=(p.to(torch.float32) - mom_out).to(p.dtype),
                MomentOut=mom_out)
    return outs


@register_op("ftrl")
def _ftrl(ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    sq, lin = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    lr = _lr(ins)
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    lr_power = attrs.get("lr_power", -0.5)
    gf = g.to(torch.float32)
    new_sq = sq + torch.square(gf)
    sigma = (new_sq ** (-lr_power) - sq ** (-lr_power)) / lr
    lin_out = lin + gf - sigma * p.to(torch.float32)
    x = torch.clamp(lin_out, -l1, l1) - lin_out
    y = new_sq ** (-lr_power) / lr + 2 * l2
    return {"ParamOut": (x / y).to(p.dtype), "SquaredAccumOut": new_sq,
            "LinearAccumOut": lin_out}


@register_op("lamb")
def _lamb(ins, attrs):
    """Layer-adaptive Adam: r = m1_hat / (sqrt(m2_hat) + eps) + wd * p,
    p -= lr * (||p|| / ||r||) * r (trust 1 where a norm is 0), the beta
    powers of after this step."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p = ins["Beta1Pow"][0].reshape(()).to(torch.float32)
    b2p = ins["Beta2Pow"][0].reshape(()).to(torch.float32)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    gf, pf = g.to(torch.float32), p.to(torch.float32)
    m1o = b1 * m1 + (1 - b1) * gf
    m2o = b2 * m2 + (1 - b2) * torch.square(gf)
    r = (m1o / (1 - b1p * b1)) / (torch.sqrt(m2o / (1 - b2p * b2)) + eps) \
        + wd * pf
    p_norm = torch.sqrt(torch.sum(torch.square(pf)))
    r_norm = torch.sqrt(torch.sum(torch.square(r)))
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        torch.ones_like(p_norm))
    p_out = pf - _lr(ins) * trust * r
    return {"ParamOut": p_out.to(p.dtype), "Moment1Out": m1o,
            "Moment2Out": m2o, "Beta1PowOut": ins["Beta1Pow"][0] * b1,
            "Beta2PowOut": ins["Beta2Pow"][0] * b2}


def _normal_noise(seed_t, shape, device):
    """Standard normal values of `shape` from an op's device seed: two
    uniforms in (0, 1) from `keep_hash`, then Box-Muller."""
    n = 1
    for d in shape:
        n *= int(d)
    h = keep_hash(seed_t.to(device), 2 * n).to(torch.float64)
    u = (h + 0.5) / 4294967296.0
    z = torch.sqrt(-2.0 * torch.log(u[:n])) * torch.cos(2 * math.pi * u[n:])
    return z.to(torch.float32).reshape(tuple(shape))


@register_op("dpsgd", rng="device")
def _dpsgd(ins, attrs):
    """Differentially private SGD: the gradient clipped to norm `clip`,
    plus Gaussian noise of std sigma * clip, over `batch_size`."""
    p, g = ins["Param"][0], ins["Grad"][0]
    clip = attrs.get("clip", 10.0)
    sigma = attrs.get("sigma", 1.0)
    gf = g.to(torch.float32)
    g_norm = torch.sqrt(torch.sum(torch.square(gf)))
    gf = gf / torch.clamp(g_norm / clip, min=1.0)
    noise = _normal_noise(attrs["_rng_seed"], g.shape, g.device) \
        * sigma * clip
    p_out = p.to(torch.float32) \
        - _lr(ins) / attrs.get("batch_size", 16.0) * (gf + noise)
    return {"ParamOut": p_out.to(p.dtype)}


@register_op("lookahead_step")
def _lookahead_step(ins, attrs):
    """Lookahead's slow weights: where Step is a multiple of k, slow +=
    alpha (p - slow) and p snaps to it; otherwise both stay."""
    p, slow = ins["Param"][0], ins["SlowParam"][0]
    alpha = attrs.get("alpha", 0.5)
    k = int(attrs.get("k", 5))
    do = torch.remainder(ins["Step"][0].reshape(()).to(torch.int32), k) == 0
    pf, sf = p.to(torch.float32), slow.to(torch.float32)
    slow2 = torch.where(do, sf + alpha * (pf - sf), sf)
    return {"ParamOut": torch.where(do, slow2, pf).to(p.dtype),
            "SlowParamOut": slow2.to(slow.dtype)}


@register_op("proximal_gd")
def _proximal_gd(ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = _lr(ins)
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    prox = p.to(torch.float32) - lr * g.to(torch.float32)
    out = torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1,
                                         min=0.0) / (1.0 + lr * l2)
    return {"ParamOut": out.to(p.dtype)}


@register_op("proximal_adagrad")
def _proximal_adagrad(ins, attrs):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    gf = g.to(torch.float32)
    m_out = m + torch.square(gf)
    alr = _lr(ins) / torch.sqrt(m_out)
    prox = p.to(torch.float32) - alr * gf
    out = torch.sign(prox) * torch.clamp(torch.abs(prox) - alr * l1,
                                         min=0.0) / (1.0 + alr * l2)
    return {"ParamOut": out.to(p.dtype), "MomentOut": m_out}


@register_op("dgc_momentum")
def _dgc_momentum(ins, attrs):
    """Momentum while CurrentStep < rampup_begin_step, plain SGD after
    (the dgc op's own momentum correction then takes over)."""
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    lr = ins["LearningRate"][0].reshape(())
    mu = attrs.get("mu", 0.9)
    warm = ins["CurrentStep"][0].reshape(()) < float(
        attrs.get("rampup_begin_step", 0.0))
    v_new = mu * v + g
    if attrs.get("use_nesterov", False):
        p_momentum = p - lr * (g + mu * v_new)
    else:
        p_momentum = p - lr * v_new
    return {"ParamOut": torch.where(warm, p_momentum, p - lr * g),
            "VelocityOut": torch.where(warm, v_new, v)}


@register_op("average_accumulates")
def _average_accumulates(ins, attrs):
    """ModelAverage's sliding window of parameter sums (the reference's
    `average_accumulates`): sum_1 += param and the counters advance; every
    16384 updates sum_1 folds into sum_2; when the window is full
    (num_accumulates >= min_average_window and >= min(max_average_window,
    num_updates * average_window)) sum_3 takes sum_1 + sum_2, both clear,
    old_num_accumulates takes num_accumulates and that restarts at 0."""
    p = ins["Param"][0]
    s1, s2, s3 = ins["in_sum_1"][0], ins["in_sum_2"][0], ins["in_sum_3"][0]
    i64 = torch.int64
    num = ins["in_num_accumulates"][0].reshape(()).to(i64) + 1
    old = ins["in_old_num_accumulates"][0].reshape(()).to(i64)
    upd = ins["in_num_updates"][0].reshape(()).to(i64) + 1
    max_win = min(int(attrs.get("max_average_window", 2 ** 31 - 1)),
                  2 ** 31 - 1)
    s1 = s1 + p
    shuffle = torch.remainder(upd, 16384) == 0
    s2 = torch.where(shuffle, s1 + s2, s2)
    s1 = torch.where(shuffle, torch.zeros_like(s1), s1)
    thresh = torch.clamp(
        (upd.to(torch.float32) * attrs.get("average_window", 0.0)).to(i64),
        max=max_win)
    rotate = (num >= attrs.get("min_average_window", 10000)) & \
        (num >= thresh)
    s3 = torch.where(rotate, s1 + s2, s3)
    s1 = torch.where(rotate, torch.zeros_like(s1), s1)
    s2 = torch.where(rotate, torch.zeros_like(s2), s2)
    old = torch.where(rotate, num, old)
    num = torch.where(rotate, torch.zeros_like(num), num)
    return {"out_sum_1": s1, "out_sum_2": s2, "out_sum_3": s3,
            "out_num_accumulates": num.reshape((1,)),
            "out_old_num_accumulates": old.reshape((1,)),
            "out_num_updates": upd.reshape((1,))}


@register_op("dgc_clip_by_norm")
def _dgc_clip_by_norm(ins, attrs):
    """`clip_by_norm` from the DGC ramp-up step on (both sides of the
    comparison truncated to int); a negative ramp-up never clips."""
    from .math_ops import _clip_by_norm

    x = ins["X"][0]
    rampup = int(float(attrs.get("rampup_begin_step", 0.0)))
    if rampup < 0:
        return {"Out": x}
    step = ins["current_step"][0].reshape(()).to(torch.int32) \
        if ins.get("current_step") else torch.zeros(
            (), dtype=torch.int32, device=x.device)
    clipped = _clip_by_norm({"X": [x]}, {"max_norm": attrs.get("max_norm",
                                                               1.0)})["Out"]
    return {"Out": torch.where(step >= rampup, clipped, x)}


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
