"""Loss operators (counterpart: `paddle_tpu/ops/loss_ops.py`): `cos_sim`,
`hinge_loss`, `modified_huber_loss`, `squared_l2_distance`, `rank_loss`,
`margin_rank_loss`, `bpr_loss`, `log_loss`, `sigmoid_focal_loss`,
`teacher_student_sigmoid_loss`, `center_loss`, `npair_loss`,
`dice_loss`, `mse_loss`, `l1_loss`, `cross_entropy2`, `bce_loss` and
`nll_loss`, with the reference's slots, attrs and output dtypes.

`center_loss` returns the moved centers as CentersOut and writes no
state itself (the program binds CentersOut to the centers var).
"""
from __future__ import annotations

import torch

from .registry import register_op


def _softplus0(d):
    """log(1 + e^d), as `jnp.logaddexp(0, d)`."""
    return torch.logaddexp(torch.zeros((), dtype=d.dtype, device=d.device),
                           d)


def _zero(like):
    return torch.zeros((), dtype=like.dtype, device=like.device)


@register_op("hinge_loss")
def _hinge_loss(ins, attrs):
    """max(0, 1 - y * Logits) with y = 2 * Labels - 1 (labels in {0,
    1})."""
    logits, labels = ins["Logits"][0], ins["Labels"][0]
    y = 2.0 * labels.to(logits.dtype) - 1.0
    return {"Loss": torch.maximum(_zero(logits), 1.0 - y * logits)}


@register_op("modified_huber_loss")
def _modified_huber_loss(ins, attrs):
    """v = X * (2Y - 1): -4v below -1, (1 - v)^2 below 1, else 0; v is
    IntermediateVal."""
    x, y = ins["X"][0], ins["Y"][0]
    v = x * (2.0 * y.to(x.dtype) - 1.0)
    loss = torch.where(v < -1.0, -4.0 * v,
                       torch.where(v < 1.0, torch.square(1.0 - v),
                                   _zero(v)))
    return {"IntermediateVal": v, "Out": loss}


@register_op("squared_l2_distance")
def _squared_l2_distance(ins, attrs):
    """Rows flattened to [N, cols] (a one-row Y broadcasts): sub_result
    X - Y and Out the sum of its squares a row, [N, 1]."""
    x, y = ins["X"][0], ins["Y"][0]
    sub = x.reshape(x.shape[0], -1) - y.reshape(y.shape[0], -1)
    return {"sub_result": sub,
            "Out": torch.sum(torch.square(sub), dim=1, keepdim=True)}


@register_op("rank_loss")
def _rank_loss(ins, attrs):
    """RankNet: log(1 + e^(Left - Right)) - Label * (Left - Right)."""
    d = ins["Left"][0] - ins["Right"][0]
    return {"Out": _softplus0(d) - ins["Label"][0].to(d.dtype) * d}


@register_op("margin_rank_loss")
def _margin_rank_loss(ins, attrs):
    label, x1, x2 = ins["Label"][0], ins["X1"][0], ins["X2"][0]
    out = torch.maximum(_zero(x1), -label.to(x1.dtype) * (x1 - x2)
                        + attrs.get("margin", 0.0))
    return {"Out": out, "Activated": (out > 0).to(x1.dtype)}


@register_op("bpr_loss")
def _bpr_loss(ins, attrs):
    """Bayesian personalized ranking over [N, C] scores: the mean of
    log(1 + e^(X - X[label])) over the C - 1 other classes, [N, 1]."""
    x, label = ins["X"][0], ins["Label"][0]
    n, c = x.shape
    idx = label.reshape(n, 1).long()
    lse = torch.log1p(torch.exp(x - torch.gather(x, 1, idx)))
    mask = torch.ones((n, c), dtype=x.dtype, device=x.device).scatter(
        1, idx, 0.0)
    return {"Y": torch.sum(lse * mask, dim=1, keepdim=True) / max(c - 1, 1)}


@register_op("log_loss")
def _log_loss(ins, attrs):
    p, label = ins["Predicted"][0], ins["Labels"][0]
    eps = attrs.get("epsilon", 1e-4)
    lf = label.to(p.dtype)
    return {"Loss": -lf * torch.log(p + eps)
            - (1.0 - lf) * torch.log(1.0 - p + eps)}


@register_op("sigmoid_focal_loss")
def _sigmoid_focal_loss(ins, attrs):
    """The focal loss of each class logit of X [N, C] against integer
    labels (0 the background, class k the label k + 1), divided by
    max(FgNum, 1)."""
    x, label = ins["X"][0], ins["Label"][0]
    fg = ins["FgNum"][0].reshape(()).to(x.dtype) if ins.get("FgNum") \
        else torch.ones((), dtype=x.dtype, device=x.device)
    gamma = attrs.get("gamma", 2.0)
    alpha = attrs.get("alpha", 0.25)
    c = x.shape[1]
    classes = torch.arange(1, c + 1, dtype=torch.int32, device=x.device)
    target = (label.reshape(-1, 1).to(torch.int32) == classes).to(x.dtype)
    p = torch.sigmoid(x)
    ce = _softplus0(x) - x * target
    p_t = p * target + (1 - p) * (1 - target)
    alpha_t = alpha * target + (1 - alpha) * (1 - target)
    loss = alpha_t * torch.pow(1 - p_t, gamma) * ce
    return {"Out": loss / torch.clamp_min(fg, 1.0)}


@register_op("teacher_student_sigmoid_loss")
def _ts_sigmoid_loss(ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    xc = torch.clamp(x, attrs.get("soft_max_lower_bound", -15.0),
                     attrs.get("soft_max_up_bound", 15.0))
    return {"Y": _softplus0(xc) - xc * label.to(x.dtype)}


@register_op("cos_sim")
def _cos_sim(ins, attrs):
    """The cosine similarity of X's and Y's rows (last axis), [N, 1],
    with the row norms XNorm and YNorm (a one-row Y broadcasts)."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt(torch.sum(torch.square(x), -1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), -1, keepdim=True))
    out = torch.sum(x * y, -1, keepdim=True) / torch.clamp_min(xn * yn,
                                                               1e-12)
    return {"Out": out, "XNorm": xn, "YNorm": yn}


@register_op("center_loss")
def _center_loss(ins, attrs):
    """Half the squared distance of each row of X to its label's center,
    SampleCenterDiff, and (with `need_update`) CentersOut: each center
    moved by alpha * (the sum of its rows' differences) / (count + 1)."""
    x, label, centers = ins["X"][0], ins["Label"][0], ins["Centers"][0]
    lr = ins["CenterUpdateRate"][0].reshape(()) if \
        ins.get("CenterUpdateRate") else 0.5
    alpha = attrs.get("alpha", lr)
    lbl = label.reshape(-1).long()
    diff = x - centers[lbl]
    loss = 0.5 * torch.sum(torch.square(diff), dim=-1, keepdim=True)
    if attrs.get("need_update", True):
        counts = torch.zeros(centers.shape[0], dtype=x.dtype,
                             device=x.device).index_add(
            0, lbl, torch.ones_like(lbl, dtype=x.dtype))
        upd = torch.zeros_like(centers).index_add(0, lbl, diff)
        centers_out = centers + alpha * upd / (counts[:, None] + 1.0)
    else:
        centers_out = centers
    return {"Loss": loss, "SampleCenterDiff": diff,
            "CentersOut": centers_out}


@register_op("npair_loss")
def _npair_loss(ins, attrs):
    """The softmax cross-entropy of Anchor @ Positive^T against the
    same-label targets (normalized a row), meaned, plus l2_reg times the
    mean squared norms of both."""
    anchor, positive = ins["Anchor"][0], ins["Positive"][0]
    labels = ins["Labels"][0].reshape(-1)
    sim = anchor @ positive.t()
    tgt = (labels[:, None] == labels[None, :]).to(sim.dtype)
    tgt = tgt / torch.sum(tgt, -1, keepdim=True)
    ce = -torch.sum(tgt * torch.log_softmax(sim, -1), -1)
    reg = attrs.get("l2_reg", 0.002) * (
        torch.mean(torch.sum(torch.square(anchor), -1))
        + torch.mean(torch.sum(torch.square(positive), -1))) / 2
    return {"Out": torch.mean(ce) + reg}


@register_op("dice_loss")
def _dice_loss(ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    eps = attrs.get("epsilon", 1e-5)
    lf = label.to(x.dtype)
    dims = tuple(range(1, x.ndim))
    inter = 2.0 * torch.sum(x * lf, dims)
    union = torch.sum(x, dims) + torch.sum(lf, dims)
    return {"Out": 1.0 - (inter + eps) / (union + eps)}


@register_op("mse_loss")
def _mse_loss(ins, attrs):
    return {"Out": torch.square(ins["X"][0] - ins["Y"][0])}


@register_op("l1_loss")
def _l1_loss(ins, attrs):
    return {"Out": torch.abs(ins["X"][0] - ins["Y"][0])}


@register_op("cross_entropy2")
def _cross_entropy2(ins, attrs):
    """-log(max(X[label], 1e-20)) of probabilities X, with MatchX the
    picked probability and an all-zero XShape like X."""
    x, label = ins["X"][0], ins["Label"][0]
    idx = label.reshape(label.shape[:-1]).long().unsqueeze(-1)
    p = torch.gather(x, -1, idx)
    return {"Y": -torch.log(torch.clamp_min(p, 1e-20)),
            "XShape": torch.zeros_like(x).detach(), "MatchX": p}


@register_op("bce_loss")
def _bce_loss(ins, attrs):
    """Binary cross-entropy of probabilities X (clipped to [1e-12, 1 -
    1e-12]) against Label."""
    x, label = ins["X"][0], ins["Label"][0]
    x = torch.clamp(x, 1e-12, 1.0 - 1e-12)
    return {"Out": -(label * torch.log(x) + (1.0 - label)
                     * torch.log(1.0 - x))}


@register_op("nll_loss")
def _nll_loss(ins, attrs):
    """-X[label] of log-probabilities X ([N, C] or [N, C, d1, d2]) times
    the optional per-class Weight, 0 for `ignore_index`; reduced by
    "mean" (over the weights' sum), "sum" or "none", with
    Total_weight."""
    x, label = ins["X"][0], ins["Label"][0]
    ignore = label == int(attrs.get("ignore_index", -100))
    safe = torch.where(ignore, torch.zeros_like(label), label).long()
    picked = torch.gather(x, 1, safe.unsqueeze(1)).squeeze(1)
    w = ins["Weight"][0][safe] if ins.get("Weight") \
        else torch.ones_like(picked)
    w = w.masked_fill(ignore, 0.0)
    loss = -picked * w
    total = torch.sum(w)
    red = attrs.get("reduction", "mean")
    if red == "none":
        return {"Out": loss, "Total_weight": total}
    if red == "sum":
        return {"Out": torch.sum(loss), "Total_weight": total}
    return {"Out": torch.sum(loss) / torch.clamp_min(total, 1e-12),
            "Total_weight": total}
