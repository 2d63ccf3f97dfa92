"""Specialty operators (counterpart: `paddle_tpu/ops/specialty_ops.py`).

Ported so far: `sync_batch_norm` (`:515`), the batch norm whose moments
are averaged over the data-parallel ring (reference:
sync_batch_norm_op.cu, ncclAllReduce of the moments), `yolov3_loss`
(`:415`), YOLOv3's training loss, vectorized as in the reference, and
`sample_logits` (`:138`), sampled softmax's preparation. Its log-uniform
negatives are drawn from the op's device seed through `keep_hash`, as the
other samplers draw (`rng_ops.py`; their stream differs from JAX's by
design, ROADMAP "Differences by design" 14); `CustomizedSamples` and
`CustomizedProbabilities` take the draw's place, and the outputs are then
the reference's. The logits are gathered through one flat index, so
their gradient is summed in a fixed order.
"""
from __future__ import annotations

import torch

from . import collective_ops
from .interp_ops import consts, f32, take
from .registry import get_op, register_op
from .rng_ops import device_uniform
from ..core.types import to_torch_dtype
from ..parallel import env as penv

_NEG = -1e30


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


# -- yolov3 loss --------------------------------------------------------------

def _sce(x, lbl):
    """Stable sigmoid cross entropy against a soft target."""
    return (torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))
            - x * lbl + torch.log1p(torch.exp(-torch.abs(x))))


def _box_iou_xywh(b1, b2):
    """IoU of (cx, cy, w, h) boxes, broadcast."""
    lt = torch.maximum(b1[..., :2] - b1[..., 2:] / 2,
                       b2[..., :2] - b2[..., 2:] / 2)
    rb = torch.minimum(b1[..., :2] + b1[..., 2:] / 2,
                       b2[..., :2] + b2[..., 2:] / 2)
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (b1[..., 2] * b1[..., 3] + b2[..., 2] * b2[..., 3]
                    - inter + 1e-10)


def _wh_iou(w1, h1, w2, h2):
    inter = torch.minimum(w1, w2) * torch.minimum(h1, h2)
    return inter / (w1 * h1 + w2 * h2 - inter + 1e-10)


@register_op("yolov3_loss")
def _yolov3_loss(ins, attrs):
    """The YOLOv3 training loss of one head (reference:
    detection/yolov3_loss_op.h): X [N, M*(5+C), H, W], GTBox [N, B, 4]
    (cx, cy, w, h over the image), GTLabel [N, B], GTScore [N, B]. Loss
    [N] is the location, class and objectness terms; ObjectnessMask
    [N, M, H, W] is -1 where the best IoU with a ground truth passes
    `ignore_thresh`, a positive cell's score where a ground truth's best
    anchor (over all anchors) is in `anchor_mask`, else 0; GTMatchMask
    [N, B] is that anchor's place in the mask or -1.

    A ground truth with w or h <= 0 is dropped. Where two fall on one
    cell and anchor, the later one (in index order) sets the mask, as
    Paddle's loop does: the winner of each cell is found by comparison,
    not by a scatter, so no run can pick another. The cell gather's
    gradient is summed in a fixed order (`interp_ops.take`)."""
    x = ins["X"][0]
    gtbox = ins["GTBox"][0]
    gtlabel = ins["GTLabel"][0].to(torch.int64)
    anchors = consts(attrs["anchors"], x.device).reshape(-1, 2)
    mask = [int(a) for a in attrs["anchor_mask"]]
    class_num = int(attrs["class_num"])
    ignore_thresh = f32(attrs.get("ignore_thresh", 0.7))
    downsample = int(attrs.get("downsample_ratio", 32))
    scale_xy = float(attrs.get("scale_x_y", 1.0))
    bias_xy = -0.5 * (scale_xy - 1.0)
    n, _, h, w = x.shape
    m = len(mask)
    nb = gtbox.shape[1]
    input_size = downsample * h
    dev = x.device
    x = x.reshape(n, m, 5 + class_num, h, w)
    gtscore = ins["GTScore"][0] if ins.get("GTScore") \
        else torch.ones((n, nb), dtype=x.dtype, device=dev)
    label_pos, label_neg = 1.0, 0.0
    if attrs.get("use_label_smooth", True):
        sw = min(1.0 / class_num, 1.0 / 40.0)
        label_pos, label_neg = 1.0 - sw, sw

    gt_valid = (gtbox[..., 2] > 0) & (gtbox[..., 3] > 0)      # [N, B]
    # the predicted boxes (over the image) for the ignore mask
    gx = torch.arange(w, dtype=x.dtype, device=dev)[None, None, None, :]
    gy = torch.arange(h, dtype=x.dtype, device=dev)[None, None, :, None]
    mask_t = consts(mask, x.device).to(torch.int64)
    manchors = anchors.index_select(0, mask_t)                 # [M, 2]
    aw = (manchors[:, 0] / input_size)[None, :, None, None]
    ah = (manchors[:, 1] / input_size)[None, :, None, None]
    px = (gx + torch.sigmoid(x[:, :, 0]) * f32(scale_xy) + f32(bias_xy)) / w
    py = (gy + torch.sigmoid(x[:, :, 1]) * f32(scale_xy) + f32(bias_xy)) / h
    pw = torch.exp(x[:, :, 2]) * aw
    ph = torch.exp(x[:, :, 3]) * ah
    pred = torch.stack([px, py, pw, ph], -1)                   # [N,M,H,W,4]
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    gtb = torch.where(gt_valid[..., None], gtbox, zero)
    iou = _box_iou_xywh(pred[:, :, :, :, None, :],
                        gtb[:, None, None, None, :, :])        # [N,M,H,W,B]
    iou = torch.where(gt_valid[:, None, None, None, :], iou, zero)
    best_iou = torch.amax(iou, -1)
    obj_mask = torch.where(best_iou > ignore_thresh,
                           torch.full((), -1.0, device=dev), zero)

    # each ground truth's best anchor over the full set (w, h IoU only)
    an_iou = _wh_iou(anchors[None, None, :, 0] / input_size,
                     anchors[None, None, :, 1] / input_size,
                     gtb[..., 2:3], gtb[..., 3:4])             # [N, B, An]
    best_n = torch.argmax(an_iou, -1)                          # [N, B]
    mask_hit = mask_t[None, None, :] == best_n[..., None]
    mask_idx = torch.where(mask_hit.any(-1),
                           torch.argmax(mask_hit.to(torch.int32), -1),
                           torch.full((), -1, dtype=torch.int64,
                                      device=dev))             # [N, B]
    gt_match = torch.where(gt_valid, mask_idx,
                           torch.full((), -1, dtype=torch.int64,
                                      device=dev))
    gi = torch.clamp((gtb[..., 0] * w).to(torch.int32), 0, w - 1).long()
    gj = torch.clamp((gtb[..., 1] * h).to(torch.int32), 0, h - 1).long()
    pos = gt_valid & (mask_idx >= 0)                           # [N, B]
    posf = pos.to(x.dtype) * gtscore

    # the prediction vector at each ground truth's cell
    mcl = torch.clamp(mask_idx, 0, m - 1)
    bidx = torch.arange(n, device=dev)[:, None].expand(n, nb)
    cells = ((bidx * m + mcl) * h + gj) * w + gi               # [N, B]
    rows = x.permute(0, 1, 3, 4, 2).reshape(n * m * h * w, 5 + class_num)
    cell = take(rows, cells.reshape(-1), 0).reshape(n, nb, 5 + class_num)
    tx = gtb[..., 0] * w - gi
    ty = gtb[..., 1] * h - gj
    a_w = anchors[best_n, 0] / input_size
    a_h = anchors[best_n, 1] / input_size
    tw = torch.log(torch.clamp(gtb[..., 2] / torch.clamp(a_w, min=1e-10),
                               min=1e-9))
    th = torch.log(torch.clamp(gtb[..., 3] / torch.clamp(a_h, min=1e-10),
                               min=1e-9))
    box_scale = 2.0 - gtb[..., 2] * gtb[..., 3]
    loc = (_sce(cell[..., 0], tx) + _sce(cell[..., 1], ty)
           + torch.abs(cell[..., 2] - tw) + torch.abs(cell[..., 3] - th))
    loc_loss = torch.sum(loc * box_scale * posf, 1)
    onehot = (gtlabel[..., None] == torch.arange(
        class_num, device=dev)).to(x.dtype)
    cls_target = onehot * f32(label_pos) + (1.0 - onehot) * f32(label_neg)
    cls_loss = torch.sum(torch.sum(_sce(cell[..., 5:], cls_target), -1)
                         * posf, 1)

    # a positive cell's mask is the score of the last ground truth on it
    flat = (mcl * h + gj) * w + gi                             # [N, B]
    hits = (flat[:, None, :] == torch.arange(m * h * w, device=dev)
            [None, :, None]) & pos[:, None, :]                 # [N, MHW, B]
    order = torch.arange(nb, device=dev)
    winner = torch.amax(torch.where(hits, order, torch.full(
        (), -1, dtype=order.dtype, device=dev)), -1)           # [N, MHW]
    won = torch.gather(gtscore, 1, winner.clamp(min=0))
    obj_mask = torch.where(winner >= 0, won,
                           obj_mask.reshape(n, -1)).reshape(n, m, h, w)
    pobj = x[:, :, 4]
    obj_loss = torch.sum(torch.where(
        obj_mask > 0, _sce(pobj, 1.0) * obj_mask,
        torch.where(obj_mask == 0, _sce(pobj, 0.0), zero)), (1, 2, 3))
    return {"Loss": loc_loss + cls_loss + obj_loss,
            "ObjectnessMask": obj_mask,
            "GTMatchMask": gt_match.to(torch.int32)}


# -- candidate sampling -------------------------------------------------------

def _log32(v, device):
    """log(v) of a Python number rounded to float32, in float32 (as JAX
    takes the log of a weakly typed scalar)."""
    return torch.log(torch.full((), f32(v), dtype=torch.float32,
                                device=device))


def log_uniform_sample(seed_t, num_samples, vocab, device):
    """`num_samples` log-uniform (Zipf) draws over [0, vocab) and their
    probabilities P(k) = log((k + 2) / (k + 1)) / log(vocab + 1), by
    inverting the CDF at uniforms drawn from the op seed (reference:
    math/sample_prob.h LogUniformSampler)."""
    u = device_uniform(seed_t, (num_samples,))
    log_range = _log32(vocab + 1.0, device)
    samples = torch.clamp(torch.floor(torch.exp(u * log_range) - 1.0),
                          0, vocab - 1).to(to_torch_dtype("int64"))
    probs = torch.log((samples + 2.0) / (samples + 1.0)) / log_range
    return samples, probs


@register_op("sample_logits", rng="device")
def _sample_logits(ins, attrs):
    """Per row, the true labels' logits and `num_samples` shared
    log-uniform negatives, each less log(Q * num_samples); with
    `remove_accidental_hits` a negative equal to one of the row's labels
    gets -1e30 added."""
    logits, labels = ins["Logits"][0], ins["Labels"][0]
    n, vocab = logits.shape
    nt = labels.shape[1]
    num_samples = int(attrs.get("num_samples", 1))
    dev = logits.device
    if ins.get("CustomizedSamples"):
        samples = ins["CustomizedSamples"][0]
        probs = ins["CustomizedProbabilities"][0]
    else:
        neg, negp = log_uniform_sample(attrs["_rng_seed"], num_samples,
                                       vocab, dev)
        itype = to_torch_dtype("int64")
        samples = torch.cat([labels.to(itype),
                             neg.expand(n, num_samples)], 1)
        tp = torch.log((labels + 2.0) / (labels + 1.0)) \
            / _log32(vocab + 1.0, dev)
        probs = torch.cat([tp, negp.expand(n, num_samples)], 1)
    rows = torch.arange(n, device=dev)[:, None] * vocab
    flat = (rows + samples.to(torch.int64)).reshape(-1)
    picked = take(logits.reshape(-1), flat, 0).reshape(samples.shape)
    sampled = picked - torch.log(probs * num_samples + f32(1e-20))
    if attrs.get("remove_accidental_hits", True):
        hit = (samples[:, nt:, None] == samples[:, None, :nt]).any(-1)
        sampled = torch.cat([sampled[:, :nt], sampled[:, nt:] + torch.where(
            hit, torch.full((), _NEG, dtype=sampled.dtype, device=dev),
            torch.zeros((), dtype=sampled.dtype, device=dev))], 1)
    labels_out = torch.arange(nt, device=dev).expand(n, nt)
    return {"Samples": samples, "Probabilities": probs,
            "SampledLogits": sampled,
            "SampledLabels": labels_out.to(to_torch_dtype("int64"))}
