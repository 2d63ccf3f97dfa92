"""The detection pipeline's other operators (counterpart:
`paddle_tpu/ops/detection_extra_ops.py`): matching and target
assignment, proposal generation and FPN routing, RetinaNet's decode and
targets, Mask R-CNN's labels, SSD's hard-example mining and the mAP
metric, the perspective and deformable PSRoI transforms, and the
helpers `hsigmoid`, `sampled_softmax_with_cross_entropy`, `random_crop`,
`similarity_focus`, `add_position_encoding` and `box_decoder_and_assign`
(reference: paddle/fluid/operators/detection/ and the ops named in the
reference's docstring).

The host types (`no_jit`, most also `dynamic_shape`) are the reference's
numpy, call for call and in the same order, with its float32/float64
promotions: `bipartite_match`, `rpn_target_assign`, `generate_proposals`,
`distribute_fpn_proposals`, `collect_fpn_proposals`,
`retinanet_detection_output`, `retinanet_target_assign`,
`generate_proposal_labels`, `similarity_focus`, `mine_hard_examples`,
`detection_map` and `generate_mask_labels`. Each reads its inputs to the
host and returns tensors on the op's device; a block holding one runs
eagerly (`fluid/lowering.py capture_blocker` names it). The two samplers
(`rpn_target_assign`, `generate_proposal_labels`) draw with
`np.random.RandomState(seed attr)` as the reference does, so every step
redraws from the same seed and their anchors and RoIs are the
reference's, index for index. As in the reference they read one image's
table (`ins[slot][0]`), and `bipartite_match` one [gt, priors] matrix.
`generate_proposals` keeps the reference's top `pre_nms_topN`
(`np.argsort(-score)`), decodes, clips and filters; its greedy NMS loop
(take the best remaining score, suppress every box whose IoU with it
passes `nms_thresh`) is `detection_ops.greedy_select` over the survivors
in stable descending score order, which keeps the same boxes in the same
order and computes each IoU by the same formula; `eta` is ignored, as in
the reference. `detection_map` skips the background class (the
reference's documented departure from Paddle's literal code), clips only
the predicted box and carries its streaming state through the `*Lod`
offsets.

The device types read nothing on the host, and every gather on a
differentiable path sums its gradient in a fixed order
(`interp_ops.take`): `target_assign`'s, `hsigmoid`'s rows of W, the
bilinear taps of `roi_perspective_transform` and
`deformable_psroi_pooling` (`vision_extra_ops.bilinear_taps`, gathered
by rows and by scalars), `box_decoder_and_assign`'s and `random_crop`'s.
`roi_perspective_transform` solves each RoI's 8 x 8 system (with
1e-8 I added) in one batched `torch.linalg.solve_ex` and samples image 0,
as the reference. `deformable_psroi_pooling` samples each bin at
`sample_per_part` points along its diagonal (the reference's pairing of
its y and x offsets) and gives TopCount as ones; `hsigmoid` gives
PreOut as zeros. `random_crop` draws its starts from the op's device
seed (`rng_ops.device_bits`; its stream differs from JAX's by design)
and gives SeedOut as zeros; `sampled_softmax_with_cross_entropy` draws
through `specialty_ops.sample_logits`.
"""
from __future__ import annotations

import collections

import numpy as np
import torch
import torch.nn.functional as F

from .detection_ops import greedy_select, iou_matrix
from .interp_ops import take
from .registry import get_op, register_op
from .rng_ops import device_bits
from .vision_extra_ops import bilinear_sample, bilinear_taps, roi_batch_ids
from ..core.types import from_numpy, to_numpy, to_torch_dtype


def _host(ins, slot, i=0):
    return to_numpy(ins[slot][i])


def _outs(attrs, **arrays):
    dev = attrs["_device"]
    return {k: ([from_numpy(a, dev) for a in v] if isinstance(v, list)
                else from_numpy(v, dev)) for k, v in arrays.items()}


@register_op("bipartite_match", no_jit=True)
def _bipartite_match(ins, attrs):
    """Greedy bipartite matching of the columns (priors) of DistMat
    [gt, priors] to its rows: the global maximum of what is left, again
    and again; with `per_prediction` an unmatched column also takes its
    best row where that passes `dist_threshold`."""
    dist = _host(ins, "DistMat").copy()
    match_type = attrs.get("match_type", "bipartite")
    overlap = float(attrs.get("dist_threshold", 0.5))
    g, p = dist.shape
    match_idx = np.full((1, p), -1, "int32")
    match_dist = np.zeros((1, p), "float32")
    d = dist.copy()
    for _ in range(min(g, p)):
        flat = int(np.argmax(d))
        i, j = divmod(flat, p)
        if d[i, j] <= 0:
            break
        match_idx[0, j] = i
        match_dist[0, j] = d[i, j]
        d[i, :] = -1.0
        d[:, j] = -1.0
    if match_type == "per_prediction":
        for j in range(p):
            if match_idx[0, j] == -1:
                i = int(np.argmax(dist[:, j]))
                if dist[i, j] > overlap:
                    match_idx[0, j] = i
                    match_dist[0, j] = dist[i, j]
    return _outs(attrs, ColToRowMatchIndices=match_idx,
                 ColToRowMatchDist=match_dist)


@register_op("target_assign")
def _target_assign(ins, attrs):
    """Per-prior targets from the matched ground-truth rows: X [gt, P, K]
    gives out[j] = X[match[j], j], X [gt, K] out[j] = X[match[j]]; an
    unmatched prior gets `mismatch_value` and weight 0."""
    x = ins["X"][0]
    mi = ins["MatchIndices"][0][0].to(torch.int64)
    mismatch = attrs.get("mismatch_value", 0)
    matched = mi >= 0
    safe = torch.clamp(mi, min=0)
    if x.ndim >= 3:
        p = mi.shape[0]
        rows = x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))
        gathered = take(rows, safe * x.shape[1]
                        + torch.arange(p, device=x.device), 0)
    else:
        gathered = take(x, safe, 0)
    fill = torch.full((), mismatch, dtype=gathered.dtype, device=x.device)
    out = torch.where(matched[:, None], gathered, fill)
    w = matched.to(torch.float32)[:, None]
    return {"Out": out[None], "OutWeight": w[None]}


@register_op("polygon_box_transform")
def _polygon_box_transform(ins, attrs):
    """Input [N, 8, H, W] quad offsets to absolute coordinates:
    4 * (the cell's x or y) - offset."""
    x = ins["Input"][0]
    _, c, h, w = x.shape
    gx = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, None, :]
    gy = torch.arange(h, dtype=x.dtype, device=x.device)[None, None, :, None]
    is_x = (torch.arange(c, device=x.device) % 2 == 0)[None, :, None, None]
    return {"Output": torch.where(is_x, 4.0 * gx, 4.0 * gy) - x}


@register_op("rpn_target_assign", no_jit=True, dynamic_shape=True)
def _rpn_target_assign(ins, attrs):
    """Anchors sampled into foreground (IoU >= rpn_positive_overlap, or
    a ground truth's best) and background (IoU < rpn_negative_overlap),
    `rpn_batch_size_per_im` of them at most, `rpn_fg_fraction` of that
    foreground."""
    anchors = _host(ins, "Anchor")
    gt = _host(ins, "GtBoxes")
    batch = int(attrs.get("rpn_batch_size_per_im", 256))
    fg_frac = float(attrs.get("rpn_fg_fraction", 0.5))
    pos_t = float(attrs.get("rpn_positive_overlap", 0.7))
    neg_t = float(attrs.get("rpn_negative_overlap", 0.3))
    rng = np.random.RandomState(int(attrs.get("seed", 0)))
    a_n = anchors.shape[0]
    if len(gt) == 0:
        arg = np.zeros(a_n, int)
        labels = np.zeros(a_n, "int32")
    else:
        iou = iou_matrix(gt, anchors)                 # [G, A]
        best = iou.max(0)
        arg = iou.argmax(0)
        labels = np.full(a_n, -1, "int32")
        labels[best >= pos_t] = 1
        labels[iou.argmax(1)] = 1
        labels[best < neg_t] = np.where(labels[best < neg_t] == 1, 1, 0)
    fg_inds = np.nonzero(labels == 1)[0]
    n_fg = int(batch * fg_frac)
    if len(fg_inds) > n_fg:
        labels[rng.choice(fg_inds, len(fg_inds) - n_fg,
                          replace=False)] = -1
        fg_inds = np.nonzero(labels == 1)[0]
    bg_inds = np.nonzero(labels == 0)[0]
    n_bg = batch - len(fg_inds)
    if len(bg_inds) > n_bg:
        labels[rng.choice(bg_inds, len(bg_inds) - n_bg,
                          replace=False)] = -1
        bg_inds = np.nonzero(labels == 0)[0]
    score_idx = np.concatenate([fg_inds, bg_inds])
    tgt_lbl = (labels[score_idx] == 1).astype("int32")[:, None]
    matched_gt = gt[arg[fg_inds]] if len(fg_inds) else \
        np.zeros((0, 4), "float32")
    return _outs(attrs, LocationIndex=fg_inds.astype("int32"),
                 ScoreIndex=score_idx.astype("int32"), TargetLabel=tgt_lbl,
                 TargetBBox=matched_gt.astype("float32"),
                 BBoxInsideWeight=np.ones_like(matched_gt, "float32"))


def decode_center(anchors, deltas, variances=None):
    """Center-size decoding of `deltas` against corner `anchors` (pixel
    extents, +1), dw and dh capped at 10 before the exp (the port's own
    copy of the reference's `_decode_center`)."""
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    ax = anchors[:, 0] + aw * 0.5
    ay = anchors[:, 1] + ah * 0.5
    v = variances if variances is not None else np.ones((1, 4))
    cx = v[:, 0] * deltas[:, 0] * aw + ax
    cy = v[:, 1] * deltas[:, 1] * ah + ay
    w = np.exp(np.minimum(v[:, 2] * deltas[:, 2], 10.0)) * aw
    h = np.exp(np.minimum(v[:, 3] * deltas[:, 3], 10.0)) * ah
    return np.stack([cx - w * 0.5, cy - h * 0.5,
                     cx + w * 0.5 - 1.0, cy + h * 0.5 - 1.0], 1)


@register_op("generate_proposals", no_jit=True, dynamic_shape=True)
def _generate_proposals(ins, attrs):
    """RPN proposals, image by image: the top `pre_nms_topN` anchors by
    score decoded, clipped to ImInfo's (h, w), those below `min_size`
    dropped, then greedy NMS at `nms_thresh` to `post_nms_topN`."""
    scores = _host(ins, "Scores")                     # [N, A, H, W]
    deltas = _host(ins, "BboxDeltas")                 # [N, A*4, H, W]
    im_info = _host(ins, "ImInfo")                    # [N, 3]
    anchors = _host(ins, "Anchors").reshape(-1, 4)
    variances = _host(ins, "Variances").reshape(-1, 4) \
        if ins.get("Variances") else None
    pre_n = int(attrs.get("pre_nms_topN", 6000))
    post_n = int(attrs.get("post_nms_topN", 1000))
    nms_t = float(attrs.get("nms_thresh", 0.5))
    min_size = float(attrs.get("min_size", 0.1))
    all_rois, all_probs, nums = [], [], []
    for i in range(scores.shape[0]):
        sc = scores[i].transpose(1, 2, 0).reshape(-1)
        dl = deltas[i].reshape(deltas.shape[1] // 4, 4, -1) \
            .transpose(2, 0, 1).reshape(-1, 4)
        order = np.argsort(-sc)[:pre_n]
        props = decode_center(anchors[order], dl[order],
                              variances[order] if variances is not None
                              else None)
        h, w = im_info[i, 0], im_info[i, 1]
        props[:, 0::2] = np.clip(props[:, 0::2], 0, w - 1)
        props[:, 1::2] = np.clip(props[:, 1::2], 0, h - 1)
        keep = ((props[:, 2] - props[:, 0] >= min_size)
                & (props[:, 3] - props[:, 1] >= min_size))
        props, sc_k = props[keep], sc[order][keep]
        # the reference's loop takes the best remaining score (the first
        # on a tie): stable descending order, then greedy NMS
        by_score = np.argsort(-sc_k, kind="stable")
        keep_idx = by_score[greedy_select(props[by_score], True, nms_t,
                                          1.0)][:post_n]
        all_rois.append(props[keep_idx])
        all_probs.append(sc_k[keep_idx])
        nums.append(len(keep_idx))
    rois = np.concatenate(all_rois) if all_rois else np.zeros((0, 4))
    probs = np.concatenate(all_probs) if all_probs else np.zeros((0,))
    return _outs(attrs, RpnRois=rois.astype("float32"),
                 RpnRoiProbs=probs.astype("float32").reshape(-1, 1),
                 RpnRoisNum=np.asarray(nums, "int32"))


@register_op("distribute_fpn_proposals", no_jit=True, dynamic_shape=True)
def _distribute_fpn_proposals(ins, attrs):
    """RoIs routed to FPN levels by scale: floor(log2(sqrt(area) /
    refer_scale + 1e-6)) + refer_level, clipped to [min_level,
    max_level]; RestoreIndex [R, 1] puts them back in order."""
    rois = _host(ins, "FpnRois")
    min_l = int(attrs.get("min_level", 2))
    max_l = int(attrs.get("max_level", 5))
    refer_l = int(attrs.get("refer_level", 4))
    refer_s = float(attrs.get("refer_scale", 224))
    scale = np.sqrt(np.maximum(
        (rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1]), 1e-10))
    lvl = np.clip(np.floor(np.log2(scale / refer_s + 1e-6)) + refer_l,
                  min_l, max_l).astype(int)
    outs, order = [], []
    for lev in range(min_l, max_l + 1):
        idx = np.nonzero(lvl == lev)[0]
        outs.append(rois[idx].astype("float32"))
        order.extend(idx.tolist())
    restore = np.zeros(len(rois), "int32")
    restore[np.asarray(order, int)] = np.arange(len(order))
    return _outs(attrs, MultiFpnRois=outs,
                 RestoreIndex=restore.reshape(-1, 1))


@register_op("collect_fpn_proposals", no_jit=True, dynamic_shape=True)
def _collect_fpn_proposals(ins, attrs):
    """The levels' RoIs merged, the top `post_nms_topN` by score kept."""
    rois = np.concatenate([to_numpy(r) for r in ins["MultiLevelRois"]])
    scores = np.concatenate(
        [to_numpy(s).reshape(-1) for s in ins["MultiLevelScores"]])
    keep = np.argsort(-scores)[:int(attrs.get("post_nms_topN", 1000))]
    return _outs(attrs, FpnRois=rois[keep].astype("float32"))


@register_op("retinanet_detection_output", no_jit=True, dynamic_shape=True)
def _retinanet_detection_output(ins, attrs):
    """Each level's sigmoid scores decoded against its anchors (its top
    `nms_top_k` anchors by best score), every class score above
    `score_threshold` a candidate, then class-wise greedy NMS and the
    best `keep_top_k` overall; Out rows (class, score, box). Where the
    reference's loop ends, the port keeps what it keeps; it also ends on
    a zero-area box, where the reference's never does (ROADMAP Queue 3,
    reference-side)."""
    score_t = float(attrs.get("score_threshold", 0.05))
    nms_t = float(attrs.get("nms_threshold", 0.3))
    keep_k = int(attrs.get("keep_top_k", 100))
    nms_top = int(attrs.get("nms_top_k", 1000))
    dets = []
    for boxes, scores, anchors in zip(
            ins["BBoxes"], ins["Scores"], ins["Anchors"]):
        boxes, scores, anchors = (to_numpy(v) for v in (boxes, scores,
                                                        anchors))
        sc = 1.0 / (1.0 + np.exp(-scores.reshape(-1, scores.shape[-1])))
        dl = boxes.reshape(-1, 4)
        order = np.argsort(-sc.max(1))[:nms_top]
        dec = decode_center(anchors.reshape(-1, 4)[order], dl[order])
        for c in range(sc.shape[1]):
            m = sc[order, c] > score_t
            for b, s in zip(dec[m], sc[order, c][m]):
                dets.append([c, s, *b])
    if not dets:
        return _outs(attrs, Out=np.zeros((1, 6), np.float32))
    dets = np.asarray(dets, "float32")
    final = []
    for c in np.unique(dets[:, 0]):
        dc = dets[dets[:, 0] == c]
        dc = dc[np.argsort(-dc[:, 1])]
        while dc.size:
            final.append(dc[0])
            # the kept row always leaves: the reference keeps it where
            # its IoU with itself is at most nms_threshold (a zero-area
            # box) and never ends
            iou = iou_matrix(dc[0:1, 2:], dc[1:, 2:])[0]
            dc = dc[1:][iou <= nms_t]
    final = np.stack(sorted(final, key=lambda d: -d[1])[:keep_k])
    return _outs(attrs, Out=final)


@register_op("retinanet_target_assign", no_jit=True, dynamic_shape=True)
def _retinanet_target_assign(ins, attrs):
    """RetinaNet's anchor targets: foreground IoU >= positive_overlap (or
    a ground truth's best), background < negative_overlap, the rest
    ignored; TargetLabel the ground truth's class, 0 for background."""
    anchors = _host(ins, "Anchor")
    gt = _host(ins, "GtBoxes")
    gt_labels = _host(ins, "GtLabels").reshape(-1)
    pos_t = float(attrs.get("positive_overlap", 0.5))
    neg_t = float(attrs.get("negative_overlap", 0.4))
    iou = iou_matrix(gt, anchors)
    best = iou.max(0) if len(gt) else np.zeros(anchors.shape[0])
    arg = iou.argmax(0) if len(gt) else np.zeros(anchors.shape[0], int)
    labels = np.full(anchors.shape[0], -1, "int32")
    labels[best < neg_t] = 0
    labels[best >= pos_t] = 1
    if len(gt):
        labels[iou.argmax(1)] = 1
    fg = np.nonzero(labels == 1)[0]
    bg = np.nonzero(labels == 0)[0]
    score_idx = np.concatenate([fg, bg])
    if len(gt):
        tgt_lbl = np.where(labels[score_idx] == 1,
                           gt_labels[arg[score_idx]], 0)[:, None]
    else:
        tgt_lbl = np.zeros((len(score_idx), 1), gt_labels.dtype)
    return _outs(attrs, LocationIndex=fg.astype("int32"),
                 ScoreIndex=score_idx.astype("int32"),
                 TargetLabel=tgt_lbl.astype("int32"),
                 TargetBBox=gt[arg[fg]].astype("float32") if len(gt)
                 else np.zeros((0, 4), "float32"),
                 BBoxInsideWeight=np.ones((len(fg), 4), "float32"),
                 ForegroundNumber=np.asarray([max(len(fg), 1)], "int32"))


@register_op("generate_proposal_labels", no_jit=True, dynamic_shape=True)
def _generate_proposal_labels(ins, attrs):
    """RoIs (the proposals and the ground truths) sampled into labelled
    foreground (IoU >= fg_thresh) and background ([bg_thresh_lo,
    bg_thresh_hi)), `batch_size_per_im` at most, `fg_fraction` of that
    foreground, with their class-wise box targets and weights."""
    rois = _host(ins, "RpnRois")
    gt_classes = _host(ins, "GtClasses").reshape(-1)
    gt_boxes = _host(ins, "GtBoxes")
    batch = int(attrs.get("batch_size_per_im", 256))
    fg_frac = float(attrs.get("fg_fraction", 0.25))
    fg_t = float(attrs.get("fg_thresh", 0.5))
    bg_hi = float(attrs.get("bg_thresh_hi", 0.5))
    bg_lo = float(attrs.get("bg_thresh_lo", 0.0))
    class_num = int(attrs.get("class_nums", 81))
    rng = np.random.RandomState(int(attrs.get("seed", 0)))
    cand = np.concatenate([rois, gt_boxes]) if len(gt_boxes) else rois
    iou = iou_matrix(gt_boxes, cand) if len(gt_boxes) else \
        np.zeros((0, len(cand)))
    best = iou.max(0) if len(gt_boxes) else np.zeros(len(cand))
    arg = iou.argmax(0) if len(gt_boxes) else np.zeros(len(cand), int)
    fg = np.nonzero(best >= fg_t)[0]
    bg = np.nonzero((best < bg_hi) & (best >= bg_lo))[0]
    n_fg = min(int(batch * fg_frac), len(fg))
    fg = rng.choice(fg, n_fg, replace=False) if len(fg) > n_fg else fg
    n_bg = min(batch - len(fg), len(bg))
    bg = rng.choice(bg, n_bg, replace=False) if len(bg) > n_bg else bg
    keep = np.concatenate([fg, bg]).astype(int)
    labels = np.concatenate([gt_classes[arg[fg]],
                             np.zeros(len(bg), gt_classes.dtype)])
    tgt = np.zeros((len(keep), 4), "float32")
    if len(gt_boxes):
        tgt[:len(fg)] = gt_boxes[arg[fg]]
    bbox_targets = np.zeros((len(keep), 4 * class_num), "float32")
    w_in = np.zeros_like(bbox_targets)
    for i in range(len(fg)):
        c = int(labels[i])
        bbox_targets[i, 4 * c:4 * c + 4] = tgt[i]
        w_in[i, 4 * c:4 * c + 4] = 1.0
    return _outs(attrs, Rois=cand[keep].astype("float32"),
                 LabelsInt32=labels.astype("int32")[:, None],
                 BboxTargets=bbox_targets, BboxInsideWeights=w_in,
                 BboxOutsideWeights=(w_in > 0).astype("float32"))


@register_op("roi_perspective_transform")
def _roi_perspective_transform(ins, attrs):
    """Quadrilateral RoIs [R, 8] (tl, tr, br, bl) warped to a fixed
    [transformed_height, transformed_width] grid of image 0: each RoI's
    homography from the grid corners, then bilinear samples."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    oh = int(attrs.get("transformed_height", 8))
    ow = int(attrs.get("transformed_width", 8))
    scale = float(attrs.get("spatial_scale", 1.0))
    dt, dev = x.dtype, x.device
    r = rois.shape[0]
    pts = (rois * scale).reshape(r, 4, 2)
    zero = torch.zeros((r,), dtype=dt, device=dev)
    one = torch.ones((r,), dtype=dt, device=dev)
    rows = []
    for k, (cx, cy) in enumerate(((0.0, 0.0), (ow - 1.0, 0.0),
                                  (ow - 1.0, oh - 1.0), (0.0, oh - 1.0))):
        dx, dy = zero + cx, zero + cy
        sx, sy = pts[:, k, 0], pts[:, k, 1]
        rows.append(torch.stack([dx, dy, one, zero, zero, zero,
                                 -dx * sx, -dy * sx], 1))
        rows.append(torch.stack([zero, zero, zero, dx, dy, one,
                                 -dx * sy, -dy * sy], 1))
    a_mat = torch.stack(rows, 1)                          # [R, 8, 8]
    b_vec = pts.reshape(r, 8)
    eye = torch.eye(8, dtype=dt, device=dev)
    # solve_ex: no check of the factorization on the host (a capture)
    hvec = torch.linalg.solve_ex(a_mat + 1e-8 * eye, b_vec)[0]
    hm = torch.cat([hvec, one[:, None]], 1).reshape(r, 3, 3)
    gy, gx = torch.meshgrid(torch.arange(oh, dtype=dt, device=dev),
                            torch.arange(ow, dtype=dt, device=dev),
                            indexing="ij")
    src = torch.einsum("rij,jhw->rihw", hm,
                       torch.stack([gx, gy, torch.ones_like(gx)]))
    sx = src[:, 0] / (src[:, 2] + 1e-10)
    sy = src[:, 1] / (src[:, 2] + 1e-10)
    out = bilinear_sample(x, sy, sx, torch.zeros((r,), dtype=torch.int64,
                                                 device=dev))
    return {"Out": out}


@register_op("deformable_psroi_pooling")
def _deformable_psroi_pooling(ins, attrs):
    """PSRoI pooling whose bins move by the learned offsets Trans
    [R, 2 * ph * pw] (y then x, times `trans_std` and the RoI's size):
    each bin the mean of `sample_per_part` bilinear samples; with
    output_dim * ph * pw input channels, bin (i, j) of channel k reads
    channel (k, i, j)."""
    x, rois = ins["Input"][0], ins["ROIs"][0]
    trans = ins["Trans"][0] if ins.get("Trans") else None
    ph = int(attrs.get("pooled_height", attrs.get("pooled_size", 7)))
    pw = int(attrs.get("pooled_width", attrs.get("pooled_size", 7)))
    out_c = int(attrs.get("output_dim"))
    scale = float(attrs.get("spatial_scale", 1.0))
    trans_std = float(attrs.get("trans_std", 0.1))
    sample = int(attrs.get("sample_per_part", 4))
    n, c, h, w = x.shape
    r = rois.shape[0]
    dt, dev = x.dtype, x.device
    bi = roi_batch_ids(ins, r, dev)
    x1, y1 = rois[:, 0] * scale, rois[:, 1] * scale
    x2, y2 = rois[:, 2] * scale, rois[:, 3] * scale
    floor = torch.full((), 0.1, dtype=dt, device=dev)
    rw = torch.maximum(x2 - x1, floor)
    rh = torch.maximum(y2 - y1, floor)
    bw, bh = rw / pw, rh / ph
    i = torch.arange(ph, dtype=dt, device=dev)
    j = torch.arange(pw, dtype=dt, device=dev)
    if trans is not None:
        ts = trans.reshape(r, 2, ph, pw)
        off_y = ts[:, 0] * trans_std * rh[:, None, None]
        off_x = ts[:, 1] * trans_std * rw[:, None, None]
    else:
        off_y = off_x = torch.zeros((r, ph, pw), dtype=dt, device=dev)
    sy = y1[:, None, None] + i[None, :, None] * bh[:, None, None] + off_y
    sx = x1[:, None, None] + j[None, None, :] * bw[:, None, None] + off_x
    ss = torch.arange(sample, dtype=dt, device=dev) / sample
    # [R, ph, pw, S]: the reference pairs its y and x steps point by point
    py = sy[..., None] + ss * bh[:, None, None, None]
    px = sx[..., None] + ss * bw[:, None, None, None]
    if c == out_c * ph * pw:
        kk = torch.arange(out_c, device=dev)[:, None, None]
        ch = (kk * ph + torch.arange(ph, device=dev)[:, None]) * pw \
            + torch.arange(pw, device=dev)
    else:
        ch = torch.arange(c, device=dev)[:, None, None].expand(c, ph, pw)
    # one scalar gather a tap over x flat: [R, channels, ph, pw, S]
    flat = x.reshape(-1)
    plane = ((bi[:, None, None, None] * c + ch[None]) * (h * w))[..., None]
    acc = None
    for tap, wt in bilinear_taps(py[:, None], px[:, None], h, w):
        idx = plane + tap
        term = take(flat, idx.reshape(-1), 0).reshape(idx.shape) * wt
        acc = term if acc is None else acc + term
    out = acc.mean(-1)
    return {"Output": out, "TopCount": torch.ones_like(out)}


# -- the helpers --------------------------------------------------------------

@register_op("hsigmoid")
def _hsigmoid(ins, attrs):
    """Hierarchical sigmoid over the complete binary tree of
    `num_classes` leaves: label l's path climbs from node
    l + num_classes - 1 to the root; W [num_classes - 1, D] and Bias
    hold the internal nodes. Out [N, 1] is the path's summed loss."""
    x, w = ins["X"][0], ins["W"][0]
    label = ins["Label"][0].reshape(-1).to(torch.int64)
    num_classes = int(attrs.get("num_classes", w.shape[0] + 1))
    bias = ins["Bias"][0].reshape(-1) if ins.get("Bias") else None
    depth = max(int(np.ceil(np.log2(max(num_classes, 2)))), 1)
    node = label + num_classes - 1
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    total = 0
    for _ in range(depth):
        parent = torch.div(node - 1, 2, rounding_mode="floor")
        is_right = torch.remainder(node, 2) == 0
        valid = node > 0
        row = torch.clamp(parent, 0, w.shape[0] - 1)
        s = torch.einsum("nd,nd->n", x, take(w, row, 0))
        if bias is not None:
            s = s + take(bias, torch.clamp(parent, 0, bias.shape[0] - 1), 0)
        sign = torch.where(is_right, -1.0, 1.0).to(x.dtype)
        total = total + torch.where(valid, -F.logsigmoid(sign * s), zero)
        node = parent
    return {"Out": total[:, None],
            "PreOut": torch.zeros((x.shape[0], depth), dtype=x.dtype,
                                  device=x.device)}


@register_op("sampled_softmax_with_cross_entropy", rng="device")
def _sampled_softmax_with_cross_entropy(ins, attrs):
    """`sample_logits`, then the mean over the true labels of their
    negative log softmax over the sampled logits."""
    outs = get_op("sample_logits").compute(
        {"Logits": ins["Logits"], "Labels": ins["Label"]}, dict(attrs))
    sl = outs["SampledLogits"]
    nt = ins["Label"][0].shape[1]
    logp = F.log_softmax(sl, -1)
    loss = -logp[:, :nt].sum(-1, keepdim=True) / nt
    return {"Loss": loss, "Softmax": torch.exp(logp)}


@register_op("random_crop", rng="device")
def _random_crop(ins, attrs):
    """X's trailing dims cropped to `shape` at starts drawn uniformly
    from the op's device seed (one stream an axis)."""
    x = ins["X"][0]
    shape = [int(s) for s in attrs["shape"]]
    nd = len(shape)
    out = x
    for i, s in enumerate(shape):
        axis = x.ndim - nd + i
        span = max(x.shape[axis] - s, 0) + 1
        start = (device_bits(attrs["_rng_seed"], (1,), i) * span) >> 32
        idx = start + torch.arange(s, device=x.device)
        out = take(out, idx, axis)
    return {"Out": out,
            "SeedOut": torch.zeros((1,), dtype=to_torch_dtype("int64"),
                                   device=x.device)}


@register_op("similarity_focus", no_jit=True)
def _similarity_focus(ins, attrs):
    """For each selected slice along `axis` (1, 2 or 3), the largest
    values taken greedily so that each row and column is used once
    (min(B, C) picks), marked 1, OR-ed over `indexes` and broadcast back
    to X's shape."""
    x = _host(ins, "X")                                # [N, A, B, C]
    axis = int(attrs.get("axis", 1))
    indexes = list(attrs.get("indexes", [0]))
    if axis not in (1, 2, 3):
        raise ValueError(
            "similarity_focus: axis must be 1, 2 or 3 (reference "
            "similarity_focus_op.cc:28)")
    perm = [0, axis] + [d for d in (1, 2, 3) if d != axis]
    xt = np.transpose(x, perm)                         # [N, K, B, C]
    n, _, b, c = xt.shape
    mark = np.zeros((n, 1, b, c), x.dtype)
    for bi in range(n):
        for idx in indexes:
            t = xt[bi, idx]
            order = np.argsort(-t, axis=None, kind="stable")
            used_r = np.zeros(b, bool)
            used_c = np.zeros(c, bool)
            picked = 0
            for pos in order:
                r, col = divmod(int(pos), c)
                if used_r[r] or used_c[col]:
                    continue
                mark[bi, 0, r, col] = 1
                used_r[r] = used_c[col] = True
                picked += 1
                if picked == min(b, c):
                    break
    out = np.broadcast_to(mark, xt.shape)
    return _outs(attrs, Out=np.ascontiguousarray(
        np.transpose(out, np.argsort(perm))))


@register_op("add_position_encoding")
def _add_position_encoding(ins, attrs):
    """alpha * X + beta * the sinusoid: sin then cos over d // 2
    frequencies (not interleaved), zero-padded to an odd D."""
    x = ins["X"][0]                                    # [B, T, D]
    alpha = float(attrs.get("alpha", 1.0))
    beta = float(attrs.get("beta", 1.0))
    _, t, d = x.shape
    dev = x.device
    pos = torch.arange(t, dtype=torch.float32, device=dev)[:, None]
    half = d // 2
    freq = torch.pow(torch.full((), 10000.0, device=dev),
                     -torch.arange(half, dtype=torch.float32, device=dev)
                     / max(half, 1))
    ang = pos * freq[None, :]
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], 1)
    if enc.shape[1] < d:
        enc = F.pad(enc, (0, d - enc.shape[1]))
    return {"Out": alpha * x + beta * enc[None].to(x.dtype)}


@register_op("box_decoder_and_assign")
def _box_decoder_and_assign(ins, attrs):
    """TargetBox [N, C * 4] decoded against PriorBox [N, 4] (dw and dh
    clamped at `box_clip`), and each row's box of its best class past
    the background (the first on a tie)."""
    prior = ins["PriorBox"][0]
    pvar = ins["PriorBoxVar"][0]
    tb = ins["TargetBox"][0]
    score = ins["BoxScore"][0]
    clip = float(attrs.get("box_clip", 4.135))
    n = tb.shape[0]
    c = tb.shape[1] // 4
    deltas = tb.reshape(n, c, 4)
    if pvar.ndim == 1:
        pvar = pvar[None, :].expand(n, 4)
    pw = prior[:, 2] - prior[:, 0] + 1.0
    ph = prior[:, 3] - prior[:, 1] + 1.0
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    d = deltas * pvar[:, None, :]
    dw = torch.clamp(d[..., 2], -clip, clip)
    dh = torch.clamp(d[..., 3], -clip, clip)
    cx = d[..., 0] * pw[:, None] + pcx[:, None]
    cy = d[..., 1] * ph[:, None] + pcy[:, None]
    w = torch.exp(dw) * pw[:, None]
    h = torch.exp(dh) * ph[:, None]
    dec = torch.stack([cx - w * 0.5, cy - h * 0.5,
                       cx + w * 0.5 - 1.0, cy + h * 0.5 - 1.0], -1)
    best = torch.argmax(score[:, 1:], dim=1) + 1
    rows = torch.arange(n, device=tb.device) * c + best
    return {"DecodeBox": dec.reshape(n, c * 4),
            "OutputAssignBox": take(dec.reshape(n * c, 4), rows, 0)}


@register_op("mine_hard_examples", no_jit=True, dynamic_shape=True)
def _mine_hard_examples(ins, attrs):
    """SSD's hard-negative mining. max_negative: the unmatched priors
    under `neg_dist_threshold`, hardest first, `neg_pos_ratio` times the
    positives at most; hard_example: every prior ranked by its class
    (and location) loss, `sample_size` at most, the unselected positives'
    matches erased. NegIndices [K, 1], NegIndicesLod [N + 1] offsets,
    UpdatedMatchIndices."""
    cls_loss = _host(ins, "ClsLoss")
    loc_loss = _host(ins, "LocLoss") if ins.get("LocLoss") else None
    match_indices = _host(ins, "MatchIndices").copy()
    match_dist = _host(ins, "MatchDist")
    neg_pos_ratio = float(attrs.get("neg_pos_ratio", 1.0))
    neg_dist_threshold = float(attrs.get("neg_dist_threshold", 0.5))
    sample_size = int(attrs.get("sample_size", 0))
    mining_type = attrs.get("mining_type", "max_negative")
    batch, prior_num = match_indices.shape
    neg_all, starts = [], [0]
    for n in range(batch):
        if mining_type == "max_negative":
            eligible = [m for m in range(prior_num)
                        if match_indices[n, m] == -1
                        and match_dist[n, m] < neg_dist_threshold]
        else:
            eligible = list(range(prior_num))
        losses = cls_loss[n]
        if mining_type == "hard_example" and loc_loss is not None:
            losses = losses + loc_loss[n]
        eligible.sort(key=lambda m: -losses[m])
        if mining_type == "max_negative":
            num_pos = int((match_indices[n] != -1).sum())
            neg_sel = min(int(num_pos * neg_pos_ratio), len(eligible))
        else:
            neg_sel = min(sample_size, len(eligible))
        sel = set(eligible[:neg_sel])
        if mining_type == "hard_example":
            neg = []
            for m in range(prior_num):
                if match_indices[n, m] > -1:
                    if m not in sel:
                        match_indices[n, m] = -1
                elif m in sel:
                    neg.append(m)
        else:
            neg = sorted(sel)
        neg_all.extend(neg)
        starts.append(len(neg_all))
    return _outs(attrs,
                 NegIndices=np.asarray(neg_all, np.int32).reshape(-1, 1),
                 NegIndicesLod=np.asarray(starts, np.int64),
                 UpdatedMatchIndices=match_indices)


def _lod(ins, slot, n):
    """An offsets input as ints, or [0, n] without it."""
    return to_numpy(ins[slot][0]).reshape(-1).astype(int) \
        if ins.get(slot) else np.asarray([0, n])


def _ap(tp, fp, num_pos, ap_type):
    """The average precision of one class's (score, flag) lists."""
    tp = sorted(tp, key=lambda p: -p[0])
    fp = sorted(fp, key=lambda p: -p[0])
    tp_sum = np.cumsum([c for _, c in tp])
    fp_sum = np.cumsum([c for _, c in fp])
    precision = tp_sum / np.maximum(tp_sum + fp_sum, 1e-12)
    recall = tp_sum / float(num_pos)
    if ap_type == "11point":
        max_precisions = np.zeros(11)
        start_idx = len(tp_sum) - 1
        for j in range(10, -1, -1):
            for i in range(start_idx, -1, -1):
                if recall[i] < j / 10.0:
                    start_idx = i
                    if j > 0:
                        max_precisions[j - 1] = max_precisions[j]
                    break
                if max_precisions[j] < precision[i]:
                    max_precisions[j] = precision[i]
        return max_precisions.sum() / 11.0
    ap, prev_recall = 0.0, 0.0
    for p, r in zip(precision, recall):
        if abs(r - prev_recall) > 1e-6:
            ap += p * abs(r - prev_recall)
        prev_recall = r
    return ap


@register_op("detection_map", no_jit=True, dynamic_shape=True)
def _detection_map(ins, attrs):
    """Detection mAP (reference: detection_map_op.h). DetectRes rows
    (label, score, x1, y1, x2, y2); Label rows (label, x1, y1, x2, y2) or
    (label, difficult, x1, y1, x2, y2); images split by DetectResLod and
    LabelLod offsets (one image without them). With HasState[0] != 0 the
    streaming state enters through PosCount, TruePos, FalsePos and their
    per-class *Lod offsets, and leaves through the Accum* outputs."""
    detect = _host(ins, "DetectRes").astype(np.float32)
    label = _host(ins, "Label").astype(np.float32)
    d_lod = _lod(ins, "DetectResLod", len(detect))
    l_lod = _lod(ins, "LabelLod", len(label))
    overlap_threshold = float(attrs.get("overlap_threshold", 0.5))
    evaluate_difficult = bool(attrs.get("evaluate_difficult", True))
    ap_type = attrs.get("ap_type", "integral")
    class_num = int(attrs["class_num"])
    background = int(attrs.get("background_label", 0))

    pos_count = {}
    true_pos = collections.defaultdict(list)
    false_pos = collections.defaultdict(list)
    has_state = (int(_host(ins, "HasState").reshape(-1)[0])
                 if ins.get("HasState") else 0)
    if has_state and ins.get("PosCount"):
        pc = _host(ins, "PosCount").reshape(-1)
        for c in range(min(class_num, len(pc))):
            if pc[c]:
                pos_count[c] = int(pc[c])
        for key, slot in (("TruePos", true_pos), ("FalsePos", false_pos)):
            if not ins.get(key):
                continue
            arr = _host(ins, key).astype(np.float32).reshape(-1, 2)
            lod = _lod(ins, key + "Lod", len(arr))
            for c in range(len(lod) - 1):
                for r in arr[lod[c]:lod[c + 1]]:
                    slot[c].append((float(r[0]), int(r[1])))

    has_difficult = label.shape[1] == 6 if len(label) else False
    for n in range(len(l_lod) - 1):
        gts = {}
        for i in range(l_lod[n], l_lod[n + 1]):
            row = label[i]
            if has_difficult:
                box, difficult = row[2:6], bool(abs(row[1]) > 1e-6)
            else:
                box, difficult = row[1:5], False
            gts.setdefault(int(row[0]), []).append((box, difficult))
        for cls, items in gts.items():
            cnt = len(items) if evaluate_difficult else \
                sum(1 for _, d in items if not d)
            if cnt:
                pos_count[cls] = pos_count.get(cls, 0) + cnt
        dets = {}
        for i in range(d_lod[n], d_lod[n + 1]):
            row = detect[i]
            dets.setdefault(int(row[0]), []).append(
                (float(row[1]), row[2:6]))
        for cls, preds in dets.items():
            if cls not in gts:
                for score, _ in preds:
                    true_pos[cls].append((score, 0))
                    false_pos[cls].append((score, 1))
                continue
            matched = gts[cls]
            visited = [False] * len(matched)
            for score, box in sorted(preds, key=lambda p: -p[0]):
                box = np.clip(box, 0.0, 1.0)  # the predicted box only
                overlaps = [iou_matrix(box[None], mb[None])[0, 0]
                            for mb, _d in matched]
                max_idx = int(np.argmax(overlaps)) if overlaps else 0
                max_ov = overlaps[max_idx] if overlaps else -1.0
                hit = max_ov > overlap_threshold
                if hit and not (evaluate_difficult
                                or not matched[max_idx][1]):
                    continue
                first = hit and not visited[max_idx]
                true_pos[cls].append((score, int(first)))
                false_pos[cls].append((score, int(not first)))
                if first:
                    visited[max_idx] = True

    m_ap, count = 0.0, 0
    for cls, num_pos in pos_count.items():
        if cls == background:
            continue
        if true_pos.get(cls):
            m_ap += _ap(true_pos[cls], false_pos.get(cls, []), num_pos,
                        ap_type)
        count += 1
    if count:
        m_ap /= count

    out_pc = np.zeros((class_num, 1), np.int32)
    for c, v in pos_count.items():
        if 0 <= c < class_num:
            out_pc[c, 0] = v
    tp_rows, fp_rows, tp_lod, fp_lod = [], [], [0], [0]
    for c in range(class_num):
        tp_rows += [[s, v] for s, v in true_pos[c]]
        tp_lod.append(len(tp_rows))
        fp_rows += [[s, v] for s, v in false_pos[c]]
        fp_lod.append(len(fp_rows))
    return _outs(
        attrs, MAP=np.asarray([m_ap], np.float32), AccumPosCount=out_pc,
        AccumTruePos=np.asarray(tp_rows, np.float32).reshape(-1, 2),
        AccumTruePosLod=np.asarray(tp_lod, np.int64),
        AccumFalsePos=np.asarray(fp_rows, np.float32).reshape(-1, 2),
        AccumFalsePosLod=np.asarray(fp_lod, np.int64))


def poly_to_mask(xy, m):
    """Even-odd rasterization of one polygon [k, 2] onto an [m, m] grid
    at pixel centres (the port's own copy of the reference's
    `_poly2mask_grid`)."""
    px = np.arange(m) + 0.5
    gx, gy = np.meshgrid(px, px)
    inside = np.zeros((m, m), bool)
    x0, y0 = xy[:, 0], xy[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    for ax, ay, bx, by in zip(x0, y0, x1, y1):
        if ay == by:
            continue
        cond = (ay > gy) != (by > gy)
        xint = ax + (gy - ay) * (bx - ax) / (by - ay)
        inside ^= cond & (gx < xint)
    return inside


@register_op("generate_mask_labels", no_jit=True, dynamic_shape=True)
def _generate_mask_labels(ins, attrs):
    """Mask R-CNN's mask targets for one image: each foreground RoI takes
    the ground truth whose polygons' box it overlaps most, whose
    polygons are rasterized in the RoI at `resolution`; MaskInt32
    [P, num_classes * M * M] holds them in the RoI's class slot, -1
    elsewhere. The polygons ride GtSegms [S, 2] with GtSegmsPolyLod
    (polygons a ground truth) and GtSegmsPointLod (points a polygon)."""
    im_info = _host(ins, "ImInfo").astype(np.float32).reshape(-1)
    gt_classes = _host(ins, "GtClasses").reshape(-1).astype(int)
    is_crowd = _host(ins, "IsCrowd").reshape(-1).astype(int)
    segms = _host(ins, "GtSegms").astype(np.float32).reshape(-1, 2)
    rois = _host(ins, "Rois").astype(np.float32).reshape(-1, 4)
    labels = _host(ins, "LabelsInt32").reshape(-1).astype(int)
    if not ins.get("GtSegmsPolyLod") or not ins.get("GtSegmsPointLod"):
        raise ValueError(
            "generate_mask_labels: wire GtSegmsPolyLod (per-gt polygon "
            "offsets) and GtSegmsPointLod (per-polygon point offsets) — "
            "the padded representation carries the reference's 3-level "
            "GtSegms LoD through these inputs")
    poly_lod = _host(ins, "GtSegmsPolyLod").reshape(-1).astype(int)
    point_lod = _host(ins, "GtSegmsPointLod").reshape(-1).astype(int)
    num_classes = int(attrs["num_classes"])
    m = int(attrs["resolution"])
    im_scale = float(im_info[2]) if im_info.size >= 3 else 1.0

    gt_polys = [[segms[point_lod[j]:point_lod[j + 1]]
                 for j in range(poly_lod[i], poly_lod[i + 1])]
                for i in range(len(gt_classes))
                if gt_classes[i] > 0 and is_crowd[i] == 0]
    fg_inds = [i for i in range(len(labels)) if labels[i] > 0]
    if fg_inds and gt_polys:
        boxes_from_polys = np.asarray(
            [[min(p[:, 0].min() for p in ps),
              min(p[:, 1].min() for p in ps),
              max(p[:, 0].max() for p in ps),
              max(p[:, 1].max() for p in ps)] for ps in gt_polys],
            np.float32)
        rois_fg = rois[fg_inds] / im_scale
        fg_mask_inds = iou_matrix(rois_fg, boxes_from_polys).argmax(axis=1)
        masks = np.zeros((len(fg_inds), m * m), np.int32)
        cls_labels = labels[np.asarray(fg_inds)]
        for i, gt_i in enumerate(fg_mask_inds):
            x0, y0, x1, y1 = rois_fg[i]
            w = max(x1 - x0, 1.0)
            h = max(y1 - y0, 1.0)
            acc = np.zeros((m, m), bool)
            for poly in gt_polys[gt_i]:
                p = np.stack([(poly[:, 0] - x0) * m / w,
                              (poly[:, 1] - y0) * m / h], axis=1)
                acc |= poly_to_mask(p, m)
            masks[i] = acc.astype(np.int32).reshape(-1)
        roi_has_mask = list(fg_inds)
        rois_out = rois_fg * im_scale
    else:
        # no foreground: one background RoI with an all-ignore mask
        bg = next((i for i in range(len(labels)) if labels[i] == 0), 0)
        rois_out = rois[bg:bg + 1].copy() if len(rois) else \
            np.zeros((1, 4), np.float32)
        masks = np.full((1, m * m), -1, np.int32)
        cls_labels = np.asarray([0])
        roi_has_mask = [bg]
    expand = np.full((len(masks), num_classes * m * m), -1, np.int32)
    for i, cls in enumerate(np.asarray(cls_labels).reshape(-1)):
        if cls > 0:
            expand[i, cls * m * m:(cls + 1) * m * m] = masks[i]
    return _outs(attrs, MaskRois=rois_out.astype(np.float32),
                 RoiHasMaskInt32=np.asarray(roi_has_mask,
                                            np.int32).reshape(-1, 1),
                 MaskInt32=expand)
