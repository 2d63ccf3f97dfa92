"""Detection operators (counterpart: `paddle_tpu/ops/detection_ops.py`):
`iou_similarity`, `box_clip`, `box_coder`, `prior_box`,
`density_prior_box`, `anchor_generator`, `yolo_box`, `roi_align`,
`roi_pool`, and the four NMS types `multiclass_nms`, `multiclass_nms2`,
`locality_aware_nms` and `matrix_nms` (reference:
paddle/fluid/operators/detection/).

`prior_box`, `density_prior_box` and `anchor_generator` depend only on
their inputs' shapes and attrs, and are built on the input's device.
`yolo_box` follows the reference's formula: no `clip_bbox` or
`scale_x_y`, the `conf_thresh` mask multiplied in, scores laid out
[N, M*H*W, C]. `roi_align` and `roi_pool` read image 0 only, as the
reference does, and `roi_pool` takes the maximum over an 8 x 8 sample
grid a bin, not Paddle's exact bin maximum (ROADMAP Queue 3,
reference-side); `Argmax` is zeros. Their gathers' gradients are summed
in a fixed order (`interp_ops.take`).

The NMS types run on the host (`no_jit`, with a value-dependent output
count), so a block holding one runs eagerly (`fluid/lowering.py
capture_blocker` names it). Each class's IoUs are computed once in
float64 with numpy, for the pairs of candidates that overlap (a sweep
over x1; every other pair's IoU is exactly 0); the greedy pass keeps a
candidate iff its largest IoU with the boxes kept so far is at most the
adaptive threshold (`nms_eta`), which is the reference's pairwise loop
(`_greedy_select` over `_np_iou_pair`) in the same order and with the
same values, without its O(k^2) Python calls a class. As in the
reference, `nms_top_k` cuts the sorted candidates with `[:nms_top_k]`
(so -1 drops the last; ROADMAP Queue 3, reference-side).
"""
from __future__ import annotations

import numpy as np
import torch

from .interp_ops import consts, f32, take
from .registry import register_op
from ..core.types import from_numpy, to_numpy


@register_op("iou_similarity")
def _iou_similarity(ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]  # [n, 4], [m, 4] xyxy
    area_x = (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    area_y = (y[:, 2] - y[:, 0]) * (y[:, 3] - y[:, 1])
    lt = torch.maximum(x[:, None, :2], y[None, :, :2])
    rb = torch.minimum(x[:, None, 2:], y[None, :, 2:])
    wh = torch.maximum(rb - lt, torch.zeros((), dtype=x.dtype,
                                            device=x.device))
    inter = wh[..., 0] * wh[..., 1]
    return {"Out": inter / (area_x[:, None] + area_y[None, :] - inter)}


@register_op("box_clip")
def _box_clip(ins, attrs):
    """Clips each corner into image 0's [0, w - 1] x [0, h - 1]."""
    boxes, im_info = ins["Input"][0], ins["ImInfo"][0]
    h = im_info[0, 0] - 1.0
    w = im_info[0, 1] - 1.0
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi)

    return {"Output": torch.stack(
        [clip(boxes[..., 0], w), clip(boxes[..., 1], h),
         clip(boxes[..., 2], w), clip(boxes[..., 3], h)], -1)}


@register_op("box_coder")
def _box_coder(ins, attrs):
    """Center-size encoding of TargetBox [n, 4] against PriorBox [p, 4]
    ([n, p, 4] out), or decoding of TargetBox [n, p, 4]; PriorBoxVar
    [p, 4] divides (encode) or scales (decode) the deltas."""
    prior, tb = ins["PriorBox"][0], ins["TargetBox"][0]
    code_type = attrs.get("code_type", "encode_center_size")
    var = ins["PriorBoxVar"][0] if ins.get("PriorBoxVar") else None
    one = 0.0 if attrs.get("box_normalized", True) else 1.0
    pw = prior[:, 2] - prior[:, 0] + one
    ph = prior[:, 3] - prior[:, 1] + one
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    if code_type.startswith("encode"):
        tw = tb[:, 2] - tb[:, 0] + one
        th = tb[:, 3] - tb[:, 1] + one
        tcx = tb[:, 0] + tw * 0.5
        tcy = tb[:, 1] + th * 0.5
        out = torch.stack([(tcx[:, None] - pcx[None, :]) / pw[None, :],
                           (tcy[:, None] - pcy[None, :]) / ph[None, :],
                           torch.log(tw[:, None] / pw[None, :]),
                           torch.log(th[:, None] / ph[None, :])], -1)
        if var is not None:
            out = out / var[None, :, :]
        return {"OutputBox": out}
    d = tb if var is None else tb * var[None, :, :]
    cx = d[..., 0] * pw[None, :] + pcx[None, :]
    cy = d[..., 1] * ph[None, :] + pcy[None, :]
    w = torch.exp(d[..., 2]) * pw[None, :]
    h = torch.exp(d[..., 3]) * ph[None, :]
    return {"OutputBox": torch.stack(
        [cx - w * 0.5, cy - h * 0.5, cx + w * 0.5 - one,
         cy + h * 0.5 - one], -1)}


def _grid(fh, fw, offset, sw, sh, device):
    """The cell centres [fh, fw] (y, x), in float32 on `device`."""
    cx = (torch.arange(fw, dtype=torch.float32, device=device)
          + f32(offset)) * f32(sw)
    cy = (torch.arange(fh, dtype=torch.float32, device=device)
          + f32(offset)) * f32(sh)
    return torch.meshgrid(cy, cx, indexing="ij")


def _variances(out, variances, slot="Boxes"):
    """{slot: out, "Variances": the variances broadcast to out's shape},
    made on out's device by a fill, never copied from the host."""
    var = consts(variances, out.device, out.dtype)
    return {slot: out, "Variances": var.expand(out.shape).contiguous()}


@register_op("prior_box")
def _prior_box(ins, attrs):
    """SSD priors [fh, fw, num_priors, 4], normalized by the image size,
    and their variances."""
    inp, image = ins["Input"][0], ins["Image"][0]
    min_sizes = attrs["min_sizes"]
    max_sizes = attrs.get("max_sizes", [])
    fh, fw = inp.shape[2], inp.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    sw = attrs.get("step_w", 0.0) or iw / fw
    sh = attrs.get("step_h", 0.0) or ih / fh
    ars = [1.0]
    for ar in attrs.get("aspect_ratios", [1.0]):
        if all(abs(ar - a) > 1e-6 for a in ars):
            ars.append(ar)
            if attrs.get("flip", False):
                ars.append(1.0 / ar)
    boxes = []
    for ms in min_sizes:
        for ar in ars:
            boxes.append((ms * np.sqrt(ar) / 2.0, ms / np.sqrt(ar) / 2.0))
        if max_sizes:
            s = np.sqrt(ms * max_sizes[min_sizes.index(ms)]) / 2.0
            boxes.append((s, s))
    gy, gx = _grid(fh, fw, attrs.get("offset", 0.5), sw, sh, inp.device)
    out = torch.stack([torch.stack(
        [(gx - f32(bw)) / f32(iw), (gy - f32(bh)) / f32(ih),
         (gx + f32(bw)) / f32(iw), (gy + f32(bh)) / f32(ih)], -1)
        for bw, bh in boxes], 2)
    if attrs.get("clip", False):
        out = out.clamp(0.0, 1.0)
    return _variances(out, attrs.get("variances", [0.1, 0.1, 0.2, 0.2]))


@register_op("density_prior_box")
def _density_prior_box(ins, attrs):
    """Density priors: each fixed size and ratio tiled density x density
    times within its cell."""
    inp, image = ins["Input"][0], ins["Image"][0]
    fh, fw = inp.shape[2], inp.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    boxes = []
    for size, density in zip(attrs.get("fixed_sizes", []),
                             attrs.get("densities", [1])):
        for ratio in attrs.get("fixed_ratios", [1.0]):
            bw = size * np.sqrt(ratio)
            bh = size / np.sqrt(ratio)
            step = size / density
            for di in range(density):
                for dj in range(density):
                    boxes.append((-size / 2.0 + step / 2.0 + dj * step,
                                  -size / 2.0 + step / 2.0 + di * step,
                                  bw / 2.0, bh / 2.0))
    gy, gx = _grid(fh, fw, attrs.get("offset", 0.5), iw / fw, ih / fh,
                   inp.device)
    out = []
    for ox, oy, bw, bh in boxes:
        ccx, ccy = gx + f32(ox), gy + f32(oy)
        out.append(torch.stack(
            [(ccx - f32(bw)) / f32(iw), (ccy - f32(bh)) / f32(ih),
             (ccx + f32(bw)) / f32(iw), (ccy + f32(bh)) / f32(ih)], -1))
    out = torch.stack(out, 2)
    if attrs.get("clip", False):
        out = out.clamp(0.0, 1.0)
    return _variances(out, attrs.get("variances", [0.1, 0.1, 0.2, 0.2]))


@register_op("anchor_generator")
def _anchor_generator(ins, attrs):
    """Faster R-CNN anchors [fh, fw, sizes x ratios, 4] in pixels."""
    inp = ins["Input"][0]
    stride = attrs.get("stride", [16.0, 16.0])
    boxes = []
    for size in attrs.get("anchor_sizes", [64.0]):
        for ar in attrs.get("aspect_ratios", [1.0]):
            w = np.sqrt(size * size / ar)
            boxes.append((w / 2.0, w * ar / 2.0))
    gy, gx = _grid(inp.shape[2], inp.shape[3], attrs.get("offset", 0.5),
                   stride[0], stride[1], inp.device)
    out = torch.stack([torch.stack(
        [gx - f32(bw), gy - f32(bh), gx + f32(bw), gy + f32(bh)], -1)
        for bw, bh in boxes], 2)
    return _variances(out, attrs.get("variances", [0.1, 0.1, 0.2, 0.2]),
                      "Anchors")


@register_op("yolo_box")
def _yolo_box(ins, attrs):
    """YOLOv3 decoding: Boxes [N, M*H*W, 4] in pixels of ImgSize (h, w),
    Scores [N, M*H*W, C], the class probabilities times the objectness
    where it reaches `conf_thresh`, else 0."""
    x, img_size = ins["X"][0], ins["ImgSize"][0]
    anchors = attrs["anchors"]
    class_num = attrs["class_num"]
    downsample = attrs.get("downsample_ratio", 32)
    n, _, h, w = x.shape
    an_num = len(anchors) // 2
    x5 = x.reshape(n, an_num, 5 + class_num, h, w)
    grid_x = torch.arange(w, dtype=x.dtype, device=x.device).reshape(
        1, 1, 1, w)
    grid_y = torch.arange(h, dtype=x.dtype, device=x.device).reshape(
        1, 1, h, 1)
    pred_x = (torch.sigmoid(x5[:, :, 0]) + grid_x) / w
    pred_y = (torch.sigmoid(x5[:, :, 1]) + grid_y) / h
    aw = consts(anchors[0::2], x.device, x.dtype)
    ah = consts(anchors[1::2], x.device, x.dtype)
    pred_w = torch.exp(x5[:, :, 2]) * aw.reshape(1, an_num, 1, 1) \
        / (downsample * w)
    pred_h = torch.exp(x5[:, :, 3]) * ah.reshape(1, an_num, 1, 1) \
        / (downsample * h)
    conf = torch.sigmoid(x5[:, :, 4])
    keep = (conf >= f32(attrs.get("conf_thresh", 0.01))).to(x.dtype)
    imh = img_size[:, 0].reshape(n, 1, 1, 1).to(x.dtype)
    imw = img_size[:, 1].reshape(n, 1, 1, 1).to(x.dtype)
    boxes = torch.stack([(pred_x - pred_w / 2.0) * imw,
                         (pred_y - pred_h / 2.0) * imh,
                         (pred_x + pred_w / 2.0) * imw,
                         (pred_y + pred_h / 2.0) * imh], -1)
    probs = torch.sigmoid(x5[:, :, 5:]) * (conf * keep)[:, :, None]
    return {"Boxes": boxes.reshape(n, -1, 4),
            "Scores": probs.permute(0, 1, 3, 4, 2).reshape(n, -1,
                                                           class_num)}


def _sample(feat, yy, xx, h, w):
    """feat [c, h, w] at the cells (clip(yy), clip(xx)) of the float
    grids yy [R, a] and xx [R, b]: [c, R, a, b], gathered through one
    flat index so the gradient is summed in a fixed order."""
    yi = torch.clamp(yy, 0, h - 1).to(torch.int64)
    xi = torch.clamp(xx, 0, w - 1).to(torch.int64)
    flat = (yi[:, :, None] * w + xi[:, None, :])
    c = feat.shape[0]
    return take(feat.reshape(c, h * w), flat.reshape(-1), 1).reshape(
        (c,) + tuple(flat.shape))


@register_op("roi_align")
def _roi_align(ins, attrs):
    """The mean of ratio x ratio bilinear samples a bin (ratio 2 where
    `sampling_ratio` <= 0), over image 0."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    ph = attrs.get("pooled_height", 1)
    pw = attrs.get("pooled_width", 1)
    scale = f32(attrs.get("spatial_scale", 1.0))
    ratio = attrs.get("sampling_ratio", -1)
    ratio = 2 if ratio <= 0 else ratio
    _, c, h, w = x.shape
    num_rois = rois.shape[0]
    x1, y1 = rois[:, 0] * scale, rois[:, 1] * scale
    x2, y2 = rois[:, 2] * scale, rois[:, 3] * scale
    one = torch.ones((), dtype=rois.dtype, device=rois.device)
    bw = torch.maximum(x2 - x1, one) / pw
    bh = torch.maximum(y2 - y1, one) / ph

    def taps(bins):
        return (torch.arange(bins, device=x.device)[:, None]
                + (torch.arange(ratio, dtype=torch.float32,
                                device=x.device)[None, :] + 0.5)
                / ratio).reshape(-1)

    sy = y1[:, None] + bh[:, None] * taps(ph)[None, :]
    sx = x1[:, None] + bw[:, None] * taps(pw)[None, :]
    y0f, x0f = torch.floor(sy), torch.floor(sx)
    wy1 = (sy - y0f)[None, :, :, None]
    wx1 = (sx - x0f)[None, :, None, :]
    feat = x[0]
    val = (_sample(feat, y0f, x0f, h, w) * (1 - wy1) * (1 - wx1)
           + _sample(feat, y0f, x0f + 1, h, w) * (1 - wy1) * wx1
           + _sample(feat, y0f + 1, x0f, h, w) * wy1 * (1 - wx1)
           + _sample(feat, y0f + 1, x0f + 1, h, w) * wy1 * wx1)
    val = val.reshape(c, num_rois, ph, ratio, pw, ratio)
    return {"Out": val.mean(dim=(3, 5)).permute(1, 0, 2, 3)}


@register_op("roi_pool")
def _roi_pool(ins, attrs):
    """The maximum over an 8 x 8 grid of samples a bin, over image 0;
    Argmax zeros."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    ph = attrs.get("pooled_height", 1)
    pw = attrs.get("pooled_width", 1)
    scale = f32(attrs.get("spatial_scale", 1.0))
    _, c, h, w = x.shape
    num_rois = rois.shape[0]
    x1, y1 = torch.round(rois[:, 0] * scale), torch.round(rois[:, 1] * scale)
    x2, y2 = torch.round(rois[:, 2] * scale), torch.round(rois[:, 3] * scale)
    one = torch.ones((), dtype=rois.dtype, device=rois.device)
    rw = torch.maximum(x2 - x1 + 1, one)
    rh = torch.maximum(y2 - y1 + 1, one)
    gh, gw = ph * 8, pw * 8

    def grid(n):
        return torch.arange(n, dtype=torch.float32, device=x.device)[None, :]

    yy = y1[:, None] + (grid(gh) + 0.5) * rh[:, None] / gh
    xx = x1[:, None] + (grid(gw) + 0.5) * rw[:, None] / gw
    vals = _sample(x[0], torch.floor(yy), torch.floor(xx), h, w)
    out = torch.amax(vals.reshape(c, num_rois, ph, 8, pw, 8),
                     dim=(3, 5)).permute(1, 0, 2, 3)
    return {"Out": out, "Argmax": torch.zeros(out.shape, dtype=torch.int32,
                                              device=x.device)}


# -- non-maximum suppression on the host ----------------------------------

def iou_matrix(a, b, normalized=True):
    """The IoU matrix [n, m] of corner boxes a [n, 4] and b [m, 4] in
    their dtype (the greedy types pass float64, as the reference's pair
    IoU computes; `matrix_nms` float32, as it does); `normalized` False
    adds the reference's +1 to extents (integer pixel coordinates,
    nms_util.h JaccardOverlap). The port's own copy of the reference's
    `detection_extra_ops._np_iou_xyxy`."""
    off = 0.0 if normalized else 1.0
    area_a = np.maximum(a[:, 2] - a[:, 0] + off, 0) * \
        np.maximum(a[:, 3] - a[:, 1] + off, 0)
    area_b = np.maximum(b[:, 2] - b[:, 0] + off, 0) * \
        np.maximum(b[:, 3] - b[:, 1] + off, 0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt + off, 0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter,
                              1e-10)


def _overlap_pairs(b, normalized):
    """The pairs (i, j, iou) of boxes b [n, 4] (float64) with a positive
    intersection, each once, the IoU computed by `iou_matrix`'s formula
    (so equal to its entry). A sweep over the boxes sorted by x1 lists
    the pairs that can overlap in x (with slack), then the exact
    overlaps keep the rest; every other pair's IoU is exactly 0."""
    n = len(b)
    off = 0.0 if normalized else 1.0
    x1, y1, x2, y2 = (np.ascontiguousarray(b[:, k]) for k in range(4))
    order = np.argsort(x1, kind="stable")
    bound = x2[order] + off
    end = np.searchsorted(x1[order], bound + np.abs(bound) * 1e-9 + 1e-9,
                          side="left")
    start = np.arange(1, n + 1)
    counts = np.maximum(end - start, 0)
    first = np.repeat(np.arange(n), counts)
    step = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts,
                                                counts)
    i, j = order[first], order[start[first] + step]
    # the overlap along y first (most x-neighbours miss there), then x
    h = np.maximum(np.minimum(y2[i], y2[j]) - np.maximum(y1[i], y1[j])
                   + off, 0)
    hit = h > 0
    i, j, h = i[hit], j[hit], h[hit]
    w = np.maximum(np.minimum(x2[i], x2[j]) - np.maximum(x1[i], x1[j])
                   + off, 0)
    inter = w * h
    hit = inter > 0
    i, j, inter = i[hit], j[hit], inter[hit]
    area = np.maximum(x2 - x1 + off, 0) * np.maximum(y2 - y1 + off, 0)
    return i, j, inter / np.maximum(area[i] + area[j] - inter, 1e-10)


def greedy_select(boxes, normalized, nms_threshold, eta):
    """Positions (into `boxes`, the candidates [n, 4] in score order, in
    float64) that greedy NMS keeps: a candidate is kept iff its largest
    IoU with the kept boxes is at most the adaptive threshold, which an
    `eta` below 1 lowers after each keep while it is above 0.5
    (reference: multiclass_nms_op.cc NMSFast). A pair that does not
    overlap has IoU 0 and cannot suppress under a threshold >= 0, so
    only the overlapping pairs are computed (`_overlap_pairs`); a
    negative threshold or a non-finite box takes the full matrix. With a
    fixed threshold only the pairs above it matter, and only a candidate
    that has one with a later candidate is visited. `fmax` skips a NaN
    IoU, as the reference's `>` test does."""
    n = len(boxes)
    if n < 2:
        return list(range(n))
    if nms_threshold >= 0 and np.isfinite(boxes).all():
        i, j, ious = _overlap_pairs(boxes, normalized)
    else:
        i, j = (v.reshape(-1) for v in np.triu_indices(n, 1))
        ious = iou_matrix(boxes, boxes, normalized)[i, j]
    if eta >= 1.0:
        edge = ious > nms_threshold
        src, dst = np.minimum(i, j)[edge], np.maximum(i, j)[edge]
        by_src = np.argsort(src, kind="stable")
        src, dst = src[by_src], dst[by_src]
        kept = np.ones(n, bool)
        bounds = np.flatnonzero(np.diff(src)) + 1
        for lo, hi in zip(np.concatenate([[0], bounds]),
                          np.concatenate([bounds, [len(src)]])):
            if hi > lo and kept[src[lo]]:
                kept[dst[lo:hi]] = False
        return list(np.flatnonzero(kept))
    rows = np.concatenate([i, j])
    by_row = np.argsort(rows, kind="stable")
    partners = np.concatenate([j, i])[by_row]
    ious = np.concatenate([ious, ious])[by_row]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows,
                                                        minlength=n))])
    selected = []
    adaptive = nms_threshold
    worst = np.full(n, -np.inf)
    for k in range(n):
        if worst[k] > adaptive:
            continue
        selected.append(k)
        lo, hi = indptr[k], indptr[k + 1]
        if hi > lo:
            cols = partners[lo:hi]
            worst[cols] = np.fmax(worst[cols], ious[lo:hi])
        adaptive *= eta if adaptive > 0.5 else 1.0
    return selected


def top_candidates(s, threshold, k):
    """`keep[np.argsort(-s[keep], kind="stable")][:k]` for `keep` the
    indices whose score passes `threshold` (the reference's candidate
    list): where 0 <= k < len(keep), the k taken by a partition (every
    score above the k-th, then its ties in index order) before the
    stable sort, so only k scores are sorted."""
    keep = np.flatnonzero(s > threshold)
    neg = -s[keep]
    if 0 < k < len(keep):
        kth = np.partition(neg, k - 1)[k - 1]
        chosen = neg < kth
        chosen[np.flatnonzero(neg == kth)[:k - int(chosen.sum())]] = True
        keep, neg = keep[chosen], neg[chosen]
    return keep[np.argsort(neg, kind="stable")][:k]


def _nms_one_batch(boxes_b, scores_b, attrs):
    """Greedy per-class NMS of one image: (detections [cls, score, box],
    box indices), by score, `keep_top_k` applied (reference:
    multiclass_nms_op.cc MultiClassNMS / MultiClassOutput)."""
    score_threshold = attrs.get("score_threshold", 0.0)
    nms_top_k = attrs.get("nms_top_k", 400)
    keep_top_k = attrs.get("keep_top_k", 200)
    background = attrs.get("background_label", 0)
    normalized = attrs.get("normalized", True)
    classes, scores, idxs = [], [], []
    for cls in range(scores_b.shape[0]):
        if cls == background:
            continue
        s = scores_b[cls]
        order = top_candidates(s, score_threshold, nms_top_k)
        kept = order[greedy_select(
            boxes_b[order].astype(np.float64), normalized,
            attrs.get("nms_threshold", 0.3), attrs.get("nms_eta", 1.0))]
        classes.append(np.full(len(kept), cls))
        scores.append(s[kept])
        idxs.append(kept)
    if not idxs:
        return np.zeros((0, 6), np.float32), np.zeros((0,), np.int64)
    classes, scores, idxs = (np.concatenate(v) for v in (classes, scores,
                                                         idxs))
    order = np.argsort(-scores, kind="stable")
    if keep_top_k > -1:
        order = order[:keep_top_k]
    dets = np.concatenate([classes[order, None].astype(np.float32),
                           scores[order, None].astype(np.float32),
                           boxes_b[idxs[order]].astype(np.float32)], 1)
    return dets, idxs[order]


@register_op("multiclass_nms", no_jit=True, dynamic_shape=True)
def _multiclass_nms(ins, attrs):
    """Out [K, 6] rows (class, score, x1, y1, x2, y2), image by image."""
    boxes = to_numpy(ins["BBoxes"][0])
    scores = to_numpy(ins["Scores"][0])
    out = [_nms_one_batch(boxes[b], scores[b], attrs)[0]
           for b in range(boxes.shape[0])]
    out = np.concatenate(out, 0) if out else np.zeros((0, 6), np.float32)
    return {"Out": from_numpy(out, attrs["_device"])}


@register_op("multiclass_nms2", no_jit=True, dynamic_shape=True)
def _multiclass_nms2(ins, attrs):
    """`multiclass_nms` and Index [K, 1], the kept boxes' rows in the
    flattened [N * M] box table (reference: multiclass_nms_op.cc:493)."""
    boxes = to_numpy(ins["BBoxes"][0])
    scores = to_numpy(ins["Scores"][0])
    num_boxes = boxes.shape[1]
    res = [_nms_one_batch(boxes[b], scores[b], attrs)
           for b in range(boxes.shape[0])]
    out = np.concatenate([r[0] for r in res], 0) if res \
        else np.zeros((0, 6), np.float32)
    index = np.concatenate([r[1].astype(np.int32) + b * num_boxes
                            for b, r in enumerate(res)]).reshape(-1, 1) \
        if res else np.zeros((0, 1), np.int32)
    dev = attrs["_device"]
    return {"Out": from_numpy(out, dev),
            "Index": from_numpy(index.astype(np.int32), dev)}


@register_op("locality_aware_nms", no_jit=True, dynamic_shape=True)
def _locality_aware_nms(ins, attrs):
    """EAST's NMS: consecutive overlapping boxes merged score-weighted
    first (reference: locality_aware_nms_op.cc:88 PolyWeightedMerge),
    then greedy NMS over the merged set; a quad (8-point) box overlaps
    through its axis-aligned bounding box, as in the reference."""
    boxes = to_numpy(ins["BBoxes"][0]).copy()
    scores = to_numpy(ins["Scores"][0]).copy()
    score_threshold = attrs.get("score_threshold", 0.0)
    nms_threshold = attrs.get("nms_threshold", 0.3)
    nms_top_k = attrs.get("nms_top_k", 400)
    keep_top_k = attrs.get("keep_top_k", 200)
    background = attrs.get("background_label", -1)
    normalized = attrs.get("normalized", True)
    box_size = boxes.shape[-1]

    def aabb(v):
        if box_size == 4:
            return v
        return np.stack([v[..., 0::2].min(-1), v[..., 1::2].min(-1),
                         v[..., 0::2].max(-1), v[..., 1::2].max(-1)], -1)

    results = []
    for b in range(boxes.shape[0]):
        dets = []
        for cls in range(scores.shape[1]):
            if cls == background:
                continue
            bb = boxes[b].copy()
            ss = scores[b, cls].copy()
            index = -1
            skip = np.ones(len(ss), bool)
            for i in range(len(ss)):
                if index < 0:
                    index = i
                    continue
                iou = iou_matrix(aabb(bb[i])[None].astype(np.float64),
                                 aabb(bb[index])[None].astype(np.float64),
                                 normalized)[0, 0]
                if iou > nms_threshold:
                    # the zero-sum guard avoids 0/0 on padded boxes
                    tot = ss[i] + ss[index]
                    if tot > 0:
                        bb[index] = (bb[i] * ss[i]
                                     + bb[index] * ss[index]) / tot
                    ss[index] += ss[i]
                else:
                    skip[index] = False
                    index = i
            if index > -1:
                skip[index] = False
            cand = np.where((ss > score_threshold) & ~skip)[0]
            cand = cand[np.argsort(-ss[cand], kind="stable")]
            if nms_top_k > -1:
                cand = cand[:nms_top_k]
            for i in cand[greedy_select(aabb(bb[cand]).astype(np.float64),
                                        normalized, nms_threshold,
                                        attrs.get("nms_eta", 1.0))]:
                dets.append([cls, ss[i]] + list(bb[i]))
        dets.sort(key=lambda d: -d[1])
        if keep_top_k > -1:
            dets = dets[:keep_top_k]
        results.append(np.asarray(dets, np.float32).reshape(-1,
                                                            2 + box_size))
    out = np.concatenate(results, 0) if results else \
        np.zeros((0, 2 + box_size), np.float32)
    return {"Out": from_numpy(out, attrs["_device"])}


@register_op("matrix_nms", no_jit=True, dynamic_shape=True)
def _matrix_nms(ins, attrs):
    """Matrix NMS: each candidate's score decayed by its IoUs with the
    higher-scored boxes of its class, linearly or by a Gaussian, instead
    of suppressed (reference: matrix_nms_op.cc:95 NMSMatrix). Out
    [K, box_dim + 2], Index [K, 1] into the flattened box table, RoisNum
    [N] the count an image."""
    boxes = to_numpy(ins["BBoxes"][0])
    scores = to_numpy(ins["Scores"][0])
    score_threshold = attrs.get("score_threshold", 0.0)
    post_threshold = attrs.get("post_threshold", 0.0)
    nms_top_k = attrs.get("nms_top_k", -1)
    keep_top_k = attrs.get("keep_top_k", -1)
    background = attrs.get("background_label", 0)
    use_gaussian = attrs.get("use_gaussian", False)
    sigma = attrs.get("gaussian_sigma", 2.0)
    normalized = attrs.get("normalized", True)
    batch, _, num_boxes = scores.shape
    box_dim = boxes.shape[-1]
    all_out, all_idx, rois_num = [], [], []
    for b in range(batch):
        cand = []  # (decayed score, class, box index)
        for cls in range(scores.shape[1]):
            if cls == background:
                continue
            s = scores[b, cls]
            perm = np.where(s > score_threshold)[0]
            perm = perm[np.argsort(-s[perm], kind="stable")]
            if nms_top_k > -1:
                perm = perm[:nms_top_k]
            m = len(perm)
            if m == 0:
                continue
            sel = boxes[b, perm]
            # row i: iou(i, j < i); its maximum is the reference's iou_max
            ious = np.tril(iou_matrix(sel, sel, normalized), k=-1)
            iou_max = ious.max(axis=1)
            if s[perm[0]] > post_threshold:
                cand.append((float(s[perm[0]]), cls, int(perm[0])))
            for i in range(1, m):
                if use_gaussian:
                    decay = np.exp((iou_max[:i] ** 2 - ious[i, :i] ** 2)
                                   * sigma)
                else:
                    decay = (1.0 - ious[i, :i]) / (1.0 - iou_max[:i])
                ds = float(decay.min() * s[perm[i]])
                if ds > post_threshold:
                    cand.append((ds, cls, int(perm[i])))
        cand.sort(key=lambda t: -t[0])
        if keep_top_k > -1:
            cand = cand[:keep_top_k]
        rois_num.append(len(cand))
        for ds, cls, idx in cand:
            all_out.append([cls, ds] + list(boxes[b, idx]))
            all_idx.append(b * num_boxes + idx)
    dev = attrs["_device"]
    return {"Out": from_numpy(np.asarray(all_out, np.float32).reshape(
        -1, box_dim + 2), dev),
        "Index": from_numpy(np.asarray(all_idx, np.int32).reshape(-1, 1),
                            dev),
        "RoisNum": from_numpy(np.asarray(rois_num, np.int32), dev)}
