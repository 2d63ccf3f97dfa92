"""The op cases of the detection pipeline's other operators: the
reference's `detection_extra_ops` (21 types), `vision_extra_ops` (9) and
`specialty_ops`' `sample_logits`. `tests/test_torch_det_extra_ops.py`
holds each against the JAX package on the CPU;
`tests/test_torch_det_extra_cuda.py` and `chip_smoke.py` phase 22 leg d,
the card against the CPU. Plain numpy and no JAX, so the card's machine
imports it too.

`CASES`: name -> (op type, {slot: [numpy maker]}, attrs, float input
slots to differentiate, batch-carrying slots for a -1 inference check),
as in `tests/torch_nn_cases.py`. A maker takes a
`numpy.random.RandomState`; `inputs(name)` draws a case's inputs from
the state seeded by its position among the names. The random types
(`sample_logits` without its customized samples,
`sampled_softmax_with_cross_entropy`, `random_crop`) draw from the op's
seed, whose stream differs from JAX's by design: the CPU tests hold
them by their own rules, the card against the CPU at one seed.
`HOST_DIGESTS`: the reference's outputs of the host-side cases, each
narrowed to the dtype a var of it holds on the device (`canon`) and
recorded as a `digest`, which the port gives on the CPU
(`tests/test_torch_det_extra_ops.py`) and on the card."""
import hashlib

import numpy as np


def _f(*shape, scale=1.0):
    return lambda r: (r.randn(*shape) * scale).astype("float32")


def _u(lo, hi, *shape):
    return lambda r: r.uniform(lo, hi, shape).astype("float32")


def _c(v, dtype="float32"):
    return lambda r: np.asarray(v, dtype)


def _i(high, *shape, low=0, dtype="int32"):
    return lambda r: r.randint(low, high, size=shape).astype(dtype)


def _boxes(n, lo=0.0, hi=64.0, size=(4.0, 24.0)):
    """Corner boxes [n, 4] inside [lo, hi], extents within `size`."""
    def make(r):
        w = r.uniform(size[0], size[1], n)
        h = r.uniform(size[0], size[1], n)
        x1 = r.uniform(lo, hi - w)
        y1 = r.uniform(lo, hi - h)
        return np.stack([x1, y1, x1 + w, y1 + h], -1).astype("float32")
    return make


def _grid_anchors(fh, fw, sizes, stride):
    """Anchors [fh * fw * len(sizes), 4] centred on a stride grid, square
    of each size (with ties of IoU between cells)."""
    def make(r):
        cy, cx = np.meshgrid((np.arange(fh) + 0.5) * stride,
                             (np.arange(fw) + 0.5) * stride, indexing="ij")
        out = [np.stack([cx - s / 2, cy - s / 2, cx + s / 2, cy + s / 2],
                        -1) for s in sizes]
        return np.stack(out, 2).reshape(-1, 4).astype("float32")
    return make


#: ground truths of the RPN and label cases (pixels of a 64 x 64 image)
_GT = np.asarray([[4, 6, 26, 30], [30, 8, 60, 28], [12, 34, 40, 60],
                  [40, 40, 58, 62], [20, 20, 36, 38]], "float32")


def _near_gt(n, jitter=4.0):
    """RoIs [n, 4]: jittered copies of the ground truths, then random."""
    def make(r):
        k = min(n // 2, 3 * len(_GT))
        base = _GT[r.randint(0, len(_GT), k)]
        near = base + r.uniform(-jitter, jitter, (k, 4))
        rest = _boxes(n - k)(r)
        out = np.concatenate([near, rest])
        out[:, 2:] = np.maximum(out[:, 2:], out[:, :2] + 1.0)
        return out.astype("float32")
    return make


def _quads(n, lo=1.0, hi=11.0):
    def make(r):
        c = r.uniform(lo + 2, hi - 2, (n, 1, 2))
        off = r.uniform(1, 2, (n, 4, 2)) * np.asarray(
            [[-1, -1], [1, -1], [1, 1], [-1, 1]])
        return (c + off).reshape(n, 8).astype("float32")
    return make


def _match(p, g, unmatched=0.4):
    """Match indices [1, p] into g rows, about `unmatched` of them -1."""
    def make(r):
        m = r.randint(0, g, (1, p))
        m[r.uniform(0, 1, (1, p)) < unmatched] = -1
        return m.astype("int32")
    return make


def _unpool_dups(r):
    """(X, Indices) of 2 x 2 planes into 4 x 4 with repeated indices that
    carry one value, as overlapping max-pool windows give them."""
    x = r.randn(2, 3, 2, 2).astype("float32")
    idx = np.tile(np.asarray([[5, 5], [10, 6]], "int32"), (2, 3, 1, 1))
    x[:, :, 0, 1] = x[:, :, 0, 0]
    return x, idx


_UNPOOL_DUPS = _unpool_dups(np.random.RandomState(31))


def _unique_idx(n, c, k, size):
    def make(r):
        return np.stack([np.stack([r.choice(size, k, replace=False)
                                   for _ in range(c)])
                         for _ in range(n)]).reshape(
                             n, c, int(np.sqrt(k)), -1).astype("int32")
    return make


def _dets(n, classes, tied=False):
    """Detections [n, 6] (label, score, box in [0, 1]) near the label
    boxes of `_LABEL`, some of them outside [0, 1]."""
    def make(r):
        lab = _LABEL[r.randint(0, len(_LABEL), n)]
        box = lab[:, 2:] + r.uniform(-0.08, 0.08, (n, 4))
        cls = np.where(r.uniform(0, 1, n) < 0.8, lab[:, 0],
                       r.randint(1, classes, n))
        score = (r.randint(1, 6, n) / 6.0) if tied else r.uniform(0, 1, n)
        return np.concatenate([cls[:, None], score[:, None], box],
                              1).astype("float32")
    return make


#: ground-truth rows (label, difficult, x1, y1, x2, y2) of two images
_LABEL = np.asarray([
    [1, 0, 0.10, 0.10, 0.40, 0.45], [2, 0, 0.50, 0.20, 0.90, 0.60],
    [1, 1, 0.30, 0.55, 0.60, 0.95], [3, 0, 0.05, 0.60, 0.30, 0.90],
    [2, 0, 0.55, 0.55, 0.95, 0.95], [1, 0, 0.60, 0.05, 0.95, 0.35],
    [3, 1, 0.20, 0.20, 0.50, 0.50]], "float32")


def _segms():
    """Three ground truths' polygons (one with two rings) over a 64 x 64
    image: GtSegms [S, 2], the polygons a ground truth and the points a
    polygon."""
    polys = [[[[6, 8], [24, 6], [26, 28], [8, 30]]],
             [[[32, 10], [58, 12], [50, 26]], [[34, 20], [40, 20],
                                               [38, 27]]],
             [[[14, 36], [38, 38], [36, 58], [16, 56], [12, 46]]]]
    pts, poly_lod, point_lod = [], [0], [0]
    for rings in polys:
        for ring in rings:
            pts += ring
            point_lod.append(len(pts))
        poly_lod.append(len(point_lod) - 1)
    return (np.asarray(pts, "float32"), np.asarray(poly_lod, "int32"),
            np.asarray(point_lod, "int32"))


_SEGMS, _POLY_LOD, _POINT_LOD = _segms()


def _mask_ins(labels):
    return {"ImInfo": [_c([[64.0, 64.0, 1.0]])],
            "GtClasses": [_c([[1], [3], [2]], "int32")],
            "IsCrowd": [_c([[0], [0], [0]], "int32")],
            "GtSegms": [_c(_SEGMS)], "GtSegmsPolyLod": [_c(_POLY_LOD)],
            "GtSegmsPointLod": [_c(_POINT_LOD)],
            "Rois": [_c([[5, 7, 25, 29], [31, 9, 57, 27], [13, 35, 37, 57],
                         [2, 2, 20, 20], [40, 40, 60, 60],
                         [8, 10, 30, 33]])],
            "LabelsInt32": [_c(labels, "int32")]}


def _det_map(ap, state=False, tied=False, lod=(0, 4, 7), dlod=(0, 9, 16)):
    ins = {"DetectRes": [_dets(dlod[-1], 4, tied)], "Label": [_c(_LABEL)],
           "DetectResLod": [_c(dlod, "int32")],
           "LabelLod": [_c(lod, "int32")]}
    if state:
        ins.update({
            "HasState": [_c([1], "int32")],
            "PosCount": [_c([[0], [3], [1], [2]], "int32")],
            "TruePos": [_c([[0.9, 1], [0.4, 0], [0.7, 1], [0.3, 1]])],
            "FalsePos": [_c([[0.9, 0], [0.4, 1], [0.7, 0], [0.3, 0]])],
            "TruePosLod": [_c([0, 0, 2, 3, 4], "int32")],
            "FalsePosLod": [_c([0, 0, 2, 3, 4], "int32")]})
    return ("detection_map", ins,
            {"class_num": 4, "background_label": 0, "overlap_threshold": 0.5,
             "evaluate_difficult": False, "ap_type": ap}, [], [])


def _host(op, ins, attrs):
    return (op, ins, attrs, [], [])


CASES = {
    # -- vision_extra_ops -----------------------------------------------------
    "unpool": ("unpool", {"X": [_f(2, 3, 3, 3)],
                          "Indices": [_unique_idx(2, 3, 9, 36)]},
               {"unpooled_height": 6, "unpooled_width": 6}, ["X"], []),
    "unpool_duplicates": ("unpool", {"X": [_c(_UNPOOL_DUPS[0])],
                                     "Indices": [_c(_UNPOOL_DUPS[1],
                                                    "int32")]},
                          {"unpooled_height": 4, "unpooled_width": 4},
                          [], []),
    "max_pool3d_with_index": ("max_pool3d_with_index",
                              {"X": [_f(2, 2, 5, 6, 5)]},
                              {"ksize": [2, 3, 2], "strides": [2, 2, 2],
                               "paddings": [1, 1, 0]}, ["X"], ["X"]),
    "max_pool3d_with_index_overlap": ("max_pool3d_with_index",
                                      {"X": [_f(1, 3, 5, 5, 6)]},
                                      {"ksize": [3, 3, 3],
                                       "strides": [2, 2, 2],
                                       "paddings": [1, 1, 1]}, ["X"], []),
    "depthwise_conv2d_transpose": ("depthwise_conv2d_transpose",
                                   {"Input": [_f(2, 3, 5, 6)],
                                    "Filter": [_f(3, 1, 3, 3)]},
                                   {"strides": [2, 2], "paddings": [1, 1]},
                                   ["Input", "Filter"], ["Input"]),
    "depthwise_conv2d_transpose_dilated": (
        "depthwise_conv2d_transpose",
        {"Input": [_f(1, 4, 4, 5)], "Filter": [_f(4, 1, 2, 3)]},
        {"strides": [1, 2], "paddings": [0, 1], "dilations": [2, 1]},
        ["Input", "Filter"], []),
    "conv_shift": ("conv_shift", {"X": [_f(3, 10)], "Y": [_f(3, 5)]}, {},
                   ["X", "Y"], ["X", "Y"]),
    "deformable_conv": ("deformable_conv", {
        "Input": [_f(2, 4, 7, 8)], "Offset": [_f(2, 2 * 9 * 2, 7, 8,
                                                 scale=1.5)],
        "Mask": [_u(0.0, 1.0, 2, 2 * 9, 7, 8)],
        "Filter": [_f(6, 2, 3, 3)]},
        {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
         "groups": 2, "deformable_groups": 2},
        ["Input", "Offset", "Mask", "Filter"], []),
    "deformable_conv_v1": ("deformable_conv_v1", {
        "Input": [_f(1, 3, 9, 8)], "Offset": [_f(1, 9 * 2, 3, 3, scale=2.0)],
        "Filter": [_f(4, 3, 3, 3)]},
        {"strides": [2, 2], "paddings": [0, 0], "dilations": [2, 1],
         "groups": 1, "deformable_groups": 1},
        ["Input", "Offset", "Filter"], []),
    "prroi_pool": ("prroi_pool", {
        "X": [_f(2, 3, 8, 9)], "ROIs": [_boxes(4, hi=16.0, size=(2.0, 9.0))],
        "BatchRoINums": [_c([3, 1], "int32")]},
        {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 0.5},
        ["X", "ROIs"], []),
    "prroi_pool_image0": ("prroi_pool", {
        "X": [_f(1, 2, 6, 6)], "ROIs": [_boxes(3, hi=6.0, size=(0.5, 4.0))]},
        {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 1.0},
        ["X"], []),
    "psroi_pool": ("psroi_pool", {
        "X": [_f(2, 2 * 2 * 2, 8, 9)],
        "ROIs": [_boxes(4, hi=16.0, size=(2.0, 9.0))],
        "RoisNum": [_c([2, 2], "int32")]},
        {"pooled_height": 2, "pooled_width": 2, "output_channels": 2,
         "spatial_scale": 0.5}, ["X"], []),
    "bilateral_slice_offset": ("bilateral_slice", {
        "X": [_f(2, 3, 6, 7)], "Grid": [_f(2, 2 * 4, 4, 3, 3)],
        "Guide": [_u(0.0, 1.0, 2, 6, 7)]}, {"has_offset": True},
        ["X", "Grid", "Guide"], []),
    "bilateral_slice": ("bilateral_slice", {
        "X": [_f(1, 2, 5, 4)], "Grid": [_f(1, 3 * 2, 3, 2, 3)],
        "Guide": [_u(0.0, 1.0, 1, 5, 4)]}, {"has_offset": False},
        ["X", "Grid"], []),
    # -- specialty_ops: sample_logits with its samples given ------------------
    "sample_logits_customized": ("sample_logits", {
        "Logits": [_f(4, 20)], "Labels": [_c([[3, 7], [0, 19], [5, 5],
                                              [12, 1]], "int64")],
        "CustomizedSamples": [_c([[3, 7, 1, 7, 9], [0, 19, 2, 4, 0],
                                  [5, 5, 11, 3, 5], [12, 1, 6, 12, 8]],
                                 "int64")],
        "CustomizedProbabilities": [_u(0.01, 0.3, 4, 5)]},
        {"num_samples": 3, "remove_accidental_hits": True}, ["Logits"], []),
    # -- detection_extra_ops: device types --------------------------------------
    "target_assign_boxes": ("target_assign", {
        "X": [_f(4, 10, 4)], "MatchIndices": [_match(10, 4)]},
        {"mismatch_value": 0}, ["X"], []),
    "target_assign_labels": ("target_assign", {
        "X": [_c([[1], [3], [2], [1]], "int32")],
        "MatchIndices": [_match(12, 4)]}, {"mismatch_value": 0}, [], []),
    "target_assign_rows": ("target_assign", {
        "X": [_f(3, 5)], "MatchIndices": [_match(8, 3)]},
        {"mismatch_value": -1}, ["X"], []),
    "polygon_box_transform": ("polygon_box_transform",
                              {"Input": [_f(2, 8, 4, 5)]}, {}, ["Input"],
                              ["Input"]),
    "roi_perspective_transform": ("roi_perspective_transform", {
        "X": [_f(1, 3, 12, 12)], "ROIs": [_quads(3)]},
        {"transformed_height": 4, "transformed_width": 5,
         "spatial_scale": 1.0}, ["X", "ROIs"], []),
    "deformable_psroi_pooling": ("deformable_psroi_pooling", {
        "Input": [_f(2, 2 * 2 * 2, 8, 9)],
        "ROIs": [_boxes(3, hi=16.0, size=(3.0, 10.0))],
        "Trans": [_f(3, 2, 2, 2, scale=0.5)],
        "RoisNum": [_c([2, 1], "int32")]},
        {"pooled_height": 2, "pooled_width": 2, "output_dim": 2,
         "spatial_scale": 0.5, "trans_std": 0.1, "sample_per_part": 3},
        ["Input", "Trans"], []),
    "deformable_psroi_pooling_plain": ("deformable_psroi_pooling", {
        "Input": [_f(1, 3, 7, 8)],
        "ROIs": [_boxes(2, hi=8.0, size=(2.0, 6.0))]},
        {"pooled_height": 3, "pooled_width": 2, "output_dim": 3,
         "spatial_scale": 1.0, "sample_per_part": 2}, ["Input"], []),
    "hsigmoid": ("hsigmoid", {
        "X": [_f(5, 6)], "W": [_f(6, 6, scale=0.5)],
        "Label": [_c([[0], [6], [3], [2], [5]], "int64")],
        "Bias": [_f(6)]}, {"num_classes": 7}, ["X", "W", "Bias"], []),
    "hsigmoid_no_bias": ("hsigmoid", {
        "X": [_f(4, 3)], "W": [_f(4, 3)],
        "Label": [_c([[4], [0], [2], [4]], "int64")]},
        {"num_classes": 5}, ["X", "W"], []),
    "add_position_encoding": ("add_position_encoding", {"X": [_f(2, 5, 7)]},
                              {"alpha": 0.5, "beta": 2.0}, ["X"], ["X"]),
    "add_position_encoding_even": ("add_position_encoding",
                                   {"X": [_f(1, 9, 8)]}, {}, ["X"], []),
    "box_decoder_and_assign": ("box_decoder_and_assign", {
        "PriorBox": [_boxes(6)], "PriorBoxVar": [_c([0.1, 0.1, 0.2, 0.2])],
        "TargetBox": [_f(6, 3 * 4, scale=2.0)],
        "BoxScore": [_u(0.0, 1.0, 6, 3)]}, {"box_clip": 1.5},
        ["TargetBox"], []),
    "box_decoder_and_assign_ties": ("box_decoder_and_assign", {
        "PriorBox": [_boxes(5)], "PriorBoxVar": [_c(np.tile(
            [0.1, 0.1, 0.2, 0.2], (5, 1)))],
        "TargetBox": [_f(5, 4 * 4)],
        "BoxScore": [_c([[0.9, 0.2, 0.2, 0.1], [0.1, 0.5, 0.7, 0.7],
                         [0.3, 0.3, 0.3, 0.3], [0.0, 0.1, 0.4, 0.4],
                         [0.5, 0.6, 0.1, 0.6]])]}, {}, ["TargetBox"], []),
    # -- detection_extra_ops: host types -----------------------------------------
    "bipartite_match": _host("bipartite_match",
                             {"DistMat": [_u(0.0, 1.0, 5, 12)]},
                             {"match_type": "bipartite",
                              "dist_threshold": 0.5}),
    "bipartite_match_per_prediction": _host(
        "bipartite_match", {"DistMat": [_u(-0.2, 0.8, 4, 15)]},
        {"match_type": "per_prediction", "dist_threshold": 0.3}),
    "rpn_target_assign": _host("rpn_target_assign", {
        "Anchor": [_grid_anchors(8, 8, [12.0, 24.0], 8.0)],
        "GtBoxes": [_c(_GT)]},
        {"rpn_batch_size_per_im": 32, "rpn_fg_fraction": 0.25,
         "rpn_positive_overlap": 0.5, "rpn_negative_overlap": 0.3}),
    "rpn_target_assign_no_gt": _host("rpn_target_assign", {
        "Anchor": [_grid_anchors(4, 4, [16.0], 16.0)],
        "GtBoxes": [_c(np.zeros((0, 4)))]},
        {"rpn_batch_size_per_im": 8}),
    "generate_proposals": _host("generate_proposals", {
        "Scores": [_u(0.0, 1.0, 1, 3, 6, 8)],
        "BboxDeltas": [_f(1, 12, 6, 8, scale=0.3)],
        "ImInfo": [_c([[48.0, 64.0, 1.0]])],
        "Anchors": [lambda r: _grid_anchors(6, 8, [8.0, 16.0, 32.0], 8.0)(
            r).reshape(6, 8, 3, 4)],
        "Variances": [_c(np.tile([0.1, 0.1, 0.2, 0.2], (6, 8, 3, 1)))]},
        {"pre_nms_topN": 100, "post_nms_topN": 30, "nms_thresh": 0.5,
         "min_size": 1.0}),
    "generate_proposals_two_images": _host("generate_proposals", {
        "Scores": [_u(0.0, 1.0, 2, 2, 5, 5)],
        "BboxDeltas": [_f(2, 8, 5, 5, scale=0.5)],
        "ImInfo": [_c([[40.0, 40.0, 1.0], [30.0, 36.0, 1.0]])],
        "Anchors": [lambda r: _grid_anchors(5, 5, [8.0, 24.0], 8.0)(
            r).reshape(5, 5, 2, 4)],
        "Variances": [_c(np.ones((5, 5, 2, 4)))]},
        {"pre_nms_topN": 40, "post_nms_topN": 12, "nms_thresh": 0.3,
         "min_size": 0.0}),
    "distribute_fpn_proposals": _host("distribute_fpn_proposals", {
        "FpnRois": [_boxes(24, hi=800.0, size=(6.0, 500.0))]},
        {"min_level": 2, "max_level": 5, "refer_level": 4,
         "refer_scale": 224}),
    "collect_fpn_proposals": _host("collect_fpn_proposals", {
        "MultiLevelRois": [_boxes(6), _boxes(4), _boxes(5)],
        "MultiLevelScores": [_u(0.0, 1.0, 6, 1), _u(0.0, 1.0, 4, 1),
                             _u(0.0, 1.0, 5, 1)]}, {"post_nms_topN": 9}),
    "retinanet_detection_output": _host("retinanet_detection_output", {
        "BBoxes": [_f(1, 24, 4, scale=0.2), _f(1, 12, 4, scale=0.2)],
        "Scores": [_f(1, 24, 3, scale=2.0), _f(1, 12, 3, scale=2.0)],
        "Anchors": [_boxes(24), _boxes(12, size=(16.0, 40.0))]},
        {"score_threshold": 0.3, "nms_threshold": 0.4, "keep_top_k": 20,
         "nms_top_k": 16}),
    "retinanet_target_assign": _host("retinanet_target_assign", {
        "Anchor": [_grid_anchors(6, 6, [14.0, 22.0], 10.0)],
        "GtBoxes": [_c(_GT[:4])],
        "GtLabels": [_c([[2], [1], [3], [1]], "int32")]},
        {"positive_overlap": 0.5, "negative_overlap": 0.4}),
    "generate_proposal_labels": _host("generate_proposal_labels", {
        "RpnRois": [_near_gt(40)],
        "GtClasses": [_c([[1], [3], [2], [5], [4]], "int32")],
        "GtBoxes": [_c(_GT)]},
        {"batch_size_per_im": 16, "fg_fraction": 0.25, "fg_thresh": 0.5,
         "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0, "class_nums": 6}),
    "generate_proposal_labels_many_fg": _host("generate_proposal_labels", {
        "RpnRois": [_near_gt(60, jitter=2.0)],
        "GtClasses": [_c([[1], [3], [2], [5], [4]], "int32")],
        "GtBoxes": [_c(_GT)]},
        {"batch_size_per_im": 12, "fg_fraction": 0.5, "fg_thresh": 0.5,
         "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.1, "class_nums": 6}),
    "similarity_focus": _host("similarity_focus", {"X": [_f(2, 3, 4, 5)]},
                              {"axis": 1, "indexes": [0, 2]}),
    "similarity_focus_ties_axis3": _host(
        "similarity_focus", {"X": [_i(3, 2, 4, 3, 3, dtype="float32")]},
        {"axis": 3, "indexes": [1]}),
    "mine_hard_examples": _host("mine_hard_examples", {
        "ClsLoss": [_u(0.0, 2.0, 2, 12)], "LocLoss": [_u(0.0, 1.0, 2, 12)],
        "MatchIndices": [_i(4, 2, 12, low=-1)],
        "MatchDist": [_u(0.0, 1.0, 2, 12)]},
        {"neg_pos_ratio": 1.5, "neg_dist_threshold": 0.5,
         "mining_type": "max_negative"}),
    "mine_hard_examples_hard": _host("mine_hard_examples", {
        "ClsLoss": [_u(0.0, 2.0, 2, 10)], "LocLoss": [_u(0.0, 1.0, 2, 10)],
        "MatchIndices": [_i(3, 2, 10, low=-1)],
        "MatchDist": [_u(0.0, 1.0, 2, 10)]},
        {"sample_size": 4, "mining_type": "hard_example"}),
    "detection_map": _det_map("integral"),
    "detection_map_11point": _det_map("11point"),
    "detection_map_state": _det_map("integral", state=True),
    "detection_map_ties_empty_gt": _det_map("11point", tied=True,
                                            lod=(0, 7, 7)),
    "generate_mask_labels": _host(
        "generate_mask_labels",
        _mask_ins([[1], [3], [2], [0], [0], [1]]),
        {"num_classes": 4, "resolution": 8}),
    "generate_mask_labels_no_fg": _host(
        "generate_mask_labels", _mask_ins([[0], [0], [0], [0], [0], [0]]),
        {"num_classes": 4, "resolution": 6}),
}

#: the random types, held by their own rules on the CPU (module
#: docstring): name -> (op type, {slot: [maker]}, attrs, diff slots)
RANDOM_CASES = {
    "sample_logits": ("sample_logits", {
        "Logits": [_f(4, 50)], "Labels": [_c([[3], [7], [0], [49]],
                                             "int64")]},
        {"num_samples": 6, "remove_accidental_hits": True}, ["Logits"]),
    "sampled_softmax_with_cross_entropy": (
        "sampled_softmax_with_cross_entropy", {
            "Logits": [_f(5, 40)], "Label": [_c([[1, 4], [0, 2], [7, 7],
                                                 [39, 3], [5, 6]],
                                                "int64")]},
        {"num_samples": 8}, ["Logits"]),
    "random_crop": ("random_crop", {"X": [_f(2, 3, 9, 10)]},
                    {"shape": [5, 6]}, ["X"]),
}

_MODULES = {
    "vision_extra_ops": {
        "unpool", "max_pool3d_with_index", "depthwise_conv2d_transpose",
        "conv_shift", "deformable_conv", "deformable_conv_v1",
        "prroi_pool", "psroi_pool", "bilateral_slice"},
    "specialty_ops": {"sample_logits"},
}

#: op type -> the reference file that registers it
MODULE = {c[0]: next((m for m, ts in _MODULES.items() if c[0] in ts),
                     "detection_extra_ops")
          for c in list(CASES.values()) + list(RANDOM_CASES.values())}

#: the reference's outputs of the host-side cases (`digest` of `canon`)
HOST_DIGESTS = {
    'bipartite_match': {
        'ColToRowMatchDist':
            ['1cb67309c31edda20c0e4e7f78013994ccff438306e4bd3a24ffb699fa965fb0'],
        'ColToRowMatchIndices':
            ['fc09aaab70c82180f43c0b8ce8f2ff8988f5d6e19ddbbb1abf640eb07c308d82'],
    },
    'bipartite_match_per_prediction': {
        'ColToRowMatchDist':
            ['877ec83ab5a50f95e9394e547a32997b000d9949717d401fa87dae45bb7ffe4f'],
        'ColToRowMatchIndices':
            ['1a3c3097cfc5ae8ed42e3e04fca9642607cb816a25949f2076802a68c8ed9966'],
    },
    'collect_fpn_proposals': {
        'FpnRois':
            ['f2b2dbf046fd0d23e1abb8b3c7b2d99f585e86c7be0a97f9d48d7c04e66b68d9'],
    },
    'detection_map': {
        'AccumFalsePos':
            ['f428ee8428411acef3c1c92b4db8caca198441115ddcc375a62831ffa5aaea2b'],
        'AccumFalsePosLod':
            ['f77b4e8a67c1369ce0841b0f39c6ecfefe6dde610db4417165a595a9d14fda50'],
        'AccumPosCount':
            ['f6f490eb31edee8b6240629adb5683edbd408785620065be98c17d94a3793ce6'],
        'AccumTruePos':
            ['eed0ec15ef4a905077f3f045b8d953b38080f5daa08d14f77f6544afd3cb1137'],
        'AccumTruePosLod':
            ['f77b4e8a67c1369ce0841b0f39c6ecfefe6dde610db4417165a595a9d14fda50'],
        'MAP':
            ['2f16f5c51e892986add4b8b7ad306bcd8501dfd51f05bea9818d6c5471195be1'],
    },
    'detection_map_11point': {
        'AccumFalsePos':
            ['d86a4b2d3de571fc7530429e6712cd53b738fb0761952305e34c97dc759acc56'],
        'AccumFalsePosLod':
            ['669379ec471fa7037a206224d833d3564407138744e61420343aad4681ffab6a'],
        'AccumPosCount':
            ['f6f490eb31edee8b6240629adb5683edbd408785620065be98c17d94a3793ce6'],
        'AccumTruePos':
            ['11f738fb08354058cabce396140009c7fa96f547bdc8a8c17409eaba0e4b249e'],
        'AccumTruePosLod':
            ['669379ec471fa7037a206224d833d3564407138744e61420343aad4681ffab6a'],
        'MAP':
            ['3c95b6ed17a2dfe547688cb81cf2fce0d46deac03948d0b497619b1e6224d1c8'],
    },
    'detection_map_state': {
        'AccumFalsePos':
            ['54728938d8ef061216f6397c002eda3e884be79f1d1c50451874fcc149924349'],
        'AccumFalsePosLod':
            ['b8091fd539523d17999549d4eb643bc60686d2bfac796bdd5278466ab4e4ba43'],
        'AccumPosCount':
            ['8a158aa5042a58ffa75ef78f60b7f60ba1d914206ae5102b532cc8527f732fcc'],
        'AccumTruePos':
            ['2e4eec66ecf2d7543c9819a3dd2d95458bea7c3884e30a61f5adc29d918597f8'],
        'AccumTruePosLod':
            ['b8091fd539523d17999549d4eb643bc60686d2bfac796bdd5278466ab4e4ba43'],
        'MAP':
            ['eb4d4a68c0feec6212965a76364e9127115b8820713a4d891e9d8070b6af88ce'],
    },
    'detection_map_ties_empty_gt': {
        'AccumFalsePos':
            ['01ceb24c7bfaa2f030514dd2b52b7603f45a4e2af6ba577da61026bebccb053a'],
        'AccumFalsePosLod':
            ['e2b115d8c9ba4d9651c854be38943f9882a3519a881907146360556b2f71aaef'],
        'AccumPosCount':
            ['f6f490eb31edee8b6240629adb5683edbd408785620065be98c17d94a3793ce6'],
        'AccumTruePos':
            ['7d7ba5454dbd7a8ac21bfc0941287d691a2313053784530c5e66a0109c9bbcf2'],
        'AccumTruePosLod':
            ['e2b115d8c9ba4d9651c854be38943f9882a3519a881907146360556b2f71aaef'],
        'MAP':
            ['06be7c2e2e5eb0034420bfc7ae8c6b7ef662247defd45a3bb9bbf087ddd66ee6'],
    },
    'distribute_fpn_proposals': {
        'MultiFpnRois': [
            '7ce9792fd2bce61a059f05c95c13b851bc4bf15de0e8238918aa3eb9f070fc78',
            'a7a48a7ee6fdfa55904fa12d7ffb134569db81cf7a194a96507c11f1cd41460e',
            '6fa73875615a87ec316ed081c09b59c44edfd76faeca29bc71e96d4b5c16d03d',
            '04c4431e1453818efa70755258fc6e801f8a39b7e1c29e5d16ec658523f1f45f',
        ],
        'RestoreIndex':
            ['1e8bf1096e9f60529b13461934a5c19006ab0359f63dd096850a9f0fb03fe5c7'],
    },
    'generate_mask_labels': {
        'MaskInt32':
            ['1ea115d9f67b630326955580e1ee02787c7405b817b485b794179cf5e568d674'],
        'MaskRois':
            ['d925e659c2e5c6085fc200c5d5b62ae5452638ef493cc4b900bf6d9461a8d1d4'],
        'RoiHasMaskInt32':
            ['cec2eb9435e29bcdc1951407d297af891b0bc4dfdcc4fd6ac32bfe63b303c7f7'],
    },
    'generate_mask_labels_no_fg': {
        'MaskInt32':
            ['b1754878ee3001ad4511a6dabdf8909f91e93b12626f8c285643e94759bb6577'],
        'MaskRois':
            ['44ffb46d6db83111f08593fc1ef7d1bd99d053c4d35652c65ce50cf3e7de9495'],
        'RoiHasMaskInt32':
            ['576d17565dec9fd3520598ba3f9d8ade5edba7fed0668adf3a54d82ca42cc479'],
    },
    'generate_proposal_labels': {
        'BboxInsideWeights':
            ['e05f312ce4543cdc05896b10c5feaf2f5cc005b1fccf21f9aeb004233c55ae9d'],
        'BboxOutsideWeights':
            ['e05f312ce4543cdc05896b10c5feaf2f5cc005b1fccf21f9aeb004233c55ae9d'],
        'BboxTargets':
            ['23eae44fb8050265dc4434c90d4387e03ce31c4c6a25ccfda7bd61e0f0eecb8b'],
        'LabelsInt32':
            ['5f448d5e9835f0971553dc6d3d0b2d8e2aa272e7b1d256974c6ff771c759e243'],
        'Rois':
            ['1a921a00d92bc0800f275942d89a3924bc164588f541e56eb4ea6c0a8d2fce58'],
    },
    'generate_proposal_labels_many_fg': {
        'BboxInsideWeights':
            ['b2649364dd440c0d81eeb59a08336c855ed33e5ea8f497bfe95d089c50f95bfc'],
        'BboxOutsideWeights':
            ['b2649364dd440c0d81eeb59a08336c855ed33e5ea8f497bfe95d089c50f95bfc'],
        'BboxTargets':
            ['47431dd66668c6d43107534361dd5dd0e80ab2b218b4bd2626f49c6c2583370e'],
        'LabelsInt32':
            ['8eac6f39a3ee250f62320a2dbd948af82d6c3c06c36439dd7f1934c115dfbf32'],
        'Rois':
            ['cb445b5ef5477119cc4ebb6380ebaf63dd2097b4ec307c84a5204311974fe63c'],
    },
    'generate_proposals': {
        'RpnRoiProbs':
            ['5c72d908cff21625e777332597a5b438d9800fdff04e6684eff53c289edd7e57'],
        'RpnRois':
            ['9242d3a7d1fe7d6afd76776b91f8ce2e9e4eb137ffc5038fceb5c6ae26e55083'],
        'RpnRoisNum':
            ['2f575888e01f5e58182d15e520af426d58ce3f35b638d9e2d3ad696c630a5af5'],
    },
    'generate_proposals_two_images': {
        'RpnRoiProbs':
            ['00b410bac77212e0fb412c5059a8283de2cd8dce8cad61dd81502cf74bfc347f'],
        'RpnRois':
            ['8f9cf3840d8a440f5f5ba71b5cf7af79208be726005ad1459f47e3916e43d412'],
        'RpnRoisNum':
            ['4cb1f808aebbb914043b80591c0fb9cce95ae66986d1410964ae5218d01b29c3'],
    },
    'mine_hard_examples': {
        'NegIndices':
            ['dd62ba01449d8d8894ab29efc34ebe6df271987f7093c535a37b464bc6fbd827'],
        'NegIndicesLod':
            ['3591f9aa2b6c5a1d0a0e6c01df69850c0233ddd6cf553a1e19dda5951a292276'],
        'UpdatedMatchIndices':
            ['ee6e8438019aa6f92ad199cc5def85871c6a9d3c2944c81fc53478eb8da22d9f'],
    },
    'mine_hard_examples_hard': {
        'NegIndices':
            ['78827d335313105e59fdf7a7af5d961b5d35e073a9029de00cd37d731504f711'],
        'NegIndicesLod':
            ['ddb526d523fbac29967ecfddc3ac168f944b223124620634e1cd806e4148f778'],
        'UpdatedMatchIndices':
            ['571397c53de37c2c6233a6ae8de6aeeaafd1b5035048e2d613519f3f3c8ec10f'],
    },
    'retinanet_detection_output': {
        'Out':
            ['0153ce9f6b094cb092ec1938c4edd306ad5c281304ae60080e7246d700b7c0f6'],
    },
    'retinanet_target_assign': {
        'BBoxInsideWeight':
            ['f48f14568a1c5db97701b3d9eaa0625efbb25f982074c6c38ea1602fc78614a0'],
        'ForegroundNumber':
            ['f54e9bc2ff412fd4b7a9edeb3afdb6b2cfa139d6cb8d1c1afbabd6fa4725ec98'],
        'LocationIndex':
            ['fba592ee835544438a7768fa9399a9605be96f7556c7020716b71c8024dfa1ab'],
        'ScoreIndex':
            ['403f748414e13cac4f5ee02a752c325529da99a20d848a284e431f6d12172504'],
        'TargetBBox':
            ['4c29f755c62dea1bc83ce059d96a506868e35a1087496810955852787c65aa3a'],
        'TargetLabel':
            ['3b17c43f386bb9a4c07bb09af3b4655fc8b78333109a9bb8b67c530195e4829d'],
    },
    'rpn_target_assign': {
        'BBoxInsideWeight':
            ['385ed9e26988f90f6bc54359bb6131f7f614dc0bf78eb969fcc075f4c69aabfa'],
        'LocationIndex':
            ['9b601387a708d68750bea071240f83b8bfa9ce5413e73b8a9bed382fbc9ed52f'],
        'ScoreIndex':
            ['db69130249f6f86265e195047762fb306dfeb60655d2fe0d57ef0ef232e75ed4'],
        'TargetBBox':
            ['df0463e816c22a01fe8ed7618d9f8a3303d1dfe065720bbf2185857a2acde427'],
        'TargetLabel':
            ['897b9fb44cbb570c6590a99b3cec574ed9de6c3350a5919ad219eb0d020dbcdf'],
    },
    'rpn_target_assign_no_gt': {
        'BBoxInsideWeight':
            ['04c4431e1453818efa70755258fc6e801f8a39b7e1c29e5d16ec658523f1f45f'],
        'LocationIndex':
            ['4140b37eb3918e84626ad8cc31d39b30f28ca9ea1571ce84274fd1cbd072246e'],
        'ScoreIndex':
            ['2b69a8742e98afe2cfff141a091eae74182d63af423a34585d5e16264a2b512d'],
        'TargetBBox':
            ['04c4431e1453818efa70755258fc6e801f8a39b7e1c29e5d16ec658523f1f45f'],
        'TargetLabel':
            ['e478b43d0a29614f950e71c00026352e1b3fdcdae2b37aaa80414a506bf9797d'],
    },
    'similarity_focus': {
        'Out':
            ['d4e90d99f015e5e22d7ee7eb9d55f50577946a0caf7446243d51e903e7aaf7bb'],
    },
    'similarity_focus_ties_axis3': {
        'Out':
            ['811c98e92f2b9cb7115e07f743609d83031f3a1c2f14c59897d6a1437504f2d5'],
    },
}


def host_cases():
    """The case names of the host-side (`no_jit`) types."""
    return sorted(n for n, c in CASES.items() if c[0] in _HOST_TYPES)


_HOST_TYPES = {
    "bipartite_match", "rpn_target_assign", "generate_proposals",
    "distribute_fpn_proposals", "collect_fpn_proposals",
    "retinanet_detection_output", "retinanet_target_assign",
    "generate_proposal_labels", "similarity_focus", "mine_hard_examples",
    "detection_map", "generate_mask_labels"}


def canon(a):
    """An output as a var of its dtype holds it on the device: 64-bit
    integers and floats narrowed to 32 bits."""
    a = np.asarray(a)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    if a.dtype == np.float64:
        return a.astype(np.float32)
    return a


def digest(a):
    """sha256 of an array's dtype, shape and bytes."""
    a = np.ascontiguousarray(a)
    return hashlib.sha256(("%s%s" % (a.dtype.str, a.shape)).encode()
                          + a.tobytes()).hexdigest()


def digests(outs):
    """{slot: [digest of each canon output]} of slot -> list of arrays."""
    return {s: [digest(canon(v)) for v in vs] for s, vs in outs.items()}


def inputs(name):
    """{slot: [numpy array]} of case `name` (of CASES or RANDOM_CASES)."""
    table = CASES if name in CASES else RANDOM_CASES
    r = np.random.RandomState(sorted(table).index(name))
    return {slot: [make(r) for make in ms]
            for slot, ms in table[name][1].items()}
