"""fluid.layers detection builders (counterpart:
`paddle_tpu/fluid/layers/detection.py`): the functions that emit the
ported detection types (`ops/detection_ops.py`, `yolov3_loss`) —
`prior_box`, `density_prior_box`, `anchor_generator`, `box_coder`,
`yolo_box`, `yolov3_loss`, `iou_similarity`, `box_clip`,
`multiclass_nms`, `detection_output` (`box_coder` then
`multiclass_nms`), `roi_align`, `roi_pool`, `sigmoid_focal_loss`,
`multiclass_nms2`, `locality_aware_nms` and `matrix_nms`.

The reference's other functions here emit types of `detection_extra_ops`
and `vision_extra_ops` that are not ported yet (ROADMAP Queue 1 #5):
`bipartite_match`, `target_assign`, `ssd_loss`, `prroi_pool`,
`psroi_pool`, `rpn_target_assign`, `generate_proposals`,
`distribute_fpn_proposals`, `collect_fpn_proposals`,
`retinanet_detection_output`, `retinanet_target_assign`,
`generate_proposal_labels`, `polygon_box_transform`,
`roi_perspective_transform`, `deformable_roi_pooling`,
`box_decoder_and_assign`, `detection_map` and `generate_mask_labels`.
"""
from __future__ import annotations

from ..layer_helper import apply_op
from .nn_extra import sigmoid_focal_loss  # noqa: F401

__all__ = [
    "prior_box", "density_prior_box", "anchor_generator", "box_coder",
    "yolo_box", "yolov3_loss", "iou_similarity", "box_clip",
    "multiclass_nms", "detection_output", "roi_align", "roi_pool",
    "sigmoid_focal_loss", "multiclass_nms2", "locality_aware_nms",
    "matrix_nms",
]


def _one(op, inputs, attrs, slot="Out"):
    return apply_op(op, op, inputs, attrs, [slot])[0]


def _steps(steps):
    steps = steps or [0, 0]
    return {"step_w": steps[0], "step_h": steps[1]}


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=None,
              variance=None, flip=False, clip=False, steps=None,
              offset=0.5, name=None):
    outs = apply_op("prior_box", "prior_box",
                    {"Input": [input], "Image": [image]},
                    dict({"min_sizes": list(min_sizes),
                          "max_sizes": list(max_sizes or []),
                          "aspect_ratios": list(aspect_ratios or [1.0]),
                          "variances": list(variance
                                            or [0.1, 0.1, 0.2, 0.2]),
                          "flip": flip, "clip": clip, "offset": offset},
                         **_steps(steps)),
                    ["Boxes", "Variances"])
    return outs[0], outs[1]


def density_prior_box(input, image, densities=None, fixed_sizes=None,
                      fixed_ratios=None, variance=None, clip=False,
                      steps=None, offset=0.5, flatten_to_2d=False,
                      name=None):
    outs = apply_op("density_prior_box", "density_prior_box",
                    {"Input": [input], "Image": [image]},
                    dict({"densities": list(densities or []),
                          "fixed_sizes": list(fixed_sizes or []),
                          "fixed_ratios": list(fixed_ratios or []),
                          "variances": list(variance
                                            or [0.1, 0.1, 0.2, 0.2]),
                          "clip": clip, "flatten_to_2d": flatten_to_2d,
                          "offset": offset}, **_steps(steps)),
                    ["Boxes", "Variances"])
    return outs[0], outs[1]


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=None, stride=None, offset=0.5, name=None):
    outs = apply_op("anchor_generator", "anchor_generator",
                    {"Input": [input]},
                    {"anchor_sizes": list(anchor_sizes or [64, 128]),
                     "aspect_ratios": list(aspect_ratios or [1.0]),
                     "variances": list(variance or [0.1, 0.1, 0.2, 0.2]),
                     "stride": list(stride or [16.0, 16.0]),
                     "offset": offset}, ["Anchors", "Variances"])
    return outs[0], outs[1]


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None, axis=0):
    """`prior_box_var` a var (the PriorBoxVar input) or a list of four
    (kept as the `variance` attr, which the op does not read, as in the
    reference)."""
    ins = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    attrs = {"code_type": code_type, "box_normalized": box_normalized,
             "axis": axis}
    if isinstance(prior_box_var, (list, tuple)):
        attrs["variance"] = list(prior_box_var)
    elif prior_box_var is not None:
        ins["PriorBoxVar"] = [prior_box_var]
    return _one("box_coder", ins, attrs, "OutputBox")


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, name=None):
    outs = apply_op("yolo_box", "yolo_box",
                    {"X": [x], "ImgSize": [img_size]},
                    {"anchors": list(anchors), "class_num": class_num,
                     "conf_thresh": conf_thresh,
                     "downsample_ratio": downsample_ratio},
                    ["Boxes", "Scores"])
    return outs[0], outs[1]


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None):
    ins = {"X": [x], "GTBox": [gt_box], "GTLabel": [gt_label]}
    if gt_score is not None:
        ins["GTScore"] = [gt_score]
    return apply_op("yolov3_loss", "yolov3_loss", ins,
                    {"anchors": list(anchors),
                     "anchor_mask": list(anchor_mask),
                     "class_num": class_num,
                     "ignore_thresh": ignore_thresh,
                     "downsample_ratio": downsample_ratio,
                     "use_label_smooth": use_label_smooth},
                    ["Loss", "ObjectnessMask", "GTMatchMask"])[0]


def iou_similarity(x, y, name=None):
    return _one("iou_similarity", {"X": [x], "Y": [y]}, {})


def box_clip(input, im_info, name=None):
    return _one("box_clip", {"Input": [input], "ImInfo": [im_info]}, {},
                "Output")


def _nms_attrs(score_threshold, nms_top_k, keep_top_k, nms_threshold,
               normalized, nms_eta, background_label):
    return {"score_threshold": score_threshold, "nms_top_k": nms_top_k,
            "keep_top_k": keep_top_k, "nms_threshold": nms_threshold,
            "normalized": normalized, "nms_eta": nms_eta,
            "background_label": background_label}


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, nms_eta=1.0,
                   background_label=0, name=None):
    return _one("multiclass_nms", {"BBoxes": [bboxes], "Scores": [scores]},
                _nms_attrs(score_threshold, nms_top_k, keep_top_k,
                           nms_threshold, normalized, nms_eta,
                           background_label))


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0):
    """SSD's inference head: `box_coder` decodes, then
    `multiclass_nms`."""
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    return multiclass_nms(decoded, scores, score_threshold, nms_top_k,
                          keep_top_k, nms_threshold=nms_threshold,
                          nms_eta=nms_eta,
                          background_label=background_label)


def _roi_ins(input, rois, rois_num):
    ins = {"X": [input], "ROIs": [rois]}
    if rois_num is not None:
        ins["RoisNum"] = [rois_num]
    return ins


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, name=None,
              rois_num=None):
    return _one("roi_align", _roi_ins(input, rois, rois_num),
                {"pooled_height": pooled_height,
                 "pooled_width": pooled_width,
                 "spatial_scale": spatial_scale,
                 "sampling_ratio": sampling_ratio})


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, rois_num=None, name=None):
    return _one("roi_pool", _roi_ins(input, rois, rois_num),
                {"pooled_height": pooled_height,
                 "pooled_width": pooled_width,
                 "spatial_scale": spatial_scale})


def multiclass_nms2(bboxes, scores, score_threshold, nms_top_k,
                    keep_top_k, nms_threshold=0.3, normalized=True,
                    nms_eta=1.0, background_label=0, return_index=False,
                    name=None):
    outs = apply_op("multiclass_nms2", "multiclass_nms2",
                    {"BBoxes": [bboxes], "Scores": [scores]},
                    _nms_attrs(score_threshold, nms_top_k, keep_top_k,
                               nms_threshold, normalized, nms_eta,
                               background_label), ["Out", "Index"])
    return (outs[0], outs[1]) if return_index else outs[0]


def locality_aware_nms(bboxes, scores, score_threshold, nms_top_k,
                       keep_top_k, nms_threshold=0.3, normalized=True,
                       nms_eta=1.0, background_label=-1, name=None):
    return _one("locality_aware_nms",
                {"BBoxes": [bboxes], "Scores": [scores]},
                _nms_attrs(score_threshold, nms_top_k, keep_top_k,
                           nms_threshold, normalized, nms_eta,
                           background_label))


def matrix_nms(bboxes, scores, score_threshold, post_threshold,
               nms_top_k, keep_top_k, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               return_index=False, return_rois_num=False, name=None):
    outs = apply_op("matrix_nms", "matrix_nms",
                    {"BBoxes": [bboxes], "Scores": [scores]},
                    {"score_threshold": score_threshold,
                     "post_threshold": post_threshold,
                     "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
                     "use_gaussian": use_gaussian,
                     "gaussian_sigma": gaussian_sigma,
                     "background_label": background_label,
                     "normalized": normalized},
                    ["Out", "Index", "RoisNum"])
    res = [outs[0]] + [o for o, want in ((outs[1], return_index),
                                         (outs[2], return_rois_num))
                       if want]
    return res[0] if len(res) == 1 else tuple(res)
