"""fluid.layers detection builders (counterpart:
`paddle_tpu/fluid/layers/detection.py`): every function of the
reference's, emitting the types of `ops/detection_ops.py`,
`ops/detection_extra_ops.py`, `ops/vision_extra_ops.py`' RoI pools and
`yolov3_loss`, with the reference's signatures and slot bindings.
`detection_output` is `box_coder` then `multiclass_nms`; `ssd_loss` is
the reference's composition (`iou_similarity`, `bipartite_match`,
`box_coder`, `target_assign`, huber and softmax cross-entropy over every
prior, normalized by the matched count), not Paddle's hard-mining one.
`rpn_target_assign` and `retinanet_target_assign` gather the predictions
at the sampled anchors with `gather`; `detection_map` takes and gives
its streaming state as the 5-tuple (pos_count, true_pos, false_pos,
true_pos_lod, false_pos_lod).
"""
from __future__ import annotations

from ..layer_helper import LayerHelper, apply_op
from . import nn as _nn
from . import tensor as _tensor
from .nn_extra import sigmoid_focal_loss  # noqa: F401

__all__ = [
    "prior_box", "density_prior_box", "anchor_generator", "box_coder",
    "yolo_box", "yolov3_loss", "iou_similarity", "box_clip",
    "multiclass_nms", "bipartite_match", "target_assign", "ssd_loss",
    "detection_output", "roi_align", "roi_pool", "prroi_pool",
    "psroi_pool", "rpn_target_assign", "generate_proposals",
    "distribute_fpn_proposals", "collect_fpn_proposals",
    "retinanet_detection_output", "retinanet_target_assign",
    "generate_proposal_labels", "polygon_box_transform",
    "roi_perspective_transform", "deformable_roi_pooling",
    "sigmoid_focal_loss", "box_decoder_and_assign",
    "multiclass_nms2", "locality_aware_nms", "matrix_nms",
    "detection_map", "generate_mask_labels",
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


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    outs = apply_op("bipartite_match", "bipartite_match",
                    {"DistMat": [dist_matrix]},
                    {"match_type": match_type or "bipartite",
                     "dist_threshold": dist_threshold or 0.5},
                    ["ColToRowMatchIndices", "ColToRowMatchDist"])
    return outs[0], outs[1]


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=None, name=None):
    outs = apply_op("target_assign", "target_assign",
                    {"X": [input], "MatchIndices": [matched_indices]},
                    {"mismatch_value": mismatch_value or 0},
                    ["Out", "OutWeight"])
    return outs[0], outs[1]


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True,
             sample_size=None):
    """The reference's SSD loss: priors matched to one image's ground
    truth by IoU, the smooth-L1 location loss on the matched priors and
    the softmax confidence loss on every prior (the unmatched ones
    against the background class), over the matched count."""
    from . import loss as _loss

    iou = iou_similarity(gt_box, prior_box)
    matched, _ = bipartite_match(iou, match_type, neg_overlap)
    loc_tgt, loc_w = target_assign(
        box_coder(prior_box, prior_box_var, gt_box), matched,
        mismatch_value=0)
    loc_l = _nn.reduce_sum(
        _nn.elementwise_mul(
            apply_op("huber_loss", "huber_loss",
                     {"X": [location], "Y": [loc_tgt]},
                     {"delta": 1.0}, ["Out"])[0],
            loc_w), dim=-1)
    cls_tgt, cls_w = target_assign(gt_label, matched,
                                   mismatch_value=background_label)
    conf_l = _loss.softmax_with_cross_entropy(
        confidence, _tensor.cast(cls_tgt, "int64"))
    total = _nn.elementwise_add(
        _tensor.scale(_nn.reduce_sum(loc_l, dim=-1),
                      scale=loc_loss_weight),
        _tensor.scale(_nn.reduce_sum(
            _nn.reduce_sum(conf_l, dim=-1), dim=-1),
            scale=conf_loss_weight))
    if normalize:
        denom = _nn.reduce_sum(loc_w)
        total = _nn.elementwise_div(
            total, _nn.elementwise_add(
                denom, _tensor.fill_constant([1], "float32", 1e-6)))
    return total


def prroi_pool(input, rois, spatial_scale=1.0, pooled_height=1,
               pooled_width=1, batch_roi_nums=None, name=None):
    ins = {"X": [input], "ROIs": [rois]}
    if batch_roi_nums is not None:
        ins["BatchRoINums"] = [batch_roi_nums]
    return _one("prroi_pool", ins,
                {"pooled_height": pooled_height,
                 "pooled_width": pooled_width,
                 "spatial_scale": spatial_scale})


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, name=None):
    return _one("psroi_pool", {"X": [input], "ROIs": [rois]},
                {"output_channels": output_channels,
                 "spatial_scale": spatial_scale,
                 "pooled_height": pooled_height,
                 "pooled_width": pooled_width})


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd=None, im_info=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True):
    """(scores, locations, target labels, target boxes, inside weights)
    of the sampled anchors: `bbox_pred` [A, 4] and `cls_logits` [A, 1]
    gathered at the op's LocationIndex and ScoreIndex."""
    outs = apply_op("rpn_target_assign", "rpn_target_assign",
                    {"Anchor": [anchor_box], "GtBoxes": [gt_boxes]},
                    {"rpn_batch_size_per_im": rpn_batch_size_per_im,
                     "rpn_fg_fraction": rpn_fg_fraction,
                     "rpn_positive_overlap": rpn_positive_overlap,
                     "rpn_negative_overlap": rpn_negative_overlap},
                    ["LocationIndex", "ScoreIndex", "TargetLabel",
                     "TargetBBox", "BBoxInsideWeight"])
    pred_loc = _nn.gather(bbox_pred, outs[0])
    pred_score = _nn.gather(cls_logits, outs[1])
    return pred_score, pred_loc, outs[2], outs[3], outs[4]


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       return_rois_num=False, name=None):
    outs = apply_op("generate_proposals", "generate_proposals",
                    {"Scores": [scores], "BboxDeltas": [bbox_deltas],
                     "ImInfo": [im_info], "Anchors": [anchors],
                     "Variances": [variances]},
                    {"pre_nms_topN": pre_nms_top_n,
                     "post_nms_topN": post_nms_top_n,
                     "nms_thresh": nms_thresh, "min_size": min_size,
                     "eta": eta},
                    ["RpnRois", "RpnRoiProbs", "RpnRoisNum"])
    if return_rois_num:
        return outs[0], outs[1], outs[2]
    return outs[0], outs[1]


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, name=None):
    n_levels = max_level - min_level + 1
    outs = apply_op("distribute_fpn_proposals",
                    "distribute_fpn_proposals", {"FpnRois": [fpn_rois]},
                    {"min_level": min_level, "max_level": max_level,
                     "refer_level": refer_level,
                     "refer_scale": refer_scale},
                    {"MultiFpnRois": n_levels, "RestoreIndex": 1})
    return outs[:n_levels], outs[n_levels]


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, name=None):
    return _one("collect_fpn_proposals",
                {"MultiLevelRois": list(multi_rois),
                 "MultiLevelScores": list(multi_scores)},
                {"post_nms_topN": post_nms_top_n}, "FpnRois")


def retinanet_detection_output(bboxes, scores, anchors, im_info=None,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0):
    return _one("retinanet_detection_output",
                {"BBoxes": list(bboxes), "Scores": list(scores),
                 "Anchors": list(anchors)},
                {"score_threshold": score_threshold,
                 "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
                 "nms_threshold": nms_threshold, "nms_eta": nms_eta})


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                            gt_boxes, gt_labels, is_crowd=None,
                            im_info=None, num_classes=1,
                            positive_overlap=0.5, negative_overlap=0.4):
    outs = apply_op("retinanet_target_assign", "retinanet_target_assign",
                    {"Anchor": [anchor_box], "GtBoxes": [gt_boxes],
                     "GtLabels": [gt_labels]},
                    {"positive_overlap": positive_overlap,
                     "negative_overlap": negative_overlap},
                    ["LocationIndex", "ScoreIndex", "TargetLabel",
                     "TargetBBox", "BBoxInsideWeight",
                     "ForegroundNumber"])
    pred_loc = _nn.gather(bbox_pred, outs[0])
    pred_score = _nn.gather(cls_logits, outs[1])
    return (pred_score, pred_loc, outs[2], outs[3], outs[4], outs[5])


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info=None, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.5,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=None, class_nums=None,
                             use_random=True, is_cls_agnostic=False,
                             is_cascade_rcnn=False):
    """(rois, labels, box targets, inside and outside weights)."""
    outs = apply_op("generate_proposal_labels",
                    "generate_proposal_labels",
                    {"RpnRois": [rpn_rois], "GtClasses": [gt_classes],
                     "GtBoxes": [gt_boxes]},
                    {"batch_size_per_im": batch_size_per_im,
                     "fg_fraction": fg_fraction, "fg_thresh": fg_thresh,
                     "bg_thresh_hi": bg_thresh_hi,
                     "bg_thresh_lo": bg_thresh_lo,
                     "class_nums": class_nums or 81},
                    ["Rois", "LabelsInt32", "BboxTargets",
                     "BboxInsideWeights", "BboxOutsideWeights"])
    return tuple(outs)


def polygon_box_transform(input, name=None):
    return _one("polygon_box_transform", {"Input": [input]}, {},
                "Output")


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0):
    return _one("roi_perspective_transform",
                {"X": [input], "ROIs": [rois]},
                {"transformed_height": transformed_height,
                 "transformed_width": transformed_width,
                 "spatial_scale": spatial_scale})


def deformable_roi_pooling(input, rois, trans, no_trans=False,
                           spatial_scale=1.0, group_size=(1, 1),
                           pooled_height=1, pooled_width=1, part_size=None,
                           sample_per_part=1, trans_std=0.1,
                           position_sensitive=False, name=None):
    ins = {"Input": [input], "ROIs": [rois]}
    if not no_trans:
        ins["Trans"] = [trans]
    return apply_op("deformable_psroi_pooling", "deformable_psroi_pooling",
                    ins,
                    {"pooled_height": pooled_height,
                     "pooled_width": pooled_width,
                     "output_dim": input.shape[1]
                     if not position_sensitive else
                     input.shape[1] // (pooled_height * pooled_width),
                     "spatial_scale": spatial_scale,
                     "trans_std": trans_std,
                     "sample_per_part": sample_per_part},
                    ["Output", "TopCount"])[0]


def box_decoder_and_assign(prior_box, prior_box_var, target_box,
                           box_score, box_clip_val=4.135, name=None):
    outs = apply_op("box_decoder_and_assign", "box_decoder_and_assign",
                    {"PriorBox": [prior_box],
                     "PriorBoxVar": [prior_box_var],
                     "TargetBox": [target_box], "BoxScore": [box_score]},
                    {"box_clip": box_clip_val},
                    ["DecodeBox", "OutputAssignBox"])
    return outs[0], outs[1]


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.3, evaluate_difficult=True,
                  has_state=None, input_states=None,
                  out_states=None, ap_version="integral"):
    """The mAP metric. `input_states` (pos_count, true_pos, false_pos
    [, true_pos_lod, false_pos_lod]) feed the streaming state in; the
    accumulators are written into the 5 vars of `out_states`, so that
    they can be fed back as the next batch's `input_states`."""
    helper = LayerHelper("detection_map")
    ins = {"DetectRes": [detect_res], "Label": [label]}
    if has_state is not None:
        ins["HasState"] = [has_state]
    if input_states is not None:
        ins["PosCount"] = [input_states[0]]
        ins["TruePos"] = [input_states[1]]
        ins["FalsePos"] = [input_states[2]]
        if len(input_states) >= 5:
            ins["TruePosLod"] = [input_states[3]]
            ins["FalsePosLod"] = [input_states[4]]
    map_out = helper.create_variable_for_type_inference("float32")
    if out_states is not None and len(out_states) >= 5:
        acc_pc, acc_tp, acc_fp, acc_tpl, acc_fpl = out_states[:5]
    elif out_states is not None:
        raise ValueError(
            "detection_map out_states must carry 5 vars (pos_count, "
            "true_pos, false_pos, true_pos_lod, false_pos_lod): the "
            "per-class lod offsets are part of the streaming state in "
            "the padded representation")
    else:
        acc_pc = helper.create_variable_for_type_inference("int32")
        acc_tp = helper.create_variable_for_type_inference("float32")
        acc_fp = helper.create_variable_for_type_inference("float32")
        acc_tpl = helper.create_variable_for_type_inference("int64")
        acc_fpl = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="detection_map", inputs=ins,
        outputs={"MAP": [map_out], "AccumPosCount": [acc_pc],
                 "AccumTruePos": [acc_tp], "AccumFalsePos": [acc_fp],
                 "AccumTruePosLod": [acc_tpl],
                 "AccumFalsePosLod": [acc_fpl]},
        attrs={"class_num": class_num,
               "background_label": background_label,
               "overlap_threshold": overlap_threshold,
               "evaluate_difficult": evaluate_difficult,
               "ap_type": ap_version})
    return map_out


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution,
                         gt_segms_poly_lod=None, gt_segms_point_lod=None):
    """(mask rois, the rois' places among `rois`, mask targets); the two
    *_lod inputs carry the polygons' nesting."""
    ins = {"ImInfo": [im_info], "GtClasses": [gt_classes],
           "IsCrowd": [is_crowd], "GtSegms": [gt_segms],
           "Rois": [rois], "LabelsInt32": [labels_int32]}
    if gt_segms_poly_lod is not None:
        ins["GtSegmsPolyLod"] = [gt_segms_poly_lod]
    if gt_segms_point_lod is not None:
        ins["GtSegmsPointLod"] = [gt_segms_point_lod]
    outs = apply_op("generate_mask_labels", "generate_mask_labels", ins,
                    {"num_classes": num_classes,
                     "resolution": resolution},
                    ["MaskRois", "RoiHasMaskInt32", "MaskInt32"])
    return outs[0], outs[1], outs[2]
