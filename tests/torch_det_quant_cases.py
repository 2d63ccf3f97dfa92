"""The op cases of the detection and quantization slice: the reference's
`interp_ops` (5 types), `quant_ops` (11), `detection_ops` (13) and
`specialty_ops`' `yolov3_loss`. `tests/test_torch_interp_quant_ops.py`
and `tests/test_torch_detection_ops.py` hold each against the JAX
package on the CPU; `tests/test_torch_detection_cuda.py` and
`chip_smoke.py` phase 21 leg d, the card against the CPU. Plain numpy
and no JAX, so the card's machine imports it too.

`CASES`: name -> (op type, {slot: [numpy maker]}, attrs, float input
slots to differentiate, batch-carrying slots for a -1 inference check),
as in `tests/torch_nn_cases.py`. A maker takes a
`numpy.random.RandomState`; `inputs(name)` draws a case's inputs from
the state seeded by its position among the names. `MODULE`: op type ->
the reference file that registers it. `NMS_DIGESTS`: the reference's
outputs of the host-side (NMS) cases, recorded as `digest`s (held by
`tests/test_torch_detection_ops.py`), which the card's run must give
exactly."""
import hashlib

import numpy as np


def _f(*shape, scale=1.0):
    return lambda r: (r.randn(*shape) * scale).astype("float32")


def _c(v, dtype="float32"):
    return lambda r: np.asarray(v, dtype)


def _i(high, *shape, low=0, dtype="int32"):
    return lambda r: r.randint(low, high, size=shape).astype(dtype)


def _boxes(*lead, lo=0.0, hi=40.0, size=(2.0, 16.0)):
    """Corner boxes [..., 4] inside [lo, hi], extents within `size`."""
    def make(r):
        x1 = r.uniform(lo, hi - size[1], lead)
        y1 = r.uniform(lo, hi - size[1], lead)
        w = r.uniform(size[0], size[1], lead)
        h = r.uniform(size[0], size[1], lead)
        return np.stack([x1, y1, x1 + w, y1 + h], -1).astype("float32")
    return make


def _tied_boxes(n, classes, boxes=None):
    """Corner boxes [1, n, 4] on a coarse grid, so that IoUs and scores
    repeat (ties), with scores [1, classes, n] from a few levels."""
    def make_boxes(r):
        x1 = r.randint(0, 30, n) * 2.0
        y1 = r.randint(0, 30, n) * 2.0
        wh = r.randint(2, 8, (n, 2)) * 2.0
        return np.stack([x1, y1, x1 + wh[:, 0], y1 + wh[:, 1]],
                        -1)[None].astype("float32")

    def make_scores(r):
        return (r.randint(0, 12, (1, classes, n)) / 12.0).astype("float32")
    return make_boxes, make_scores


def _quads(b, n):
    def make(r):
        c = r.uniform(5, 35, (b, n, 1, 2))
        off = r.uniform(1, 6, (b, n, 4, 2)) * np.asarray(
            [[-1, -1], [1, -1], [1, 1], [-1, 1]])
        return (c + off).reshape(b, n, 8).astype("float32")
    return make


def _sorted_scores(b, c, n):
    def make(r):
        return r.uniform(0.0, 1.0, (b, c, n)).astype("float32")
    return make


def _interp(op, shape, attrs, layout=None, diff=True):
    a = dict(attrs)
    if layout:
        a["data_layout"] = layout
    return (op, {"X": [_f(*shape)]}, a, ["X"] if diff else [], ["X"])


def _q(op, ins, attrs, diff=("X",)):
    return (op, ins, attrs, list(diff), [])


#: anchors and masks of YOLOv3 (PaddleDetection's yolov3_darknet.yml)
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]
#: ground truths [2, 6, 4] (cx, cy, w, h over a 64 x 64 image): image 0
#: has two on one cell with one best anchor (rows 1 and 3) and an
#: invalid row; image 1 a zero-padded tail
_GT = np.asarray([
    [[0.30, 0.40, 0.25, 0.35], [0.70, 0.60, 0.50, 0.40],
     [0.10, 0.15, 0.05, 0.08], [0.72, 0.62, 0.52, 0.42],
     [0.50, 0.50, 0.00, 0.20], [0.90, 0.20, 0.15, 0.30]],
    [[0.45, 0.55, 0.60, 0.70], [0.20, 0.80, 0.12, 0.20],
     [0.65, 0.35, 0.30, 0.25], [0.0, 0.0, 0.0, 0.0],
     [0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]]], "float32")


def _yolo_loss(mask, ratio, hw, smooth=True, score=True, classes=4):
    ins = {"X": [_f(2, len(mask) * (5 + classes), hw, hw)],
           "GTBox": [_c(_GT)],
           "GTLabel": [_c([[1, 3, 0, 2, 1, 3], [0, 2, 1, 0, 0, 0]],
                          "int32")]}
    if score:
        ins["GTScore"] = [lambda r: r.uniform(0.5, 1.0, (2, 6)).astype(
            "float32")]
    return ("yolov3_loss", ins,
            {"anchors": YOLO_ANCHORS, "anchor_mask": mask,
             "class_num": classes, "ignore_thresh": 0.5,
             "downsample_ratio": ratio, "use_label_smooth": smooth},
            ["X"], [])


_NMS = {"score_threshold": 0.05, "nms_top_k": 20, "keep_top_k": 15,
        "nms_threshold": 0.4, "background_label": 0}
_TB, _TS = _tied_boxes(60, 3)

CASES = {
    # -- interp_ops ---------------------------------------------------------
    "linear_interp_corners_up": _interp(
        "linear_interp", (2, 3, 7), {"out_w": 12, "align_corners": True}),
    "linear_interp_mode0_down": _interp(
        "linear_interp", (2, 3, 9), {"out_w": 5, "align_corners": False,
                                     "align_mode": 0}),
    "linear_interp_mode1_scale_nwc": _interp(
        "linear_interp", (2, 6, 3), {"scale": 1.5, "align_corners": False,
                                     "align_mode": 1}, "NWC"),
    "linear_interp_size1": _interp(
        "linear_interp", (2, 3, 6), {"out_w": 1}),
    "bilinear_interp_corners_up": _interp(
        "bilinear_interp", (2, 3, 5, 6), {"out_h": 9, "out_w": 11,
                                          "align_corners": True}),
    "bilinear_interp_mode0_down": _interp(
        "bilinear_interp", (2, 3, 7, 9), {"out_h": 3, "out_w": 4,
                                          "align_corners": False,
                                          "align_mode": 0}),
    "bilinear_interp_mode1_up_nhwc": _interp(
        "bilinear_interp", (2, 4, 5, 3), {"out_h": 7, "out_w": 8,
                                          "align_corners": False,
                                          "align_mode": 1}, "NHWC"),
    "bilinear_interp_size1": _interp(
        "bilinear_interp", (1, 2, 4, 5), {"out_h": 1, "out_w": 1}),
    "bilinear_interp_scale_mixed": _interp(
        "bilinear_interp", (1, 2, 4, 6), {"scale": 0.5, "out_h": 6,
                                          "align_corners": False,
                                          "align_mode": 0}),
    "trilinear_interp_mode0": _interp(
        "trilinear_interp", (1, 2, 3, 4, 5), {"out_d": 5, "out_h": 6,
                                              "out_w": 3,
                                              "align_corners": False,
                                              "align_mode": 0}),
    "trilinear_interp_corners_ndhwc": _interp(
        "trilinear_interp", (1, 3, 4, 2, 2), {"out_d": 2, "out_h": 7,
                                              "out_w": 4,
                                              "align_corners": True},
        "NDHWC"),
    "bicubic_interp_corners_up": _interp(
        "bicubic_interp", (2, 2, 5, 6), {"out_h": 9, "out_w": 8,
                                         "align_corners": True}),
    "bicubic_interp_half_pixel_down": _interp(
        "bicubic_interp", (2, 2, 9, 7), {"out_h": 4, "out_w": 3,
                                         "align_corners": False}),
    "bicubic_interp_nhwc_scale": _interp(
        "bicubic_interp", (1, 4, 5, 3), {"scale": 2.0,
                                         "align_corners": False}, "NHWC"),
    "nearest_interp_corners_x2": _interp(
        "nearest_interp", (2, 3, 5, 6), {"scale": 2.0,
                                         "align_corners": True}),
    "nearest_interp_up": _interp(
        "nearest_interp", (2, 3, 5, 6), {"out_h": 8, "out_w": 13,
                                         "align_corners": False}),
    "nearest_interp_down_nhwc": _interp(
        "nearest_interp", (2, 9, 7, 3), {"out_h": 4, "out_w": 3,
                                         "align_corners": False}, "NHWC"),
    "nearest_interp_corners_down": _interp(
        "nearest_interp", (1, 2, 9, 8), {"out_h": 4, "out_w": 3,
                                         "align_corners": True}),
    "nearest_interp_size1": _interp(
        "nearest_interp", (1, 2, 4, 5), {"out_h": 1, "out_w": 1}),
    # -- quant_ops ----------------------------------------------------------
    "fake_quantize_abs_max": _q(
        "fake_quantize_abs_max", {"X": [_f(4, 6)]}, {"bit_length": 8}),
    "fake_quantize_abs_max_static": _q(
        "fake_quantize_abs_max", {"X": [_f(4, 6)]},
        {"bit_length": 8, "static_scale": 1.5}),
    "fake_quantize_dequantize_abs_max": _q(
        "fake_quantize_dequantize_abs_max", {"X": [_f(3, 5, scale=3.0)]},
        {"bit_length": 4}),
    "fake_channel_wise_quantize_abs_max": _q(
        "fake_channel_wise_quantize_abs_max", {"X": [_f(4, 3, 3, 3)]},
        {"bit_length": 8, "quant_axis": 0}),
    "fake_channel_wise_quantize_abs_max_axis1": _q(
        "fake_channel_wise_quantize_abs_max", {"X": [_f(6, 5)]},
        {"bit_length": 8, "quant_axis": 1}),
    "fake_quantize_moving_average_abs_max_first": _q(
        "fake_quantize_moving_average_abs_max",
        {"X": [_f(4, 6)], "InScale": [_c([0.0])]}, {"moving_rate": 0.9}),
    "fake_quantize_moving_average_abs_max": _q(
        "fake_quantize_moving_average_abs_max",
        {"X": [_f(4, 6)], "InScale": [_c([1.7])]}, {"moving_rate": 0.9}),
    "fake_quantize_moving_average_abs_max_test": _q(
        "fake_quantize_moving_average_abs_max",
        {"X": [_f(4, 6)], "InScale": [_c([1.1])]},
        {"moving_rate": 0.9, "is_test": True}),
    "fake_quantize_dequantize_moving_average_abs_max": _q(
        "fake_quantize_dequantize_moving_average_abs_max",
        {"X": [_f(2, 3, 4)], "InScale": [_c([2.5])]},
        {"moving_rate": 0.8, "bit_length": 6}),
    "fake_quantize_range_abs_max": _q(
        "fake_quantize_range_abs_max",
        {"X": [_f(4, 6)], "InScale": [_c([1.9])], "Iter": [_c([3], "int64")],
         "InScales": [_c([0.5, 1.9, 1.2, 0.7, 0.0, 0.0, 0.0, 0.0])]},
        {"window_size": 8}),
    "fake_quantize_range_abs_max_evicts_max": _q(
        "fake_quantize_range_abs_max",
        {"X": [_f(4, 6, scale=0.2)], "InScale": [_c([1.9])],
         "Iter": [_c([9], "int64")],
         "InScales": [_c([0.5, 1.9, 1.2, 0.7, 0.3, 0.9, 1.0, 0.4])]},
        {"window_size": 8}),
    "fake_quantize_range_abs_max_fresh": _q(
        "fake_quantize_range_abs_max",
        {"X": [_f(4, 6)], "InScale": [_c([0.0])]}, {"window_size": 16}),
    "fake_quantize_range_abs_max_test": _q(
        "fake_quantize_range_abs_max",
        {"X": [_f(4, 6)], "InScale": [_c([0.8])]}, {"is_test": True}),
    "fake_dequantize_max_abs": _q(
        "fake_dequantize_max_abs",
        {"X": [_i(127, 4, 5, low=-127, dtype="float32")],
         "Scale": [_c([2.5])]}, {"max_range": 127.0}, diff=()),
    "fake_channel_wise_dequantize_max_abs": _q(
        "fake_channel_wise_dequantize_max_abs",
        {"X": [_i(127, 3, 2, 2, 2, low=-127, dtype="float32")],
         "Scales": [_c([0.5, 1.5, 2.5])]}, {"quant_bits": [8]}, diff=()),
    "fake_channel_wise_dequantize_max_abs_two": _q(
        "fake_channel_wise_dequantize_max_abs",
        {"X": [_i(127, 2, 3, 4, low=-127, dtype="float32")],
         "Scales": [_c([0.5, 1.5, 2.5]), _c([3.0])]},
        {"quant_bits": [8, 8]}, diff=()),
    "dequantize_abs_max": _q(
        "dequantize_abs_max",
        {"X": [_i(127, 4, 5, low=-128, dtype="int8")],
         "Scale": [_c([3.0])]}, {"max_range": 127.0}, diff=()),
    "dequantize_log": _q(
        "dequantize_log",
        {"X": [_i(127, 4, 6, low=-128, dtype="int8")],
         "Dict": [lambda r: np.sort(r.uniform(0, 4, 128)).astype(
             "float32")]}, {}, diff=()),
    "moving_average_abs_max_scale": _q(
        "moving_average_abs_max_scale",
        {"X": [_f(3, 4)], "InScale": [_c([0.6])]}, {"moving_rate": 0.9}),
    "moving_average_abs_max_scale_fresh": _q(
        "moving_average_abs_max_scale", {"X": [_f(3, 4)]}, {}),
    "moving_average_abs_max_scale_test": _q(
        "moving_average_abs_max_scale",
        {"X": [_f(3, 4)], "InScale": [_c([0.6])]}, {"is_test": True}),
    # -- detection_ops ------------------------------------------------------
    "iou_similarity": ("iou_similarity", {"X": [_boxes(5)],
                                          "Y": [_boxes(3)]},
                       {}, ["X"], []),
    "box_clip": ("box_clip", {"Input": [_boxes(2, 5, lo=-10.0, hi=60.0)],
                              "ImInfo": [_c([[40.0, 50.0, 1.0]])]},
                 {}, ["Input"], []),
    "box_coder_encode": ("box_coder", {
        "PriorBox": [_boxes(6)], "PriorBoxVar": [_c(
            np.tile([0.1, 0.1, 0.2, 0.2], (6, 1)))],
        "TargetBox": [_boxes(3)]}, {"code_type": "encode_center_size"},
        ["TargetBox"], []),
    "box_coder_encode_pixels": ("box_coder", {
        "PriorBox": [_boxes(4)], "TargetBox": [_boxes(3)]},
        {"code_type": "encode_center_size", "box_normalized": False},
        ["TargetBox"], []),
    "box_coder_decode": ("box_coder", {
        "PriorBox": [_boxes(6)], "PriorBoxVar": [_c(
            np.tile([0.1, 0.1, 0.2, 0.2], (6, 1)))],
        "TargetBox": [_f(2, 6, 4, scale=0.5)]},
        {"code_type": "decode_center_size"}, ["TargetBox"], []),
    "prior_box": ("prior_box", {"Input": [_f(1, 8, 4, 5)],
                                "Image": [_f(1, 3, 32, 40)]},
                  {"min_sizes": [8.0, 16.0], "max_sizes": [12.0, 24.0],
                   "aspect_ratios": [2.0], "flip": True, "clip": True},
                  [], []),
    "prior_box_steps": ("prior_box", {"Input": [_f(1, 8, 3, 3)],
                                      "Image": [_f(1, 3, 30, 30)]},
                        {"min_sizes": [10.0], "aspect_ratios": [1.0, 3.0],
                         "step_w": 9.0, "step_h": 11.0, "offset": 0.25},
                        [], []),
    "density_prior_box": ("density_prior_box", {
        "Input": [_f(1, 8, 4, 5)], "Image": [_f(1, 3, 32, 40)]},
        {"fixed_sizes": [8.0, 16.0], "densities": [2, 1],
         "fixed_ratios": [1.0, 2.0], "clip": True}, [], []),
    "anchor_generator": ("anchor_generator", {"Input": [_f(1, 8, 4, 5)]},
                         {"anchor_sizes": [16.0, 32.0],
                          "aspect_ratios": [0.5, 1.0, 2.0],
                          "stride": [8.0, 8.0]}, [], []),
    "yolo_box": ("yolo_box", {"X": [_f(2, 2 * 8, 4, 5)],
                              "ImgSize": [_c([[64, 80], [32, 40]],
                                             "int32")]},
                 {"anchors": [10, 13, 16, 30], "class_num": 3,
                  "conf_thresh": 0.5, "downsample_ratio": 16}, ["X"], []),
    "roi_align": ("roi_align", {"X": [_f(1, 3, 12, 14)],
                                "ROIs": [_boxes(4, lo=0.0, hi=26.0,
                                                size=(3.0, 12.0))]},
                  {"pooled_height": 2, "pooled_width": 3,
                   "spatial_scale": 0.5, "sampling_ratio": 2}, ["X"], []),
    "roi_align_adaptive_ratio": ("roi_align", {
        "X": [_f(1, 2, 10, 10)],
        "ROIs": [_boxes(3, lo=0.0, hi=10.0, size=(2.0, 6.0))]},
        {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 1.0,
         "sampling_ratio": -1}, ["X"], []),
    "roi_pool": ("roi_pool", {"X": [_f(1, 3, 12, 14)],
                              "ROIs": [_boxes(4, lo=0.0, hi=26.0,
                                              size=(3.0, 12.0))]},
                 {"pooled_height": 2, "pooled_width": 2,
                  "spatial_scale": 0.5}, ["X"], []),
    "multiclass_nms": ("multiclass_nms", {
        "BBoxes": [_boxes(2, 30)], "Scores": [_sorted_scores(2, 4, 30)]},
        dict(_NMS), [], []),
    "multiclass_nms_pixels_eta": ("multiclass_nms", {
        "BBoxes": [_TB], "Scores": [_TS]},
        dict(_NMS, normalized=False, nms_eta=0.9, nms_threshold=0.7,
             background_label=-1, keep_top_k=-1), [], []),
    "multiclass_nms2": ("multiclass_nms2", {
        "BBoxes": [_boxes(2, 30)], "Scores": [_sorted_scores(2, 4, 30)]},
        dict(_NMS, background_label=2), [], []),
    "locality_aware_nms": ("locality_aware_nms", {
        "BBoxes": [_boxes(1, 14, size=(8.0, 16.0))],
        "Scores": [_sorted_scores(1, 2, 14)]},
        {"score_threshold": 0.1, "nms_top_k": 10, "keep_top_k": 8,
         "nms_threshold": 0.3, "background_label": -1}, [], []),
    "locality_aware_nms_quads": ("locality_aware_nms", {
        "BBoxes": [_quads(1, 10)], "Scores": [_sorted_scores(1, 1, 10)]},
        {"score_threshold": 0.1, "nms_top_k": -1, "keep_top_k": -1,
         "nms_threshold": 0.2, "normalized": False}, [], []),
    "matrix_nms": ("matrix_nms", {
        "BBoxes": [_boxes(2, 20)], "Scores": [_sorted_scores(2, 3, 20)]},
        {"score_threshold": 0.1, "post_threshold": 0.2, "nms_top_k": 12,
         "keep_top_k": 10, "background_label": 0}, [], []),
    "matrix_nms_gaussian": ("matrix_nms", {
        "BBoxes": [_boxes(1, 20)], "Scores": [_sorted_scores(1, 3, 20)]},
        {"score_threshold": 0.1, "post_threshold": 0.05, "nms_top_k": -1,
         "keep_top_k": -1, "background_label": -1, "use_gaussian": True,
         "gaussian_sigma": 2.0, "normalized": False}, [], []),
    # -- specialty_ops: yolov3_loss ------------------------------------------
    "yolov3_loss": _yolo_loss([0, 1, 2], 8, 8),
    "yolov3_loss_deep_head": _yolo_loss([6, 7, 8], 32, 2, smooth=False),
    "yolov3_loss_no_score": _yolo_loss([3, 4, 5], 16, 4, score=False),
}

#: the reference's outputs of the NMS cases (`digest` of each output)
NMS_DIGESTS = {
    "locality_aware_nms": {
        "Out": "7f97d3180e415cecc938920fa349db89be0280ad1def5d42e4d1224bb5b055ad"},
    "locality_aware_nms_quads": {
        "Out": "d27b8894b342323ca482e6ee3aabd6b9ae350bb065c46ff3b43cc702d5cd27a7"},
    "matrix_nms": {
        "Index": "9587cb077ac93223dd55c42a8c9d61c3efc88130743769ee36016973cc497f74",
        "Out": "b518d714264eb8c1edd8994eadc24c15b095045f64ee68ef9ea6668a30410b11",
        "RoisNum": "707ae6c154eaeb1928e196e8b15d4e69b4a9b4bfd8a126a3bc9a520d9df93c0b"},
    "matrix_nms_gaussian": {
        "Index": "e4b933c9ad6dce6334b9d6bbf7752d0d8ce961284bd529246ab69f0f1ed1b7eb",
        "Out": "b8c14b9eeedee350f2fc98651d9b4266981e4f285d41be8d8f31e5b651c1a304",
        "RoisNum": "7773b9faed0e617bbf847e99806a4f6fadc46d179840b9fad8969f94b02446e9"},
    "multiclass_nms": {
        "Out": "b69605a05c09e000b051213ad91e610cdc4adf559f83ee6ec4d9d07553615f4e"},
    "multiclass_nms2": {
        "Index": "d0b67e988b037088d132422635c34cebd88d4a903290939659b94e2f66316a8d",
        "Out": "abf037de16f99f6195f88816c9e6622fa88d275e414c4c31e5767dd87841ff0e"},
    "multiclass_nms_pixels_eta": {
        "Out": "43bf018c23f53bb0541a22959a382d52338b3cf98339f75f592841cf4d5d3e98"},
}

_MODULES = {
    "interp_ops": {"linear_interp", "bilinear_interp", "trilinear_interp",
                   "bicubic_interp", "nearest_interp"},
    "detection_ops": {
        "iou_similarity", "box_clip", "box_coder", "prior_box",
        "density_prior_box", "anchor_generator", "yolo_box", "roi_align",
        "roi_pool", "multiclass_nms", "multiclass_nms2",
        "locality_aware_nms", "matrix_nms"},
    "specialty_ops": {"yolov3_loss"},
}


def _module(op_type):
    return next((m for m, ts in _MODULES.items() if op_type in ts),
                "quant_ops")


#: op type -> the reference file that registers it
MODULE = {c[0]: _module(c[0]) for c in CASES.values()}


def cases_of(*modules):
    """The case names whose op type the reference registers in one of
    `modules` ("interp_ops", "quant_ops", "detection_ops",
    "specialty_ops")."""
    return sorted(n for n, c in CASES.items() if MODULE[c[0]] in modules)


def digest(a):
    """sha256 of an array's dtype, shape and bytes."""
    a = np.ascontiguousarray(a)
    return hashlib.sha256(("%s%s" % (a.dtype.str, a.shape)).encode()
                          + a.tobytes()).hexdigest()


def inputs(name):
    """{slot: [numpy array]} of case `name`."""
    r = np.random.RandomState(sorted(CASES).index(name))
    return {slot: [make(r) for make in ms]
            for slot, ms in CASES[name][1].items()}
