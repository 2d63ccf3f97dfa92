"""The reference's `detection_ops` (13 types) and `yolov3_loss` in the port
(paddle_tpu_torch, on the CPU) against the JAX package.

Table-driven (`tests/torch_det_quant_cases.py`, checked by
`tests/torch_case_parity.py`): each case's reference runs once in a
module fixture (forward and `jax.vjp` under one seeded cotangent); the
port's outputs within fp32 rtol 1e-5 (integer outputs exactly), its
gradients likewise (`roi_align`'s and `roi_pool`'s against `jax.vjp`
through their sample gathers, `yolov3_loss`'s through its cell gather),
`infer_outputs` with a -1 batch equal to the reference's, and the
registry flags equal.

The four NMS types are held exactly: every output equal to the
reference's on identical numpy inputs, on the table's cases, on the
reference's own test cases and on 2,000 boxes x 20 classes with tied
scores and IoUs and `nms_eta` 0.9. `yolov3_loss` is pinned on two ground
truths on one cell and anchor (the later one sets the mask, in both
packages) and on invalid rows (GTMatchMask -1, no mask)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import registry as rreg

import torch_case_parity as parity
import torch_det_quant_cases as dq

NAMES = dq.cases_of("detection_ops", "specialty_ops")
TYPES = sorted({dq.CASES[n][0] for n in NAMES})
NMS_TYPES = ("multiclass_nms", "multiclass_nms2", "locality_aware_nms",
             "matrix_nms")


@pytest.fixture(scope="module")
def reference():
    return parity.reference_results(NAMES, cases=dq)


def test_cases_cover_the_module():
    """Every type the reference's detection_ops registers has a case, and
    `yolov3_loss`; the port registers them all."""
    ref = {t for t in rreg.registered_ops()
           if rreg.get_op(t).compute.__module__
           == "paddle_tpu.ops.detection_ops"} | {"yolov3_loss"}
    assert set(TYPES) == ref and len(TYPES) == 13 + 1
    assert ref <= set(parity.treg.registered_ops())


@pytest.mark.parametrize("name", NAMES)
def test_op_matches_reference(name, reference):
    parity.check_case(name, reference[name], cases=dq)


@pytest.mark.parametrize("name", NAMES)
def test_infer_outputs_matches_reference(name):
    parity.check_infer(name, cases=dq)


@pytest.mark.parametrize("op_type", TYPES)
def test_flags_match_the_reference(op_type):
    parity.check_flags(op_type)


_JITTED = {}


def _reference(op, attrs):
    """The reference's op as a function of its inputs, jitted once for
    each (type, attrs) unless it runs on the host."""
    key = (op, repr(sorted(attrs.items())))
    if key not in _JITTED:
        def ref(d):
            return rreg.normalize_outs(rreg.get_op(op).compute(
                d, dict(attrs)))
        _JITTED[key] = ref if rreg.get_op(op).no_jit else jax.jit(ref)
    return _JITTED[key]


def _both(op, ins, attrs):
    """(the port's outputs, the reference's), slot -> numpy."""
    got = parity.port(op, {s: [torch.tensor(np.asarray(a)) for a in v]
                           for s, v in ins.items()}, attrs)
    want = _reference(op, attrs)(
        {s: [np.asarray(a) for a in v] for s, v in ins.items()})
    return ({s: got[s][0].numpy() for s in got},
            {s: np.asarray(want[s][0]) for s in want})


def _assert_exact(op, ins, attrs):
    got, want = _both(op, ins, attrs)
    assert sorted(got) == sorted(want)
    for s in want:
        assert got[s].dtype == want[s].dtype, s
        np.testing.assert_array_equal(got[s], want[s], err_msg=s)
    return got


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if dq.CASES[n][0] in NMS_TYPES])
def test_nms_case_exact(name):
    op, _, attrs, _, _ = dq.CASES[name]
    _assert_exact(op, dq.inputs(name), attrs)


def test_nms_recorded_digests_are_the_reference():
    """The recorded outputs of the NMS cases (`NMS_DIGESTS`, which the
    card's run in chip_smoke.py must give) are the reference's, and the
    port's on the CPU."""
    names = [n for n in NAMES if dq.CASES[n][0] in NMS_TYPES]
    assert sorted(dq.NMS_DIGESTS) == sorted(names)
    for name in names:
        op, _, attrs, _, _ = dq.CASES[name]
        got, want = _both(op, dq.inputs(name), attrs)
        assert {s: dq.digest(v) for s, v in want.items()} \
            == dq.NMS_DIGESTS[name] == {s: dq.digest(v)
                                        for s, v in got.items()}, name


def _boxes_scores():
    """The reference's own NMS fixture (tests/test_op_longtail.py)."""
    boxes = np.asarray([[[0, 0, 10, 10], [0.5, 0.5, 10.5, 10.5],
                         [20, 20, 30, 30], [40, 40, 50, 50]]], "float32")
    scores = np.asarray([[[0.0, 0.0, 0.0, 0.0],
                          [0.9, 0.8, 0.7, 0.05]]], "float32")
    return {"BBoxes": [boxes], "Scores": [scores]}


_THREE = {"BBoxes": [np.asarray([[[0, 0, 10, 10], [0.5, 0.5, 10, 10],
                                  [20, 20, 30, 30]]], "float32")],
          "Scores": [np.asarray([[[0.9, 0.85, 0.1],
                                  [0.1, 0.05, 0.9]]], "float32")]}
_ABUT = {"BBoxes": [np.asarray([[[0, 0, 9, 9], [9, 0, 18, 9]]], "float32")],
         "Scores": [np.asarray([[[0.0, 0.0], [0.9, 0.8]]], "float32")]}


@pytest.mark.parametrize("op,ins,attrs,rows", [
    ("multiclass_nms2", _boxes_scores(),
     {"score_threshold": 0.1, "nms_threshold": 0.3, "nms_top_k": 10,
      "keep_top_k": 10, "background_label": 0}, 2),
    ("multiclass_nms", _boxes_scores(),
     {"score_threshold": 0.1, "nms_threshold": 0.3, "nms_top_k": 10,
      "keep_top_k": 10, "background_label": 0}, 2),
    ("matrix_nms", _boxes_scores(),
     {"score_threshold": 0.1, "post_threshold": 0.0, "nms_top_k": -1,
      "keep_top_k": -1, "background_label": 0, "use_gaussian": False}, 3),
    ("multiclass_nms", _THREE,
     {"score_threshold": 0.3, "nms_threshold": 0.5, "background_label": -1,
      "keep_top_k": 10}, 2),
    ("multiclass_nms", _ABUT,
     {"score_threshold": 0.1, "nms_threshold": 0.04, "nms_top_k": 10,
      "keep_top_k": 10, "background_label": 0, "normalized": True}, 2),
    ("multiclass_nms", _ABUT,
     {"score_threshold": 0.1, "nms_threshold": 0.04, "nms_top_k": 10,
      "keep_top_k": 10, "background_label": 0, "normalized": False}, 1),
], ids=["nms2_index", "nms_fixture", "matrix_decay", "three_boxes",
        "abutting_normalized", "abutting_pixels"])
def test_nms_reference_cases_exact(op, ins, attrs, rows):
    """The reference's own NMS tests (tests/test_op_longtail.py
    `test_multiclass_nms2_index`, `test_matrix_nms_decay`,
    `test_nms_normalized_false_uses_pixel_extents`;
    tests/test_ops_extended.py `TestMulticlassNMS`): equal outputs."""
    got = _assert_exact(op, ins, attrs)
    assert got["Out"].shape[0] == rows


def test_nms_2000_boxes_ties_eta_exact():
    """2,000 boxes x 20 classes on a coarse grid (tied IoUs), scores on
    16 levels (tied scores), `nms_eta` 0.9 from a threshold of 0.8 and
    pixel extents: `multiclass_nms2` equals the reference's pairwise
    loop exactly, rows and indices in the same order."""
    r = np.random.RandomState(20)
    n, classes = 2000, 20
    x1 = r.randint(0, 60, (1, n)) * 4.0
    y1 = r.randint(0, 60, (1, n)) * 4.0
    wh = r.randint(3, 10, (1, n, 2)) * 4.0
    boxes = np.stack([x1, y1, x1 + wh[..., 0], y1 + wh[..., 1]],
                     -1).astype("float32")
    scores = (r.randint(0, 16, (1, classes, n)) / 16.0).astype("float32")
    attrs = {"score_threshold": 0.3, "nms_top_k": 60, "keep_top_k": 300,
             "nms_threshold": 0.8, "nms_eta": 0.9, "normalized": False,
             "background_label": 0}
    got = _assert_exact("multiclass_nms2", {"BBoxes": [boxes],
                                            "Scores": [scores]}, attrs)
    assert got["Out"].shape[0] == 300
    assert len(np.unique(got["Out"][:, 1])) < 20  # tied scores kept


def _yolo(name, **over):
    op, _, attrs, _, _ = dq.CASES[name]
    ins = dq.inputs(name)
    ins.update(over)
    return _both(op, ins, attrs), ins


def test_yolov3_loss_duplicate_cell_last_wins():
    """Rows 1 and 3 of image 0 fall on one cell with one best anchor
    (mask place 2): the mask holds row 3's score in both packages, as
    Paddle's loop over the ground truths in order leaves it."""
    (got, want), ins = _yolo("yolov3_loss")
    match = want["GTMatchMask"]
    assert match[0, 1] == match[0, 3] == 2
    score = ins["GTScore"][0]
    gt = ins["GTBox"][0]
    gj, gi = int(gt[0, 3, 1] * 8), int(gt[0, 3, 0] * 8)
    assert (gj, gi) == (int(gt[0, 1, 1] * 8), int(gt[0, 1, 0] * 8))
    for mask in (got["ObjectnessMask"], want["ObjectnessMask"]):
        assert mask[0, 2, gj, gi] == score[0, 3] != score[0, 1]
    np.testing.assert_array_equal(got["ObjectnessMask"],
                                  want["ObjectnessMask"])


def test_yolov3_loss_order_of_duplicates_decides():
    """Swapping the two rows on the shared cell swaps the winner: the
    rule is index order, not the larger score."""
    (base, _), ins = _yolo("yolov3_loss")
    gt, lab, score = (ins[s][0].copy() for s in ("GTBox", "GTLabel",
                                                 "GTScore"))
    for a in (gt, lab, score):
        a[0, [1, 3]] = a[0, [3, 1]]
    (got, want), _ = _yolo("yolov3_loss", GTBox=[gt], GTLabel=[lab],
                           GTScore=[score])
    gj, gi = int(gt[0, 3, 1] * 8), int(gt[0, 3, 0] * 8)
    assert got["ObjectnessMask"][0, 2, gj, gi] == score[0, 3]
    assert base["ObjectnessMask"][0, 2, gj, gi] == score[0, 1]
    np.testing.assert_array_equal(got["ObjectnessMask"],
                                  want["ObjectnessMask"])
    np.testing.assert_allclose(got["Loss"], want["Loss"], rtol=1e-5)


def test_yolov3_loss_invalid_rows_drop():
    """A row with w or h <= 0 matches nothing (-1) and marks no cell;
    zeroing it leaves the loss as it was."""
    (got, want), ins = _yolo("yolov3_loss")
    assert got["GTMatchMask"][0, 4] == want["GTMatchMask"][0, 4] == -1
    assert (got["GTMatchMask"][1, 3:] == -1).all()
    gt = ins["GTBox"][0].copy()
    gt[0, 4] = 0.0
    (again, _), _ = _yolo("yolov3_loss", GTBox=[gt])
    np.testing.assert_array_equal(again["Loss"], got["Loss"])
    np.testing.assert_array_equal(again["ObjectnessMask"],
                                  got["ObjectnessMask"])


def test_roi_align_roi_gradient_matches_reference():
    """`roi_align`'s gradient with respect to the ROIs (through the
    bilinear weights) against `jax.vjp`."""
    name = "roi_align"
    op, _, attrs, _, _ = dq.CASES[name]
    ins = dq.inputs(name)
    x, rois = ins["X"][0], ins["ROIs"][0]
    ct = np.random.RandomState(3).randn(4, 3, 2, 3).astype("float32")
    want = jax.jit(lambda rv, c: jax.vjp(lambda r: rreg.get_op(op).compute(
        {"X": [jnp.asarray(x)], "ROIs": [r]}, dict(attrs))["Out"],
        rv)[1](c)[0])(jnp.asarray(rois), jnp.asarray(ct))
    rt = torch.tensor(rois, requires_grad=True)
    out = parity.port(op, {"X": [torch.tensor(x)], "ROIs": [rt]},
                      attrs)["Out"][0]
    (got,) = torch.autograd.grad(out, [rt], torch.tensor(ct))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _detection_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        feat = L.data(name="feat", shape=[4, 6, 8], dtype="float32")
        image = L.data(name="image", shape=[3, 48, 64], dtype="float32")
        gt = L.data(name="gt", shape=[4], dtype="float32",
                    append_batch_size=False)
        rois = L.data(name="rois", shape=[4], dtype="float32",
                      append_batch_size=False)
        loc = L.data(name="loc", shape=[6 * 8 * 8, 4], dtype="float32")
        conf = L.data(name="conf", shape=[3, 6 * 8 * 8], dtype="float32")
        label = L.data(name="label", shape=[6 * 8 * 8], dtype="int32")
        boxes, var = L.prior_box(feat, image, [8.0, 16.0], [12.0, 24.0],
                                 aspect_ratios=[2.0], flip=True, clip=True)
        dboxes, _ = L.density_prior_box(feat, image, densities=[2],
                                        fixed_sizes=[8.0],
                                        fixed_ratios=[1.0])
        anchors, _ = L.anchor_generator(feat, [16.0, 32.0], [0.5, 1.0],
                                        stride=[8.0, 8.0])
        pb = L.reshape(boxes, [-1, 4])
        pv = L.reshape(var, [-1, 4])
        enc = L.box_coder(pb, pv, gt)
        iou = L.iou_similarity(gt, pb)
        im_info = L.fill_constant([1, 3], "float32", 40.0)
        clipped = L.box_clip(L.reshape(anchors, [1, -1, 4]), im_info)
        det = L.detection_output(loc, conf, pb, pv, score_threshold=0.05,
                                 nms_top_k=30, keep_top_k=20)
        align = L.roi_align(feat, rois, 2, 2, spatial_scale=0.5)
        pool = L.roi_pool(feat, rois, 2, 2, spatial_scale=0.5)
        focal = L.sigmoid_focal_loss(L.reshape(conf, [-1, 3]),
                                     L.reshape(label, [-1, 1]))
    return main, startup, [boxes, dboxes, anchors, enc, iou, clipped, det,
                           align, pool, focal]


def test_detection_layers_build_the_reference_program():
    """`fluid.layers.detection`'s functions emit the reference's program
    op by op (types, attrs and slots; each op's values are held by the
    cases above), and the port's runs: finite outputs, NMS rows of 6."""
    import paddle_tpu.fluid as rfluid
    import paddle_tpu_torch.fluid as tfluid

    r = np.random.RandomState(5)
    gt = np.concatenate([r.uniform(0.0, 0.5, (3, 2)),
                         r.uniform(0.55, 1.0, (3, 2))], 1)
    feed = {"feat": r.randn(2, 4, 6, 8).astype("float32"),
            "image": r.randn(2, 3, 48, 64).astype("float32"),
            "gt": gt.astype("float32"),
            "rois": np.asarray([[1, 2, 9, 10], [0, 0, 15, 11]], "float32"),
            "loc": (r.randn(1, 384, 4) * 0.2).astype("float32"),
            "conf": r.uniform(0, 1, (1, 3, 384)).astype("float32"),
            "label": r.randint(0, 4, (1, 384)).astype("int32")}
    rmain = _detection_program(rfluid)[0]
    main, startup, outs = _detection_program(tfluid)
    parity.assert_same_program(rmain, main)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed=feed, fetch_list=outs, scope=tfluid.Scope())
    assert all(np.isfinite(g).all() for g in got)
    assert got[6].shape[1] == 6 and 0 < got[6].shape[0] <= 20
