"""The detection and quantization slice's programs in the port
(paddle_tpu_torch, on the CPU) against the JAX package, built once for
both by `tests/torch_detection_programs.py`.

- The tiny YOLOv3 (DarkNet-53's layout at depths [1, 1, 1, 1, 1], widths
  / 8, 64 x 64 images, 4 classes, 6 ground-truth rows, batch 2) from one
  start state in both (the port's startup's): the same programs op by
  op; the first
  step's loss within rtol 1e-5, its objectness and match masks equal
  and its three head outputs within 2e-4 of their scale (batch norm
  over the 2 x 2 deepest maps, 8 values a channel, scales the fp32
  roundings of the convolutions up). Over 3 steps
  the losses agree within YOLO_STEP_RTOL (5e-2) only: this net's
  training is chaotic at lr 0.001 (its 2 x 2 deepest maps give batch
  norm 8 values a channel, and a leaky_relu input within an fp32
  rounding of 0 takes the other slope in one package), so the
  reference itself, rerun on inputs moved by 1e-7, leaves its own
  trajectory by 1% in loss and 57% in parameter norm within 3 steps.
  The port's inference program (the same as the reference's, op by op)
  from its trained state: each `yolo_box` within 1e-5 of the
  reference's op on the same head output, and `multiclass_nms` equal
  to the reference's op on the same boxes and scores.
- The small QAT ResNet (`resnet()` at depth 18, 32 x 32, 10 classes,
  batch 4) under `QuantizationTransformPass`: the same program op by op;
  the first step's weight quantizers bit-equal to the reference's
  quantizer run op by op on the same weights, and its input quantizer
  within 1e-5 of a grid step of the reference's jitted one (XLA
  dequantizes with a multiplication by scale / 127, an ulp off in some
  cells). The first step's loss agrees within QAT_LOSS_RTOL (2e-2) and
  the scale states after 3 steps within QAT_SCALE_RTOL (0.1) only: at
  32 x 32 the last stage's maps are 1 x 1, so batch norm normalizes 4
  values a channel, and an activation that differs by an fp32 rounding
  can cross a rounding boundary of its quantizer, one grid step (1/127
  of its scale) that the next layers carry on (measured: 1.3% in the
  first step's loss, up to 3.8% in a scale after 3 steps; at lr 0.1 and
  batch 4 the loss climbs in both packages, and their third losses part
  by 14%). The evaluation clone frozen in both packages from
  the reference's trained state: logits within 2e-3 of their scale
  (measured 1.2e-3); saved and loaded by the port, equal.
- `range_mlp`, an MLP through `fake_quantize_range_abs_max` with its
  scale, window and `Iter` persistable: 7 steps over a window of 4 (the
  window wraps), losses and the scale and window within rtol 1e-5, Iter
  exact.
- The reference's `tests/test_quantization.py` flows through the port:
  the QAT MLP trains, post-training quantization calibrates, the
  freeze round trip works, and `clone(for_test=True)` freezes the
  scales.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rfluid
from paddle_tpu.core.scope import Scope as RScope
from paddle_tpu.ops import registry as rreg

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.scope import load_numpy_state
from paddle_tpu_torch.core.types import to_numpy
from paddle_tpu_torch.fluid.contrib.slim import quantization as tq

import torch_case_parity as parity
import torch_detection_programs as dp

TINY_YOLO, SMALL_QAT = dp.TINY_YOLO, dp.SMALL_QAT
#: the small QAT ResNet's first loss and its scales (module docstring)
QAT_LOSS_RTOL = dp.TOL["qat_loss"]
QAT_SCALE_RTOL = dp.TOL["qat_scales"]
#: its frozen evaluation program from one state (module docstring)
FROZEN_RTOL = dp.TOL["frozen"]


def _persistables(program):
    return sorted(v.name for v in program.list_vars() if v.persistable)


def _start(rprog, tstartup):
    """One start state in both packages, from the port's startup program
    (the reference's would cost a compile of its initializers): (the
    reference's executor and scope, the port's)."""
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(tstartup, scope=tscope)
    rscope = RScope()
    for n in _persistables(rprog):
        rscope.set_var(n, jnp.asarray(to_numpy(tscope.find_var(n))))
    return rfluid.Executor(rfluid.CPUPlace()), rscope, texe, tscope


def _steps(exe, prog, feeds, fetch, scope):
    return [[np.asarray(v) for v in exe.run(prog, feed=f, fetch_list=fetch,
                                            scope=scope)] for f in feeds]


#: the tiny YOLOv3's trajectories over 3 steps (module docstring)
YOLO_STEP_RTOL = dp.TOL["yolo_steps"]


@pytest.fixture(scope="module")
def yolo():
    ref = dp.yolov3_darknet53(rfluid, **TINY_YOLO)
    port = dp.yolov3_darknet53(tfluid, **TINY_YOLO)
    rng = np.random.RandomState(0)
    feeds = [ref.feed(dp.TINY_YOLO_BATCH, rng) for _ in range(3)]
    rexe, rscope, texe, tscope = _start(ref.main, port.startup)
    heads = [op.output_names for op in ref.main.global_block().ops
             if op.type == "yolov3_loss"]
    first = [h[s][0] for h in heads for s in ("ObjectnessMask",
                                              "GTMatchMask")] + [
        op.output_names["Out"][0] for op in ref.main.global_block().ops
        if op.type == "conv2d" and op.input_names.get("Bias")]
    first = [n for n in first] + [
        op.input_names["X"][0] for op in ref.main.global_block().ops
        if op.type == "yolov3_loss"]
    # every step fetches `first` beside the loss: one fetch list, one
    # compile of the reference's step
    want = _steps(rexe, ref.main, feeds, [ref.loss] + first, rscope)
    got = _steps(texe, port.main, feeds, [port.loss] + first, tscope)
    return ref, port, (rexe, rscope, texe, tscope), want, got


def test_tiny_yolov3_is_the_reference_program(yolo):
    ref, port = yolo[0], yolo[1]
    parity.assert_same_program(ref.main, port.main)
    parity.assert_same_program(ref.infer, port.infer)
    types = {op.type for op in port.main.global_block().ops}
    assert {"yolov3_loss", "nearest_interp", "leaky_relu"} <= types
    interp = [op for op in port.main.global_block().ops
              if op.type == "nearest_interp"]
    assert len(interp) == 2 and all(op.attrs["align_corners"]
                                    for op in interp)


def test_tiny_yolov3_first_step_matches(yolo):
    """Step 1 from one start state: the loss within rtol
    1e-5, the heads' masks equal, the head outputs within 2e-4 of their
    scale."""
    want, got = yolo[3][0], yolo[4][0]
    np.testing.assert_allclose(got[0], want[0], rtol=dp.TOL["yolo_first"])
    for g, w in zip(got[1:7], want[1:7]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[7:], want[7:]):
        np.testing.assert_allclose(
            g, w, rtol=0, atol=dp.TOL["yolo_heads"] * (1 + np.abs(w).max()))


def test_tiny_yolov3_trains_as_the_reference(yolo):
    """3 steps: finite losses that fall in both packages, within
    YOLO_STEP_RTOL of each other."""
    want = [float(w[0][0]) for w in yolo[3]]
    got = [float(g[0][0]) for g in yolo[4]]
    assert np.isfinite(want + got).all()
    assert got[-1] < got[0] and want[-1] < want[0]
    np.testing.assert_allclose(got, want, rtol=YOLO_STEP_RTOL)


def test_tiny_yolov3_inference_matches(yolo):
    """The port's inference program from its trained state: each
    `yolo_box` against the reference's op on the same head output
    (rtol 1e-5), and `multiclass_nms` against the reference's op on the
    same boxes and scores, exactly."""
    ref, port, (_, _, texe, tscope), _, _ = yolo
    ops = port.infer.global_block().ops
    yb = [op for op in ops if op.type == "yolo_box"]
    nms = next(op for op in ops if op.type == "multiclass_nms")
    fetch = [op.input_names["X"][0] for op in yb] + [
        nms.input_names["BBoxes"][0], nms.input_names["Scores"][0],
        nms.output_names["Out"][0]] + [
        op.output_names[s][0] for op in yb for s in ("Boxes", "Scores")]
    feed = ref.infer_feed(2, np.random.RandomState(1))
    got = texe.run(port.infer, feed=feed, fetch_list=fetch, scope=tscope)
    heads, (boxes, scores, out), decoded = got[:3], got[3:6], got[6:]
    size = jnp.asarray(feed["im_size"])
    want = jax.jit(lambda xs: [rreg.get_op("yolo_box").compute(
        {"X": [x], "ImgSize": [size]}, dict(op.attrs))
        for op, x in zip(yb, xs)])([jnp.asarray(h) for h in heads])
    for i, w in enumerate(want):
        np.testing.assert_allclose(decoded[2 * i], np.asarray(w["Boxes"]),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(decoded[2 * i + 1],
                                   np.asarray(w["Scores"]), rtol=1e-5,
                                   atol=1e-6)
    want = rreg.get_op("multiclass_nms").compute(
        {"BBoxes": [boxes], "Scores": [scores]}, dict(nms.attrs))["Out"]
    np.testing.assert_array_equal(out, np.asarray(want))
    assert out.shape[1] == 6 and 0 < out.shape[0] <= 200


@pytest.fixture(scope="module")
def qat():
    ref = dp.resnet_qat(rfluid, **SMALL_QAT)
    port = dp.resnet_qat(tfluid, **SMALL_QAT)
    rng = np.random.RandomState(2)
    feeds = [ref.feed(dp.SMALL_QAT_BATCH, rng) for _ in range(3)]
    rexe, rscope, texe, tscope = _start(ref.main, port.startup)
    start = {n: np.asarray(rscope.find_var(n)).copy()
             for n in _persistables(ref.main)}
    first = ["image.quantized"]
    want = _steps(rexe, ref.main, feeds, [ref.loss] + first, rscope)
    got = _steps(texe, port.main, feeds, [port.loss] + first, tscope)
    return ref, port, (rexe, rscope, texe, tscope), want, got, start, feeds


def test_small_qat_resnet_is_the_reference_program(qat):
    ref, port = qat[0], qat[1]
    parity.assert_same_program(ref.main, port.main)
    parity.assert_same_program(ref.test, port.test)
    ops = [op for op in port.main.global_block().ops
           if not op.attrs.get("_is_backward")]
    quantized = [op for op in ops if op.type in ("conv2d", "mul")]
    cw = [op for op in ops if op.type == "fake_channel_wise_quantize_abs_max"]
    ma = [op for op in ops
          if op.type == "fake_quantize_moving_average_abs_max"]
    # a weight quantizer for every conv and the fc's mul; one activation
    # quantizer for each tensor they read (a block's shortcut conv and
    # its first conv share theirs)
    acts = {op.input_names["Input" if op.type == "conv2d" else "X"][0]
            for op in quantized}
    assert len(cw) == len(quantized) and len(ma) == len(acts)
    assert all(op.input_names.get("Filter", op.input_names.get("Y"))[0]
               .endswith(".quantized") for op in quantized)
    assert len(dp.quant_state_names(port.main)) == len(acts)
    assert all(op.attrs.get("is_test") for op in port.test.global_block().ops
               if op.type == "fake_quantize_moving_average_abs_max")


def test_small_qat_first_step_quantizers(qat):
    """From the same startup weights, the weights the port's step 1
    quantizes (the first conv's, a middle one's, the fc's) equal the
    reference's quantizer applied op by op, bit for bit; the image's
    quantizer is within 1e-5 of a grid step of the reference's jitted
    one."""
    ref, port, _, want, got, start, feeds = qat
    weights = [op for op in port.main.global_block().ops
               if op.type == "fake_channel_wise_quantize_abs_max"]
    # the first conv, one of the middle and the fc's mul (quant_axis 1)
    for op in (weights[0], weights[len(weights) // 2], weights[-1]):
        w = start[op.input_names["X"][0]]
        attrs = dict(op.attrs)
        t = parity.port(op.type, {"X": [torch.tensor(w)]}, attrs)
        r = rreg.get_op(op.type).compute({"X": [jnp.asarray(w)]}, attrs)
        for slot in ("Out", "OutScale"):
            np.testing.assert_array_equal(t[slot][0].numpy(),
                                          np.asarray(r[slot]),
                                          err_msg=op.input_names["X"][0])
    step = np.abs(feeds[0]["image"]).max() / 127
    np.testing.assert_allclose(got[0][1], want[0][1], rtol=0,
                               atol=1e-5 * step)


def test_small_qat_resnet_trains_as_the_reference(qat):
    ref, port, (rexe, rscope, texe, tscope), want, got, _, _ = qat
    assert np.isfinite([v[0] for v in want + got]).all()
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=QAT_LOSS_RTOL)
    for n in dp.quant_state_names(port.main):
        g = to_numpy(tscope.find_var(n))
        assert g[0] > 0, n
        np.testing.assert_allclose(g, np.asarray(rscope.find_var(n)),
                                   rtol=QAT_SCALE_RTOL, err_msg=n)


def test_small_qat_freeze_save_load(qat, tmp_path):
    """The evaluation clone frozen in both packages from the reference's
    trained state (weights snapped in the scope, activation quantizers
    at their learned scales): logits within FROZEN_RTOL of their scale;
    saved and loaded by the port, equal."""
    from paddle_tpu.fluid.contrib.slim import quantization as rq

    ref, port, (rexe, rscope, texe, _), _, _, _, feeds = qat
    tscope = tfluid.Scope()
    load_numpy_state(tscope, {n: np.asarray(rscope.find_var(n))
                              for n in _persistables(ref.main)}, "cpu")
    feed = {"image": feeds[0]["image"], "label": feeds[0]["label"]}
    rq.QuantizationFreezePass(
        scope=rscope, weight_quantize_type="channel_wise_abs_max"
    ).apply(ref.test, scope=rscope)
    tq.QuantizationFreezePass(
        scope=tscope, weight_quantize_type="channel_wise_abs_max"
    ).apply(port.test, scope=tscope)
    parity.assert_same_program(ref.test, port.test)
    want = np.asarray(rexe.run(ref.test, feed=feed, fetch_list=ref.fetch,
                               scope=rscope)[0])
    got = texe.run(port.test, feed=feed, fetch_list=port.fetch,
                   scope=tscope)[0]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FROZEN_RTOL * np.abs(want).max())
    d = str(tmp_path / "qat")
    with tfluid.scope_guard(tscope):
        tfluid.io.save_inference_model(d, ["image"], port.fetch, texe,
                                       main_program=port.test)
        prog2, _, fetch = tfluid.io.load_inference_model(d, texe)
    again = texe.run(prog2, feed={"image": feed["image"]}, fetch_list=fetch,
                     scope=tscope)[0]
    np.testing.assert_array_equal(again, got)
    assert any(o.attrs.get("quantization_type") == "qat_with_weight_quantize"
               for o in prog2.global_block().ops)


def test_range_mlp_state_matches_the_reference():
    ref, port = dp.range_mlp(rfluid), dp.range_mlp(tfluid)
    parity.assert_same_program(ref.main, port.main)
    rexe, rscope, texe, tscope = _start(ref.main, port.startup)
    rng = np.random.RandomState(0)
    feeds = [ref.feed(8, rng) for _ in range(7)]
    want = _steps(rexe, ref.main, feeds, [ref.loss] + ref.fetch, rscope)
    got = _steps(texe, port.main, feeds, [port.loss] + port.fetch, tscope)
    for g, w in zip(got, want):
        for gv, wv in zip(g[:3], w[:3]):
            np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(g[3], w[3])
    assert int(got[-1][3][0]) == 7


# -- the reference's tests/test_quantization.py flows, in the port ----------

def _mlp(L):
    x = L.data(name="x", shape=[16], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    h = L.fc(input=x, size=32, act="relu")
    logits = L.fc(input=h, size=4)
    return logits, L.mean(L.softmax_with_cross_entropy(logits, label))


def _mlp_data():
    r = np.random.RandomState(8)
    return (r.rand(32, 16).astype("float32"),
            r.randint(0, 4, (32, 1)).astype("int64"))


def _program(seed=4):
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = seed
    return main, startup


def test_qat_mlp_trains():
    main, startup = _program()
    with tfluid.program_guard(main, startup), tfluid.unique_name_guard():
        _, loss = _mlp(tfluid.layers)
        tq.QuantizationTransformPass().apply(main, startup)
        tfluid.optimizer.SGDOptimizer(0.5).minimize(loss)
    qops = [op.type for op in main.global_block().ops
            if op.type.startswith("fake_quantize")]
    assert len(qops) >= 4, qops
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    x, y = _mlp_data()
    losses = [float(exe.run(main, feed={"x": x, "label": y},
                            fetch_list=[loss], scope=scope)[0].reshape(-1)[0])
              for _ in range(15)]
    assert losses[-1] < losses[0], losses


def test_ptq_calibrates_and_binds_static_scales():
    main, startup = _program()
    with tfluid.program_guard(main, startup), tfluid.unique_name_guard():
        _, loss = _mlp(tfluid.layers)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    x, y = _mlp_data()
    ptq = tq.PostTrainingQuantization(
        exe, main, feed_list=["x", "label"], fetch_list=[loss],
        sample_generator=lambda: iter([{"x": x, "label": y}] * 3),
        batch_nums=3, scope=scope)
    qprog = ptq.quantize()
    assert abs(ptq.scales["x"] - float(np.abs(x).max())) < 1e-5
    bound = [op.attrs.get("static_scale") for op in
             qprog.global_block().ops if op.type == "fake_quantize_abs_max"
             and op.input_names["X"][0] in ptq.scales]
    assert bound and all(b is not None for b in bound)
    out = exe.run(qprog, feed={"x": x * 0.5, "label": y},
                  fetch_list=[loss], scope=scope)
    assert np.isfinite(out[0]).all()


def test_qat_freeze_export_roundtrip(tmp_path):
    """Per-channel QAT, output-scale tracking, freeze (int8-grid weights
    in the scope's own tensors, out_threshold attrs), save and load."""
    main, startup = _program(11)
    L = tfluid.layers
    with tfluid.program_guard(main, startup), tfluid.unique_name_guard():
        img = L.data(name="img", shape=[1, 8, 8], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        conv = L.conv2d(img, num_filters=4, filter_size=3, padding=1,
                        act="relu")
        pool = L.pool2d(conv, pool_size=2, pool_stride=2, pool_type="max")
        logits = L.fc(input=pool, size=4)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        tq.QuantizationTransformPass(
            weight_quantize_type="channel_wise_abs_max").apply(main, startup)
        tq.OutScaleForTrainingPass().apply(main, startup)
        test_prog = main.clone(for_test=True)
        tfluid.optimizer.AdamOptimizer(0.01).minimize(loss)
    r = np.random.RandomState(3)
    x = r.rand(64, 1, 8, 8).astype("float32")
    y = (x.mean(axis=(1, 2, 3)) * 4).astype("int64").clip(0, 3).reshape(
        64, 1)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup, scope=scope)
        for _ in range(30):
            exe.run(main, feed={"img": x, "label": y}, fetch_list=[loss],
                    scope=scope)
        fp32 = exe.run(test_prog, feed={"img": x, "label": y},
                       fetch_list=[logits], scope=scope)[0]
        conv_op = next(o for o in test_prog.global_block().ops
                       if o.type == "conv2d")
        wname = next(o for o in test_prog.global_block().ops
                     if o.type == "fake_channel_wise_quantize_abs_max"
                     ).input_names["X"][0]
        held = scope.find_var(wname)
        tq.QuantizationFreezePass(
            scope=scope, weight_quantize_type="channel_wise_abs_max"
        ).apply(test_prog, scope=scope)
        tq.OutScaleForInferencePass().apply(test_prog, scope=scope)
        ops = test_prog.global_block().ops
        assert not any(o.type == "fake_channel_wise_quantize_abs_max"
                       for o in ops)
        assert conv_op.attrs["quantization_type"] == \
            "qat_with_weight_quantize"
        assert len(conv_op.attrs["weight_quant_scale"]) == 4
        assert any(o.type == "pool2d" and "out_threshold" in o.attrs
                   for o in ops)
        # snapped in the tensor the scope already held
        assert scope.find_var(wname) is held
        w = to_numpy(held)
        s = np.asarray(conv_op.attrs["weight_quant_scale"]).reshape(
            4, 1, 1, 1)
        steps = w * 127.0 / np.maximum(s, 1e-8)
        np.testing.assert_allclose(steps, np.round(steps), atol=1e-4)
        q = exe.run(test_prog, feed={"img": x, "label": y},
                    fetch_list=[logits], scope=scope)[0]
        assert (q.argmax(1) == y.reshape(-1)).mean() >= \
            (fp32.argmax(1) == y.reshape(-1)).mean() - 0.05
        d = str(tmp_path / "qmodel")
        tfluid.io.save_inference_model(d, ["img"], [logits], exe,
                                       main_program=test_prog)
        prog2, _, fetch = tfluid.io.load_inference_model(d, exe)
        out2 = exe.run(prog2, feed={"img": x}, fetch_list=fetch,
                       scope=scope)[0]
    np.testing.assert_allclose(out2, q, atol=1e-5, rtol=1e-5)
    assert any("out_threshold" in o.attrs for o in prog2.global_block().ops)


def test_for_test_clone_freezes_the_scales():
    """`clone(for_test=True)` sets `is_test` on the four stateful
    quantizer types, so evaluation batches leave every scale where
    training put it; the training program moves them."""
    main, startup = _program(5)
    with tfluid.program_guard(main, startup), tfluid.unique_name_guard():
        _, loss = _mlp(tfluid.layers)
        tq.QuantizationTransformPass().apply(main, startup)
        tq.OutScaleForTrainingPass().apply(main, startup)
        tfluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    test = main.clone(for_test=True)
    stateful = [op for op in test.global_block().ops if op.type in (
        "fake_quantize_moving_average_abs_max",
        "moving_average_abs_max_scale")]
    assert stateful and all(op.attrs.get("is_test") for op in stateful)
    states = sorted(n for n in _persistables(main)
                    if n.endswith((".quant_state", ".out_scale")))
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    x, y = _mlp_data()
    exe.run(main, feed={"x": x, "label": y}, fetch_list=[loss], scope=scope)
    before = {n: to_numpy(scope.find_var(n)).copy() for n in states}
    exe.run(test, feed={"x": x * 9.0, "label": y}, fetch_list=[loss],
            scope=scope)
    for n in states:
        np.testing.assert_array_equal(to_numpy(scope.find_var(n)),
                                      before[n], err_msg=n)
    exe.run(main, feed={"x": x * 9.0, "label": y}, fetch_list=[loss],
            scope=scope)
    assert any((to_numpy(scope.find_var(n)) != before[n]).any()
               for n in states)
