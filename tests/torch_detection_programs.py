"""The detection and quantization slice's programs, built once for both
packages: each builder takes the `fluid` module (the JAX package's or the
port's) and builds the same program in fresh programs, as
`tests/torch_book_programs.py` does. Plain numpy and no JAX, so
`chip_smoke.py` imports it too.

- `yolov3_darknet53(fluid, ...)`: YOLOv3 with a DarkNet-53 backbone as
  PaddleDetection trains it (`configs/yolov3_darknet.yml`;
  `ppdet/modeling/backbones/darknet.py`, `anchor_heads/yolo_head.py`).
  Every ConvBN is a conv without bias, `batch_norm`, then `leaky_relu`
  0.1. The backbone: a 3 x 3 conv of 32 channels, then five stages,
  each a 3 x 3 stride-2 conv to 64 ... 1024 channels and [1, 2, 8, 8, 4]
  residual blocks (1 x 1 to c/2, 3 x 3 to c, add); the last three
  stages feed the head. The head, from the deepest: a detection block
  (1 x 1 c, 3 x 3 2c, 1 x 1 c, 3 x 3 2c, 1 x 1 c the route), a 3 x 3 2c
  tip and a 1 x 1 conv with bias to 3 x (5 + classes); for the first two
  the route goes through a 1 x 1 conv to c/2, `interpolate(scale=2,
  resample="NEAREST")` (`nearest_interp` with `align_corners`, what
  Paddle's `resize_nearest` emits) and a concat with the next backbone
  output (c = 512, 256, 128). The loss: `yolov3_loss` on each head with
  its anchor mask and ratio, 80 classes, `ignore_thresh` 0.7, label
  smoothing, each `reduce_mean`ed over the batch, the three summed;
  Momentum 0.9 at lr 0.001 with L2Decay(0.0005), float32. Its inference
  program, over the same parameter names: `yolo_box` on each head
  (`conf_thresh` 0.01), the boxes and scores concatenated, the scores
  transposed to [N, classes, M], `multiclass_nms` (score 0.01,
  `nms_top_k` 1000, `keep_top_k` 100, IoU 0.45, no background, pixel
  extents). `depths`, `width_div`, `img`, `classes` and `boxes` cut it
  to a test's size.
- `resnet_qat(fluid, ...)`: `models/resnet.py`'s `resnet()` with
  `softmax_with_cross_entropy` and `mean`, rewritten by
  `QuantizationTransformPass` with PaddleSlim `quant_aware`'s default
  config (channel-wise abs-max weights, moving-average abs-max
  activations, 8 bits each, moving rate 0.9, over conv2d,
  depthwise_conv2d and mul), then Momentum 0.9 at lr 0.1 with
  L2Decay(1e-4), as `build_resnet_train` sets it. Its `test` program is
  the evaluation clone taken before `minimize`, the quantizers frozen
  (`is_test`), as PaddleSlim's flow takes it.
- `range_mlp(fluid, ...)`: an MLP whose hidden activation goes through
  `fake_quantize_range_abs_max` with its state persistable (the scale,
  the window buffer and `Iter`, which `increment` advances each step),
  so a captured step carries all three.
"""
import collections
import importlib

import numpy as np

YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]
YOLO_MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]
YOLO_RATIOS = [32, 16, 8]
#: DarkNet-53's residual blocks a stage
DARKNET53 = [1, 2, 8, 8, 4]
#: YOLOv3 at PaddleDetection's widths: COCO's 80 classes, 608 x 608, 50
#: ground-truth rows an image
YOLO_FULL = dict(depths=DARKNET53, width_div=1, img=608, classes=80,
                 boxes=50)

#: the tiny YOLOv3 of the tests (DarkNet-53's layout cut in depth, width
#: and image size) and its batch
TINY_YOLO = dict(depths=[1, 1, 1, 1, 1], width_div=8, img=64, classes=4,
                 boxes=6)
TINY_YOLO_BATCH = 2
#: the small QAT ResNet of the tests and its batch
SMALL_QAT = dict(depth=18, img=32, classes=10)
SMALL_QAT_BATCH = 4
#: how far two runs of these programs may part, and why (the tests'
#: docstrings, tests/test_torch_detection_models.py): the tiny YOLOv3's
#: first loss, its head outputs (of their scale) and its losses over 3
#: steps; the small QAT ResNet's first loss and its scales after 3 steps;
#: its frozen evaluation program's logits (of their scale)
TOL = dict(yolo_first=1e-5, yolo_heads=2e-4, yolo_steps=5e-2,
           qat_loss=2e-2, qat_scales=0.1, frozen=2e-3)

Detection = collections.namedtuple(
    "Detection", "main startup loss fetch feed infer infer_startup "
    "infer_fetch infer_feed")
QAT = collections.namedtuple("QAT", "main startup loss fetch feed test")
Program = collections.namedtuple("Program", "main startup loss fetch feed")


def _programs(fluid, seed):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    return main, startup


def _conv_bn(L, x, ch, size, stride=1):
    conv = L.conv2d(input=x, num_filters=ch, filter_size=size,
                    stride=stride, padding=(size - 1) // 2, act=None,
                    bias_attr=False)
    return L.leaky_relu(L.batch_norm(input=conv), alpha=0.1)


def _darknet(L, x, depths, div):
    x = _conv_bn(L, x, 32 // div, 3)
    outs = []
    for i, n in enumerate(depths):
        ch = 64 * 2 ** i // div
        x = _conv_bn(L, x, ch, 3, stride=2)
        for _ in range(n):
            y = _conv_bn(L, x, ch // 2, 1)
            x = L.elementwise_add(x, _conv_bn(L, y, ch, 3))
        outs.append(x)
    return outs[-3:]


def _yolo_head(L, blocks, classes, div):
    outs = []
    x = blocks[-1]
    for i in range(3):
        c = 512 // 2 ** i // div
        for _ in range(2):
            x = _conv_bn(L, _conv_bn(L, x, c, 1), 2 * c, 3)
        route = _conv_bn(L, x, c, 1)
        tip = _conv_bn(L, route, 2 * c, 3)
        outs.append(L.conv2d(input=tip, num_filters=3 * (5 + classes),
                             filter_size=1, act=None))
        if i < 2:
            up = L.interpolate(_conv_bn(L, route, c // 2, 1), scale=2.0,
                               resample="NEAREST")
            x = L.concat([up, blocks[-2 - i]], axis=1)
    return outs


def _yolo_net(fluid, img, classes, depths, div):
    L = fluid.layers
    image = L.data(name="image", shape=[3, img, img], dtype="float32")
    return image, _yolo_head(L, _darknet(L, image, depths, div), classes,
                             div)


def yolo_feed(batch, img, classes, boxes, rng):
    """Images in [0, 1), and ground truths: 8 to `boxes` valid rows an
    image (cx, cy, w, h over the image), the rest zero; every fourth
    valid row a jittered copy of the one before, so cells are shared."""
    gt = np.zeros((batch, boxes, 4), "float32")
    label = np.zeros((batch, boxes), "int32")
    score = np.zeros((batch, boxes), "float32")
    for b in range(batch):
        k = rng.randint(min(8, boxes), boxes + 1)
        wh = rng.uniform(0.02, 0.5, (k, 2))
        c = rng.uniform(0.0, 1.0, (k, 2)) * (1 - wh) + wh / 2
        for j in range(3, k, 4):
            c[j] = c[j - 1] + rng.uniform(-0.002, 0.002, 2)
            wh[j] = wh[j - 1] * rng.uniform(0.97, 1.03, 2)
        gt[b, :k] = np.concatenate([c, wh], 1)
        label[b, :k] = rng.randint(0, classes, k)
        score[b, :k] = rng.uniform(0.5, 1.0, k)
    return {"image": rng.uniform(0, 1, (batch, 3, img, img)).astype(
        "float32"), "gt_box": gt, "gt_label": label, "gt_score": score}


def yolov3_darknet53(fluid, depths=DARKNET53, width_div=1, img=608,
                     classes=80, boxes=50, lr=0.001, seed=11):
    """YOLOv3 DarkNet-53 training and inference (module docstring)."""
    main, startup = _programs(fluid, seed)
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        _, outs = _yolo_net(fluid, img, classes, depths, width_div)
        gt_box = L.data(name="gt_box", shape=[boxes, 4], dtype="float32")
        gt_label = L.data(name="gt_label", shape=[boxes], dtype="int32")
        gt_score = L.data(name="gt_score", shape=[boxes], dtype="float32")
        loss = None
        for out, mask, ratio in zip(outs, YOLO_MASKS, YOLO_RATIOS):
            head = L.reduce_mean(L.yolov3_loss(
                out, gt_box, gt_label, YOLO_ANCHORS, mask, classes, 0.7,
                ratio, gt_score=gt_score, use_label_smooth=True))
            loss = head if loss is None else L.elementwise_add(loss, head)
        fluid.optimizer.MomentumOptimizer(
            learning_rate=lr, momentum=0.9,
            regularization=fluid.regularizer.L2Decay(0.0005)).minimize(loss)

    infer, infer_startup = _programs(fluid, seed)
    with fluid.program_guard(infer, infer_startup), \
            fluid.unique_name_guard():
        _, outs = _yolo_net(fluid, img, classes, depths, width_div)
        im_size = L.data(name="im_size", shape=[2], dtype="int32")
        all_boxes, all_scores = [], []
        for out, mask, ratio in zip(outs, YOLO_MASKS, YOLO_RATIOS):
            anchors = [v for m in mask for v in YOLO_ANCHORS[2 * m:2 * m + 2]]
            b, s = L.yolo_box(out, im_size, anchors, classes, 0.01, ratio)
            all_boxes.append(b)
            all_scores.append(s)
        scores = L.transpose(L.concat(all_scores, axis=1), perm=[0, 2, 1])
        nms = L.multiclass_nms(L.concat(all_boxes, axis=1), scores,
                               score_threshold=0.01, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.45,
                               background_label=-1, normalized=False)
    infer_fetch = [all_boxes[0], all_scores[0], nms]
    for op in infer.global_block().ops:
        if op.type == "batch_norm":
            op.attrs["is_test"] = True

    def feed(batch, rng):
        return yolo_feed(batch, img, classes, boxes, rng)

    def infer_feed(batch, rng):
        return {"image": rng.uniform(0, 1, (batch, 3, img, img)).astype(
            "float32"), "im_size": np.full((batch, 2), img, "int32")}

    return Detection(main, startup, loss, [], feed, infer, infer_startup,
                     infer_fetch, infer_feed)


#: PaddleSlim `quant_aware`'s default config
QAT_CONFIG = dict(weight_quantize_type="channel_wise_abs_max",
                  activation_quantize_type="moving_average_abs_max",
                  weight_bits=8, activation_bits=8, moving_rate=0.9,
                  quantizable_op_type=["conv2d", "depthwise_conv2d", "mul"])


def _package(fluid, sub):
    return importlib.import_module(
        fluid.__name__.rsplit(".", 1)[0] + "." + sub)


def resnet_qat(fluid, depth=50, img=224, classes=1000, lr=0.1, seed=13,
               quant=True):
    """ResNet under slim's QAT pass (module docstring); with `quant`
    False the same network and optimizer without the pass, to measure
    what the fake-quant ops cost."""
    resnet = _package(fluid, "models.resnet")
    slim = _package(fluid, "fluid.contrib.slim.quantization")
    main, startup = _programs(fluid, seed)
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        image = L.data(name="image", shape=[3, img, img], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        logits = resnet.resnet(image, class_dim=classes, depth=depth)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        if quant:
            slim.QuantizationTransformPass(**QAT_CONFIG).apply(main, startup)
        test = main.clone(for_test=True)
        fluid.optimizer.MomentumOptimizer(
            learning_rate=lr, momentum=0.9,
            regularization=fluid.regularizer.L2Decay(1e-4)).minimize(loss)

    def feed(batch, rng):
        return {"image": rng.randn(batch, 3, img, img).astype("float32"),
                "label": rng.randint(0, classes, (batch, 1)).astype(
                    "int64")}

    return QAT(main, startup, loss, [logits], feed, test)


def quant_state_names(program):
    """The persistable scale states of a QAT program (the moving-average
    quantizers' `.quant_state` vars), sorted."""
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and v.name.endswith(".quant_state"))


def _state(fluid, main, startup, name, shape, dtype, value=0.0):
    """A persistable var of `main` filled with `value` by `startup`."""
    var = main.global_block().create_var(name=name, shape=shape,
                                         dtype=dtype, persistable=True)
    var.stop_gradient = True
    startup.global_block().create_var(name=name, shape=shape, dtype=dtype,
                                      persistable=True)
    startup.global_block().append_op(
        type="fill_constant", inputs={}, outputs={"Out": [name]},
        attrs={"shape": list(shape), "dtype": dtype, "value": value})
    return var


def range_mlp(fluid, window=4, hidden=32, lr=0.1, seed=17):
    """The window-max quantizer's MLP (module docstring)."""
    main, startup = _programs(fluid, seed)
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        x = L.data(name="x", shape=[16], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        h = L.fc(input=x, size=hidden, act="relu")
        scale = _state(fluid, main, startup, "h.scale", [1], "float32")
        scales = _state(fluid, main, startup, "h.window", [window],
                        "float32")
        it = _state(fluid, main, startup, "h.iter", [1], "int64")
        q = main.global_block().create_var(name="h.quantized",
                                           shape=h.shape, dtype="float32")
        main.global_block().append_op(
            type="fake_quantize_range_abs_max",
            inputs={"X": [h], "InScale": [scale], "Iter": [it],
                    "InScales": [scales]},
            outputs={"Out": [q], "OutScale": [scale],
                     "OutScales": [scales]},
            attrs={"window_size": window, "bit_length": 8})
        L.increment(it, value=1, in_place=True)
        logits = L.fc(input=q, size=4)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)

    def feed(batch, rng):
        return {"x": (rng.randn(batch, 16) * rng.uniform(0.5, 2.0)).astype(
            "float32"), "label": rng.randint(0, 4, (batch, 1)).astype(
                "int64")}

    return Program(main, startup, loss, [scale, scales, it], feed)
