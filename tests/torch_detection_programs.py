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


# -- Mask R-CNN R50-FPN and SSD MobileNet-v1 ----------------------------------

#: ResNet50's bottleneck blocks a stage
RESNET50 = [3, 4, 6, 3]
#: Mask R-CNN R50-FPN at PaddleDetection's widths
#: (configs/mask_rcnn_r50_fpn_1x.yml): COCO's 81 classes (background
#: included), one 800 x 1333 image a step padded to 800 x 1344, FPN of
#: 256 over C2-C5 and a P6 pool, anchors 32-512 at ratios 0.5, 1, 2,
#: 256 anchors and 512 RoIs an image, 2000 proposals in training and
#: 1000 in test, a 2 x 1024 box head, a 4 x 256 mask head at 28, up to
#: 50 ground truths an image
MASK_RCNN_FULL = dict(depths=RESNET50, width_div=1, img=(800, 1344),
                      classes=81, boxes=50, fpn=256, head=1024,
                      mask_convs=4, resolution=28, rpn_batch=256,
                      pre_train=2000, post_train=2000, pre_test=1000,
                      post_test=1000, roi_batch=512)
#: the tiny Mask R-CNN of the tests: one block a stage, widths / 16,
#: 64 x 96 pixels, 5 classes, the samplers' sizes scaled down
TINY_MASK_RCNN = dict(depths=[1, 1, 1, 1], width_div=16, img=(64, 96),
                      classes=5, boxes=4, fpn=16, head=32, mask_convs=1,
                      resolution=8, rpn_batch=32, pre_train=64,
                      post_train=48, pre_test=48, post_test=32,
                      roi_batch=24)
#: SSD MobileNet-v1 at PaddleDetection's widths
#: (configs/ssd/ssd_mobilenet_v1_voc.yml): 300 x 300, VOC's 21 classes,
#: the extra blocks and MultiBoxHead's sizes there (1,917 priors)
SSD_FULL = dict(img=300, classes=21, width_div=1, boxes=50,
                extras=[[256, 512], [128, 256], [128, 256], [64, 128]],
                min_sizes=[60.0, 105.0, 150.0, 195.0, 240.0, 285.0],
                max_sizes=[[], 150.0, 195.0, 240.0, 285.0, 300.0])
#: the tiny SSD of the tests: widths / 8, 96 x 96 (maps of 6 to 1)
TINY_SSD = dict(img=96, classes=5, width_div=8, boxes=4,
                extras=[[32, 64], [16, 32], [16, 32], [8, 16]],
                min_sizes=[19.2, 33.6, 48.0, 62.4, 76.8, 91.2],
                max_sizes=[[], 48.0, 62.4, 76.8, 91.2, 96.0])
#: the tiny programs' first step, the port against the reference and the
#: card against the CPU: the losses, and each fetched gradient within
#: this of its largest |value| (SSD's heads: 9e-5 against the reference,
#: 2.8e-4 on the card, through batch norm over one image's 1 x 1 to
#: 3 x 3 maps)
DET_TOL = dict(mask_loss=1e-4, mask_grads=1e-3, ssd_loss=1e-5,
               ssd_grads=5e-4)

#: the gradients the tiny programs' first step is held by, and SSD's
#: first convolution with its own tolerance (its docstring,
#: tests/test_torch_det_extra_models.py)
DET_GRADS = {"mask_rcnn": ["fpn_0_w", "fpn_inner_3_w", "conv_rpn_w",
                           "rpn_cls_logits_w", "rpn_bbox_pred_w", "fc6_w",
                           "cls_score_w", "bbox_pred_w", "mask_fcn0_w",
                           "mask_fcn_w", "res5a_branch2c_weights"],
             "ssd": ["conf_0_w", "loc_2_w", "conf_5_b", "conv7_8_weights"]}
SSD_DEEP = ("conv1_weights", 5e-2)
#: the reference's outputs of the tiny programs' input-exact host ops at
#: their first step (feed from RandomState(0); inputs that no parameter
#: moves: the anchors and ground truth, the priors' IoUs), `digest`s of
#: the outputs narrowed as a var holds them; the card must give them.
#: Of `bipartite_match` only the indices: the priors divide by the image
#: size, which the card computes as a product by its reciprocal, so the
#: matched IoUs may differ from the CPU's in the last bit
_RPN_DIGESTS = dict(zip(
    ("BBoxInsideWeight", "LocationIndex", "ScoreIndex", "TargetBBox",
     "TargetLabel"),
    ["0f68f9fb3ee46c99fc606faedafbfc5983dd10cc7a3db9ea9613187cdd3b9c7c",
     "04b77d0e90a8801a5f42bbc972fc9301bb72894ddad19cb2359ca3326929593e",
     "70fb0c1b26aa152fc3a9bc6a3fd6f2982254cfbb51df23233cdfa9132c7d9b93",
     "3e6c10e2835184adc402eddeddbe97160c9e53ef900894d9cff8aa83e675c2dd",
     "8aefff30c1b38c7df815921ae1789abce7378d320d9711ffb9853648f29042d5"]))
HOST_OUTPUT_DIGESTS = {
    ("mask_rcnn", "rpn_target_assign"): {
        s: [d] for s, d in _RPN_DIGESTS.items()},
    ("ssd", "bipartite_match"): {"ColToRowMatchIndices": [
        "03c14aaa888c182f209297b66fb8a3e1780e5b9ac191a8cc0efe9c7c4ae1e3dc"]},
}

TwoStage = collections.namedtuple(
    "TwoStage", "main startup loss fetch feed test test_fetch test_feed "
    "host_ops")


def _param(fluid, name, trainable=True):
    return fluid.ParamAttr(name=name, trainable=trainable)


def _affine(fluid, ch, name, scale):
    """PaddleDetection's frozen affine_channel norm: a scale and an
    offset a channel, not trained."""
    L = fluid.layers
    init = fluid.initializer.Constant
    return (L.create_parameter([ch], "float32", attr=_param(
        fluid, name + "_scale", False), default_initializer=init(scale)),
        L.create_parameter([ch], "float32", attr=_param(
            fluid, name + "_offset", False), default_initializer=init(0.0)))


def _conv_affine(fluid, x, ch, k, stride, act, name, trainable=True,
                 scale=1.0):
    L = fluid.layers
    conv = L.conv2d(x, ch, k, stride=stride, padding=(k - 1) // 2,
                    bias_attr=False, param_attr=_param(
                        fluid, name + "_weights", trainable))
    return L.affine_channel(conv, *_affine(fluid, ch, "bn" + name[3:],
                                           scale), act=act)


#: the frozen affine scale of each residual branch's last convolution:
#: PaddleDetection loads every affine_channel from an ImageNet model;
#: from random weights at scale 1 the 16 blocks grow the activations to
#: about 1e3 and the first step diverges
BRANCH_SCALE = 0.2


def _resnet_c2_c5(fluid, image, depths, div):
    """ResNet (variant b, affine_channel norm) outputs C2-C5; the stem
    and res2 frozen (freeze_at 2: their weights are not trained)."""
    L = fluid.layers
    x = _conv_affine(fluid, image, 64 // div, 7, 2, "relu", "res_conv1",
                     trainable=False)
    x = L.pool2d(x, 3, "max", 2, pool_padding=1)
    outs = []
    for s, n in enumerate(depths):
        ch = 64 * 2 ** s // div
        train = s > 0
        for b in range(n):
            name = "res%d%s" % (s + 2, chr(ord("a") + b))
            stride = 2 if (b == 0 and s > 0) else 1
            y = _conv_affine(fluid, x, ch, 1, 1, "relu",
                             name + "_branch2a", train)
            y = _conv_affine(fluid, y, ch, 3, stride, "relu",
                             name + "_branch2b", train)
            y = _conv_affine(fluid, y, ch * 4, 1, 1, None,
                             name + "_branch2c", train, BRANCH_SCALE)
            short = _conv_affine(fluid, x, ch * 4, 1, stride, None,
                                 name + "_branch1", train) if b == 0 else x
            x = L.relu(L.elementwise_add(short, y))
        outs.append(x)
    return outs


def _fpn(fluid, feats, ch):
    """P2-P6: 1 x 1 laterals, the top-down sum through `resize_nearest`
    at scale 2, a 3 x 3 conv on each, P6 a stride-2 max pool of P5."""
    L = fluid.layers
    lat = [L.conv2d(f, ch, 1, param_attr=_param(fluid, "fpn_inner_%d_w" % i),
                    bias_attr=_param(fluid, "fpn_inner_%d_b" % i))
           for i, f in enumerate(feats)]
    top = lat[-1]
    merged = [top]
    for i in range(len(lat) - 2, -1, -1):
        top = L.elementwise_add(lat[i], L.resize_nearest(top, scale=2.))
        merged.insert(0, top)
    outs = [L.conv2d(m, ch, 3, padding=1,
                     param_attr=_param(fluid, "fpn_%d_w" % i),
                     bias_attr=_param(fluid, "fpn_%d_b" % i))
            for i, m in enumerate(merged)]
    return outs + [L.pool2d(outs[-1], 1, "max", 2)]


def _rpn(fluid, levels, ch):
    """The RPN head shared by the levels: (class logits [N, A, H, W],
    deltas [N, 4A, H, W]) a level."""
    L = fluid.layers
    out = []
    for lv in levels:
        h = L.conv2d(lv, ch, 3, padding=1, act="relu",
                     param_attr=_param(fluid, "conv_rpn_w"),
                     bias_attr=_param(fluid, "conv_rpn_b"))
        out.append((L.conv2d(h, 3, 1, param_attr=_param(
            fluid, "rpn_cls_logits_w"), bias_attr=_param(
                fluid, "rpn_cls_logits_b")),
            L.conv2d(h, 12, 1, param_attr=_param(fluid, "rpn_bbox_pred_w"),
                     bias_attr=_param(fluid, "rpn_bbox_pred_b"))))
    return out


def _flat(L, x, k):
    """[N, k*A, H, W] -> [N*H*W*A, k], the anchors' order."""
    return L.reshape(L.transpose(x, [0, 2, 3, 1]), [-1, k])


def _roi_feats(fluid, levels, rois, res):
    """FPN RoI align: the RoIs routed to P2-P5, `res` x `res` a RoI
    (sampling 2), put back in order."""
    L = fluid.layers
    multi, restore = L.distribute_fpn_proposals(rois, 2, 5, 4, 224)
    feats = [L.roi_align(lv, r, res, res, 1.0 / 2 ** (i + 2), 2)
             for i, (lv, r) in enumerate(zip(levels[:4], multi))]
    ch = levels[0].shape[1]
    return L.reshape(L.gather(L.concat(feats, axis=0), restore),
                     [-1, ch, res, res])


def _proposals(fluid, rpn, anchors, im_info, pre, post):
    L = fluid.layers
    rois, probs = [], []
    for (cls, box), (anc, var) in zip(rpn, anchors):
        r, p = L.generate_proposals(L.sigmoid(cls), box, im_info, anc, var,
                                    pre_nms_top_n=pre, post_nms_top_n=post,
                                    nms_thresh=0.7, min_size=0.0)
        rois.append(r)
        probs.append(p)
    return L.collect_fpn_proposals(rois, probs, 2, 6, post)


def _box_head(fluid, feats, classes, hidden):
    L = fluid.layers
    h = L.fc(feats, hidden, act="relu",
             param_attr=_param(fluid, "fc6_w"), bias_attr=_param(
                 fluid, "fc6_b"))
    h = L.fc(h, hidden, act="relu", param_attr=_param(fluid, "fc7_w"),
             bias_attr=_param(fluid, "fc7_b"))
    return (L.fc(h, classes, param_attr=_param(fluid, "cls_score_w"),
                 bias_attr=_param(fluid, "cls_score_b")),
            L.fc(h, 4 * classes, param_attr=_param(fluid, "bbox_pred_w"),
                 bias_attr=_param(fluid, "bbox_pred_b")))


def _mask_rcnn_net(fluid, img, depths, div, fpn):
    L = fluid.layers
    image = L.data(name="image", shape=[3, img[0], img[1]],
                   dtype="float32")
    im_info = L.data(name="im_info", shape=[3], dtype="float32")
    levels = _fpn(fluid, _resnet_c2_c5(fluid, image, depths, div), fpn)
    rpn = _rpn(fluid, levels, fpn)
    anchors = [L.anchor_generator(lv, [32.0 * 2 ** i], [0.5, 1.0, 2.0],
                                  [1.0, 1.0, 1.0, 1.0],
                                  [4.0 * 2 ** i, 4.0 * 2 ** i])
               for i, lv in enumerate(levels)]
    return im_info, levels, rpn, anchors


def mask_rcnn_fpn(fluid, depths=RESNET50, width_div=1, img=(800, 1344),
                  classes=81, boxes=50, fpn=256, head=1024, mask_convs=4,
                  resolution=28, rpn_batch=256, pre_train=2000,
                  post_train=2000, pre_test=1000, post_test=1000,
                  roi_batch=512, lr=0.00125, seed=19):
    """Mask R-CNN R50-FPN training and evaluation, one image a step
    (module docstring of this section: `MASK_RCNN_FULL`).

    Training: the RPN's targets from `rpn_target_assign` over every
    level's anchors (its TargetBBox is the matched ground truth itself,
    as the reference's op gives it, so the smooth-L1 regresses the
    gathered deltas on it in units of the image's longer side; so do
    the box head's targets), `generate_proposals` a level, then
    `collect_fpn_proposals`; `generate_proposal_labels` samples the RoIs,
    `distribute_fpn_proposals` and `roi_align` 7 x 7 pool them for the
    box head (softmax cross-entropy and smooth-L1), and
    `generate_mask_labels` gives the mask head's targets on its RoIs
    (`roi_align` 14 x 14, the convs, a 2 x transposed conv, sigmoid
    cross-entropy with -1 ignored). Momentum 0.9, L2Decay(1e-4), lr
    0.00125: the config's 0.02 for 16 images a step (8 cards x 2),
    scaled to one image (at 0.02 the random start diverges within 4
    steps).
    Evaluation, over the same parameter names: the test proposals, the
    box head's softmax, `box_decoder_and_assign` (the ported
    `multiclass_nms` takes one box a candidate, so each RoI keeps its
    best class's decoded box), `multiclass_nms` (score 0.05, IoU 0.5,
    100 kept) and `detection_map` against the image's ground truth in
    [0, 1] (the detections divided by `norm`)."""
    L = fluid.layers
    main, startup = _programs(fluid, seed)
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        im_info, levels, rpn, anchors = _mask_rcnn_net(
            fluid, img, depths, width_div, fpn)
        gt_box = L.data(name="gt_box", shape=[-1, 4], dtype="float32",
                        append_batch_size=False)
        gt_class = L.data(name="gt_class", shape=[-1, 1], dtype="int32",
                          append_batch_size=False)
        is_crowd = L.data(name="is_crowd", shape=[-1, 1], dtype="int32",
                          append_batch_size=False)
        segms = L.data(name="gt_segms", shape=[-1, 2], dtype="float32",
                       append_batch_size=False)
        poly_lod = L.data(name="poly_lod", shape=[-1], dtype="int32",
                          append_batch_size=False)
        point_lod = L.data(name="point_lod", shape=[-1], dtype="int32",
                           append_batch_size=False)
        anc = L.concat([L.reshape(a, [-1, 4]) for a, _ in anchors], axis=0)
        var = L.concat([L.reshape(v, [-1, 4]) for _, v in anchors], axis=0)
        score, loc, tgt_label, tgt_box, _ = L.rpn_target_assign(
            L.concat([_flat(L, b, 4) for _, b in rpn], axis=0),
            L.concat([_flat(L, c, 1) for c, _ in rpn], axis=0), anc, var,
            gt_box, is_crowd, im_info, rpn_batch_size_per_im=rpn_batch,
            rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
            rpn_negative_overlap=0.3)
        rpn_cls = L.reduce_mean(L.sigmoid_cross_entropy_with_logits(
            score, L.cast(tgt_label, "float32")))
        # the reference's targets are pixel boxes: in units of the
        # image's longer side, so that the regression stays bounded
        unit = 1.0 / max(img)
        rpn_reg = L.scale(L.reduce_sum(L.smooth_l1(
            loc, L.scale(tgt_box, scale=unit), sigma=3.0)),
            scale=1.0 / rpn_batch)
        rois = _proposals(fluid, rpn, anchors, im_info, pre_train,
                          post_train)
        rois, labels, targets, w_in, w_out = L.generate_proposal_labels(
            rois, gt_class, is_crowd, gt_box, im_info,
            batch_size_per_im=roi_batch, fg_fraction=0.25, fg_thresh=0.5,
            bg_thresh_hi=0.5, bg_thresh_lo=0.0, class_nums=classes)
        cls, bbox = _box_head(fluid, _roi_feats(fluid, levels, rois, 7), classes, head)
        box_cls = L.reduce_mean(L.softmax_with_cross_entropy(
            cls, L.cast(labels, "int64")))
        # Paddle's smooth_l1 weighs the difference by the inside weights
        # (the fg class's four slots); the reference's reads no weights,
        # so they multiply both sides here
        box_reg = L.reduce_mean(L.smooth_l1(
            L.elementwise_mul(bbox, w_in),
            L.elementwise_mul(L.scale(targets, scale=unit), w_in)))
        mrois, _, mask_tgt = L.generate_mask_labels(
            im_info, gt_class, is_crowd, segms, rois, labels, classes,
            resolution, poly_lod, point_lod)
        m = _roi_feats(fluid, levels, mrois, resolution // 2)
        for i in range(mask_convs):
            m = L.conv2d(m, fpn, 3, padding=1, act="relu",
                         param_attr=_param(fluid, "mask_fcn%d_w" % i),
                         bias_attr=_param(fluid, "mask_fcn%d_b" % i))
        m = L.conv2d_transpose(m, fpn, filter_size=2, stride=2, act="relu",
                               param_attr=_param(fluid, "conv5_mask_w"),
                               bias_attr=_param(fluid, "conv5_mask_b"))
        m = L.conv2d(m, classes, 1, param_attr=_param(fluid, "mask_fcn_w"),
                     bias_attr=_param(fluid, "mask_fcn_b"))
        mask_loss = L.reduce_sum(L.sigmoid_cross_entropy_with_logits(
            L.reshape(m, [-1, classes * resolution * resolution]),
            L.cast(mask_tgt, "float32"), ignore_index=-1, normalize=True))
        losses = [rpn_cls, rpn_reg, box_cls, box_reg, mask_loss]
        loss = losses[0]
        for part in losses[1:]:
            loss = L.elementwise_add(loss, part)
        fluid.optimizer.MomentumOptimizer(
            learning_rate=lr, momentum=0.9,
            regularization=fluid.regularizer.L2Decay(1e-4)).minimize(loss)

    test, test_startup = _programs(fluid, seed)
    with fluid.program_guard(test, test_startup), fluid.unique_name_guard():
        im_info, levels, rpn, anchors = _mask_rcnn_net(
            fluid, img, depths, width_div, fpn)
        gt_label = L.data(name="gt_label", shape=[-1, 5], dtype="float32",
                          append_batch_size=False)
        norm = L.data(name="norm", shape=[6], dtype="float32",
                      append_batch_size=False)
        rois = _proposals(fluid, rpn, anchors, im_info, pre_test, post_test)
        cls, bbox = _box_head(fluid, _roi_feats(fluid, levels, rois, 7), classes, head)
        prob = L.softmax(cls)
        prior_var = L.concat([L.fill_constant([2], "float32", 0.1),
                              L.fill_constant([2], "float32", 0.2)], axis=0)
        _, assigned = L.box_decoder_and_assign(rois, prior_var, bbox, prob)
        nms = L.multiclass_nms(L.reshape(assigned, [1, -1, 4]),
                               L.transpose(L.reshape(prob, [1, -1, classes]),
                                           [0, 2, 1]),
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.5,
                               normalized=False)
        m_ap = L.detection_map(L.elementwise_div(nms, norm), gt_label,
                               classes, overlap_threshold=0.5,
                               ap_version="integral")

    def feed(rng):
        return mask_rcnn_feed(img, classes, boxes, rng)

    def test_feed(rng):
        f = mask_rcnn_feed(img, classes, boxes, rng)
        h, w = img
        lab = np.concatenate([f["gt_class"].astype("float32"),
                              f["gt_box"] / [w, h, w, h]], 1)
        return {"image": f["image"], "im_info": f["im_info"],
                "gt_label": lab.astype("float32"),
                "norm": np.asarray([1, 1, w, h, w, h], "float32")}

    host = ("rpn_target_assign", "generate_proposals",
            "collect_fpn_proposals", "generate_proposal_labels",
            "distribute_fpn_proposals", "generate_mask_labels")
    return TwoStage(main, startup, loss, losses, feed, test, [nms, m_ap],
                    test_feed, host)


def mask_rcnn_feed(img, classes, boxes, rng):
    """One image in [0, 1) of `img` (h, w) and its ground truth: 1 to
    `boxes` boxes of random size and place, classes in 1..classes-1, each
    with an octagon ring inside it as its polygon (GtSegms, one polygon a
    ground truth)."""
    h, w = img
    k = rng.randint(max(1, boxes // 4), boxes + 1)
    bw = rng.uniform(0.05, 0.5, k) * w
    bh = rng.uniform(0.05, 0.5, k) * h
    x1 = rng.uniform(0, 1, k) * (w - 1 - bw)
    y1 = rng.uniform(0, 1, k) * (h - 1 - bh)
    box = np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype("float32")
    t = np.arange(8) * (2 * np.pi / 8) + rng.uniform(0, 0.3)
    cx, cy = x1 + bw / 2, y1 + bh / 2
    ring = np.stack([cx[:, None] + np.cos(t) * bw[:, None] / 2,
                     cy[:, None] + np.sin(t) * bh[:, None] / 2], -1)
    return {"image": rng.uniform(0, 1, (1, 3, h, w)).astype("float32"),
            "im_info": np.asarray([[h, w, 1.0]], "float32"),
            "gt_box": box,
            "gt_class": rng.randint(1, classes, (k, 1)).astype("int32"),
            "is_crowd": np.zeros((k, 1), "int32"),
            "gt_segms": ring.reshape(-1, 2).astype("float32"),
            "poly_lod": np.arange(k + 1).astype("int32"),
            "point_lod": (np.arange(k + 1) * 8).astype("int32")}


def _conv_bn_relu(fluid, x, ch, k, stride, groups, name):
    L = fluid.layers
    conv = L.conv2d(x, ch, k, stride=stride, padding=(k - 1) // 2,
                    groups=groups, bias_attr=False,
                    param_attr=_param(fluid, name + "_weights"))
    return L.batch_norm(conv, act="relu",
                        param_attr=_param(fluid, name + "_bn_scale"),
                        bias_attr=_param(fluid, name + "_bn_offset"),
                        moving_mean_name=name + "_bn_mean",
                        moving_variance_name=name + "_bn_variance")


#: MobileNet-v1's depthwise-separable blocks: (output channels, stride)
MOBILENET_V1 = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
                (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
                (1024, 2), (1024, 1)]


def _ssd_net(fluid, img, classes, div, extras, min_sizes, max_sizes):
    """MobileNet-v1 to its 13th block, the extra blocks, and the six
    heads: (loc [N, P, 4], conf [N, P, classes], priors [P, 4], their
    variances)."""
    L = fluid.layers
    image = L.data(name="image", shape=[3, img, img], dtype="float32")
    x = _conv_bn_relu(fluid, image, 32 // div, 3, 2, 1, "conv1")
    feats = []
    ch_in = 32 // div
    for i, (ch, stride) in enumerate(MOBILENET_V1):
        x = _conv_bn_relu(fluid, x, ch_in, 3, stride, ch_in,
                          "conv%d_dw" % (i + 2))
        x = _conv_bn_relu(fluid, x, ch // div, 1, 1, 1,
                          "conv%d_sep" % (i + 2))
        ch_in = ch // div
        if i in (10, 12):
            feats.append(x)
    for i, (c0, c1) in enumerate(extras):
        x = _conv_bn_relu(fluid, x, c0 // div, 1, 1, 1,
                          "conv7_%d" % (2 * i + 1))
        x = _conv_bn_relu(fluid, x, c1 // div, 3, 2, 1,
                          "conv7_%d" % (2 * i + 2))
        feats.append(x)
    locs, confs, priors, pvars = [], [], [], []
    for i, f in enumerate(feats):
        ars = [2.0] if i == 0 else [2.0, 3.0]
        maxs = [max_sizes[i]] if max_sizes[i] else None
        box, var = L.prior_box(f, image, [min_sizes[i]], maxs, ars,
                               [0.1, 0.1, 0.2, 0.2], flip=True, clip=False,
                               offset=0.5)
        n = (len(ars) * 2 + 1) + (1 if maxs else 0)
        loc = L.conv2d(f, n * 4, 3, padding=1,
                       param_attr=_param(fluid, "loc_%d_w" % i),
                       bias_attr=_param(fluid, "loc_%d_b" % i))
        conf = L.conv2d(f, n * classes, 3, padding=1,
                        param_attr=_param(fluid, "conf_%d_w" % i),
                        bias_attr=_param(fluid, "conf_%d_b" % i))
        locs.append(L.reshape(L.transpose(loc, [0, 2, 3, 1]), [1, -1, 4]))
        confs.append(L.reshape(L.transpose(conf, [0, 2, 3, 1]),
                               [1, -1, classes]))
        priors.append(L.reshape(box, [-1, 4]))
        pvars.append(L.reshape(var, [-1, 4]))
    return (L.concat(locs, axis=1), L.concat(confs, axis=1),
            L.concat(priors, axis=0), L.concat(pvars, axis=0))


def ssd_mobilenet_v1(fluid, img=300, classes=21, width_div=1, boxes=50,
                     extras=SSD_FULL["extras"],
                     min_sizes=SSD_FULL["min_sizes"],
                     max_sizes=SSD_FULL["max_sizes"], lr=0.001, seed=23):
    """SSD MobileNet-v1 (`SSD_FULL`), one image a step: the reference's
    `ssd_loss` over the priors, RMSProp as PaddleDetection trains it (at
    lr 0.001, L2Decay(5e-5)); evaluation over the same parameter names,
    `detection_output` (IoU 0.45, nms_top_k 400, keep 200, score 0.01)
    and `detection_map` at 11point. Batch 1: the reference's `ssd_loss`
    matches one image's ground truth (`iou_similarity(gt_box,
    prior_box)` with no batch axis)."""
    L = fluid.layers
    args = (img, classes, width_div, extras, min_sizes, max_sizes)
    main, startup = _programs(fluid, seed)
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        loc, conf, prior, pvar = _ssd_net(fluid, *args)
        gt_box = L.data(name="gt_box", shape=[-1, 4], dtype="float32",
                        append_batch_size=False)
        gt_label = L.data(name="gt_label", shape=[-1, 1], dtype="int32",
                          append_batch_size=False)
        loss = L.reduce_sum(L.ssd_loss(loc, conf, gt_box, gt_label, prior,
                                       pvar))
        fluid.optimizer.RMSPropOptimizer(
            learning_rate=lr,
            regularization=fluid.regularizer.L2Decay(5e-5)).minimize(loss)

    test, test_startup = _programs(fluid, seed)
    with fluid.program_guard(test, test_startup), fluid.unique_name_guard():
        loc, conf, prior, pvar = _ssd_net(fluid, *args)
        gt = L.data(name="gt", shape=[-1, 5], dtype="float32",
                    append_batch_size=False)
        out = L.detection_output(loc, L.transpose(L.softmax(conf),
                                                  [0, 2, 1]), prior, pvar,
                                 nms_threshold=0.45, nms_top_k=400,
                                 keep_top_k=200, score_threshold=0.01)
        m_ap = L.detection_map(out, gt, classes, overlap_threshold=0.5,
                               ap_version="11point")
    for op in test.global_block().ops:
        if op.type == "batch_norm":
            op.attrs["is_test"] = True

    def feed(rng):
        return ssd_feed(img, classes, boxes, rng)

    def test_feed(rng):
        f = ssd_feed(img, classes, boxes, rng)
        return {"image": f["image"], "gt": np.concatenate(
            [f["gt_label"].astype("float32"), f["gt_box"]], 1)}

    host = ("bipartite_match",)
    return TwoStage(main, startup, loss, [loss], feed, test, [out, m_ap],
                    test_feed, host)


def ssd_feed(img, classes, boxes, rng):
    """One image in [0, 1) and 1 to `boxes` ground truths in [0, 1]
    coordinates, classes in 1..classes-1."""
    k = rng.randint(max(1, boxes // 4), boxes + 1)
    wh = rng.uniform(0.05, 0.6, (k, 2))
    lo = rng.uniform(0, 1, (k, 2)) * (1 - wh)
    return {"image": rng.uniform(0, 1, (1, 3, img, img)).astype("float32"),
            "gt_box": np.concatenate([lo, lo + wh], 1).astype("float32"),
            "gt_label": rng.randint(1, classes, (k, 1)).astype("int32")}
