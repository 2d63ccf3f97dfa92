"""ResNet for ImageNet classification in the fluid static graph
(counterpart: `paddle_tpu/models/resnet.py`, BASELINE.json config 2):
conv2d + batch_norm + pool2d bottleneck (or basic) stacks, trained with
Momentum.

With `scan_stages` each bottleneck stage's identical tail blocks (stride
1, identity shortcut) run as one `layers.Scan` over stacked [L, ...]
conv filters and BN scales and biases; the BN running statistics are
stacked [L, C] vars that each iteration reads with `gather` at
`scan.iteration()` and writes back with `scatter`, so the math equals
the unrolled blocks'.
"""
from __future__ import annotations

import math

from .. import fluid
from ..fluid import layers
from ..fluid.layer_helper import LayerHelper, apply_op
from ..fluid.param_attr import ParamAttr

DEPTH_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, name=None, is_test=False):
    conv = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=(filter_size - 1) // 2, groups=groups,
        act=None, bias_attr=False,
        param_attr=ParamAttr(name=name + "_weights" if name else None))
    return layers.batch_norm(
        input=conv, act=act, is_test=is_test,
        param_attr=ParamAttr(name=name + "_bn_scale" if name else None),
        bias_attr=ParamAttr(name=name + "_bn_offset" if name else None),
        moving_mean_name=name + "_bn_mean" if name else None,
        moving_variance_name=name + "_bn_var" if name else None)


def shortcut(input, ch_out, stride, name, is_test=False):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, name=name,
                             is_test=is_test)
    return input


def bottleneck_block(input, num_filters, stride, name, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu",
                          name=name + "_branch2a", is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride, act="relu",
                          name=name + "_branch2b", is_test=is_test)
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1, act=None,
                          name=name + "_branch2c", is_test=is_test)
    short = shortcut(input, num_filters * 4, stride,
                     name=name + "_branch1", is_test=is_test)
    return layers.relu(layers.elementwise_add(short, conv2))


def basic_block(input, num_filters, stride, name, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 3, stride=stride, act="relu",
                          name=name + "_branch2a", is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, act=None,
                          name=name + "_branch2b", is_test=is_test)
    short = shortcut(input, num_filters, stride, name=name + "_branch1",
                     is_test=is_test)
    return layers.relu(layers.elementwise_add(short, conv1))


def _bn_with_vars(x, scale, bias, mean, var, is_test, act=None,
                  momentum=0.9):
    """batch_norm over existing scale, bias, mean and var vars, returning
    (y, mean_out, var_out) as new vars: the scan body feeds
    per-iteration rows in and scatters the new statistics back."""
    helper = LayerHelper("batch_norm", act=act)
    outs = apply_op(
        helper, "batch_norm",
        {"X": [x], "Scale": [scale], "Bias": [bias], "Mean": [mean],
         "Variance": [var]},
        {"momentum": momentum, "epsilon": 1e-5, "is_test": is_test,
         "data_layout": "NCHW"},
        ["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"],
        out_dtype=x.dtype)
    return helper.append_activation(outs[0]), outs[1], outs[2]


def _scan_stage_tail(x, n_rep, num_filters, name, is_test):
    """Blocks 1..count-1 of a bottleneck stage as one layers.Scan over
    stacked [L, ...] conv filters and BN scales and biases, the BN
    running statistics stacked [L, C] and updated row by row."""
    L, f = n_rep, num_filters
    C = f * 4
    zeros = fluid.initializer.Constant(0.0)
    ones = fluid.initializer.Constant(1.0)
    convs = [("2a", f, C, 1), ("2b", f, f, 3), ("2c", C, f, 1)]
    w_stk, aff_stk, stats = {}, {}, {}
    for suf, oc, ic, k in convs:
        fan_in = ic * k * k
        w_stk[suf] = layers.create_parameter(
            shape=[L, oc, ic, k, k], dtype="float32",
            name=name + suf + "_weights",
            attr=ParamAttr(
                name=name + suf + "_weights",
                initializer=fluid.initializer.Normal(
                    0.0, math.sqrt(2.0 / fan_in))))
        aff_stk[suf] = (
            layers.create_parameter(
                shape=[L, oc], dtype="float32",
                name=name + suf + "_bn_scale",
                attr=ParamAttr(name=name + suf + "_bn_scale",
                               initializer=ones)),
            layers.create_parameter(
                shape=[L, oc], dtype="float32",
                name=name + suf + "_bn_offset",
                attr=ParamAttr(name=name + suf + "_bn_offset",
                               initializer=zeros)))
        mean_v = layers.create_global_var(
            [L, oc], 0.0, "float32", persistable=True,
            name=name + suf + "_bn_mean")
        var_v = layers.create_global_var(
            [L, oc], 1.0, "float32", persistable=True,
            name=name + suf + "_bn_var")
        mean_v.stop_gradient = var_v.stop_gradient = True
        stats[suf] = (mean_v, var_v)

    scan = layers.Scan(n=L)
    with scan.block():
        idx = scan.iteration()
        w_sl = {suf: scan.slice_input(w_stk[suf]) for suf, *_ in convs}
        aff_sl = {suf: (scan.slice_input(aff_stk[suf][0]),
                        scan.slice_input(aff_stk[suf][1]))
                  for suf, *_ in convs}

        def conv_bn(xin, suf, oc, k, act):
            conv = layers.conv2d(xin, oc, k, stride=1,
                                 padding=(k - 1) // 2,
                                 param_attr=w_sl[suf], bias_attr=False)
            mean_stk, var_stk = stats[suf]
            mean_row = layers.reshape(layers.gather(mean_stk, idx), [-1])
            var_row = layers.reshape(layers.gather(var_stk, idx), [-1])
            y, mean_out, var_out = _bn_with_vars(
                conv, aff_sl[suf][0], aff_sl[suf][1], mean_row, var_row,
                is_test, act=act)
            if not is_test:
                layers.assign(layers.scatter(
                    mean_stk, idx, layers.reshape(mean_out, [1, -1])),
                    output=mean_stk)
                layers.assign(layers.scatter(
                    var_stk, idx, layers.reshape(var_out, [1, -1])),
                    output=var_stk)
            return y

        h = conv_bn(x, "2a", f, 1, "relu")
        h = conv_bn(h, "2b", f, 3, "relu")
        h = conv_bn(h, "2c", C, 1, None)
        new_x = layers.relu(layers.elementwise_add(x, h))
        layers.assign(new_x, output=x)
    return x


def resnet(input, class_dim=1000, depth=50, is_test=False,
           scan_stages=False):
    """The logits head over `input` (NCHW float). `scan_stages` runs each
    stage's identical tail blocks as one layers.Scan (bottleneck depths
    only)."""
    block_type, counts = DEPTH_CFG[depth]
    block_fn = bottleneck_block if block_type == "bottleneck" \
        else basic_block
    if scan_stages and block_type != "bottleneck":
        raise ValueError("scan_stages supports bottleneck depths only")
    conv = conv_bn_layer(input, 64, 7, stride=2, act="relu", name="conv1",
                         is_test=is_test)
    conv = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1,
                         pool_type="max")
    num_filters = [64, 128, 256, 512]
    for stage, count in enumerate(counts):
        stride = 2 if stage != 0 else 1
        conv = block_fn(conv, num_filters[stage], stride,
                        name="res%d_0" % (stage + 2), is_test=is_test)
        if scan_stages and count > 1:
            conv = _scan_stage_tail(conv, count - 1, num_filters[stage],
                                    "res%d_scan" % (stage + 2),
                                    is_test=is_test)
        else:
            for blk in range(1, count):
                conv = block_fn(conv, num_filters[stage], 1,
                                name="res%d_%d" % (stage + 2, blk),
                                is_test=is_test)
    pool = layers.pool2d(conv, pool_type="avg", global_pooling=True)
    stdv = 1.0 / math.sqrt(pool.shape[1] * 1.0)
    return layers.fc(
        input=pool, size=class_dim,
        param_attr=ParamAttr(
            name="fc_weights",
            initializer=fluid.initializer.Uniform(-stdv, stdv)),
        bias_attr=ParamAttr(name="fc_offset"))


def build_resnet_train(image_shape=(3, 224, 224), class_dim=1000, depth=50,
                       lr=0.1, momentum=0.9, weight_decay=1e-4,
                       is_test=False, scan_stages=False):
    """The training program (Momentum with L2Decay), or with `is_test`
    the evaluation one: returns (loss, accuracy, feed names)."""
    img = layers.data(name="image", shape=list(image_shape),
                      dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    logits = resnet(img, class_dim=class_dim, depth=depth,
                    is_test=is_test, scan_stages=scan_stages)
    loss = layers.softmax_with_cross_entropy(logits, label)
    avg_loss = layers.mean(loss)
    acc = layers.accuracy(input=layers.softmax(logits), label=label)
    if not is_test:
        opt = fluid.optimizer.MomentumOptimizer(
            learning_rate=lr, momentum=momentum,
            regularization=fluid.regularizer.L2Decay(weight_decay))
        opt.minimize(avg_loss)
    return avg_loss, acc, ["image", "label"]
