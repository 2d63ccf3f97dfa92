"""Neural-network layers of the slice (counterpart:
`paddle_tpu/fluid/layers/nn.py`): `fc`, `embedding`, `conv2d`,
`pool2d`, `batch_norm`, `layer_norm`, `dropout`, the activations
`relu`, `tanh` and `gelu`, `softmax`, `matmul`, `elementwise_add` /
`_mul` / `_div`, `reduce_sum`, `mean`, `slice`, `gather`, `scatter`,
`accuracy`, `topk`, `scaled_dot_product_attention`, and for the
Transformer `one_hot`, `label_smooth`, `unsqueeze`, `squeeze`, `stack`,
`where`, `elementwise_sub` / `_max` / `_min` / `_pow` / `_mod` /
`_floordiv`, the activations `exp`, `floor` and `cos` (the learning
rate schedules'), and for `rnn_decode` `sigmoid`, `log_softmax`, `split`
and `expand`; for the float16 AMP slice `fc` over several inputs
(`sum`), the activations of the reference's list (`sqrt` ... `sin`),
`maximum`, `minimum`, the `reduce_*` family, `clip`, `clip_by_norm` and
`l2_normalize`; and `mul`, `pad`, `pad2d`, `unstack`, `expand_as`,
`gather_nd`, `strided_slice` and `flatten`, with the `logical_*` family,
`uniform_random` and `gaussian_random`, which (as in the reference) this
module defines but `fluid.layers` does not export. Each builder
creates its params through LayerHelper (init ops go to the startup
program) and appends its compute op."""
from __future__ import annotations

import numpy as np

from ..framework import Variable, unique_name
from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper, apply_op
from ..param_attr import ParamAttr

__all__ = ["fc", "embedding", "conv2d", "pool2d", "batch_norm",
           "layer_norm", "dropout", "relu", "tanh", "gelu", "softmax",
           "matmul", "elementwise_add", "elementwise_mul",
           "elementwise_div", "reduce_sum", "mean", "slice", "gather",
           "scatter", "accuracy", "topk", "scaled_dot_product_attention",
           "one_hot", "label_smooth", "unsqueeze", "squeeze", "stack",
           "where", "elementwise_sub", "elementwise_max", "elementwise_min",
           "elementwise_pow", "elementwise_mod", "elementwise_floordiv",
           "exp", "floor", "cos", "sigmoid", "log_softmax", "split",
           "expand", "sqrt", "square", "log", "abs", "ceil", "round",
           "reciprocal", "leaky_relu", "elu", "relu6", "softplus",
           "softsign", "swish", "hard_sigmoid", "hard_swish", "logsigmoid",
           "erf", "sin", "maximum", "minimum", "reduce_mean", "reduce_max",
           "reduce_min", "reduce_prod", "reduce_all", "reduce_any", "clip",
           "clip_by_norm", "l2_normalize", "mul", "pad", "pad2d",
           "unstack", "expand_as", "gather_nd", "strided_slice", "flatten"]


def _single(op_type, inputs, attrs, dtype=None, helper=None):
    return apply_op(helper or op_type, op_type, inputs, attrs, ["Out"],
                    out_dtype=dtype)[0]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully-connected (reference: layers/nn.py fc) = mul + bias + act;
    over several inputs, one weight an input and their products summed
    (`sum`)."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    param_attrs = helper.multiple_param_attr(len(inputs))
    if not isinstance(param_attrs, (list, tuple)):
        param_attrs = [param_attrs] * len(inputs)
    mul_results = []
    for inp, w_attr in zip(inputs, param_attrs):
        in_dim = int(np.prod(inp.shape[num_flatten_dims:]))
        w = helper.create_parameter(w_attr, shape=[in_dim, size],
                                    dtype=inp.dtype)
        mul_results.append(_single(
            "mul", {"X": [inp], "Y": [w]},
            {"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
            dtype=inp.dtype, helper=helper))
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = _single("sum", {"X": mul_results}, {},
                           dtype=mul_results[0].dtype, helper=helper)
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """A [size[0], size[1]] table looked up by `input`'s ids (the
    `lookup_table` op; sparse updates are not ported, so `is_sparse` only
    rides along as an attr)."""
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(helper.param_attr, shape=list(size),
                                dtype=dtype)
    pad = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    return _single("lookup_table", {"W": [w], "Ids": [input]},
                   {"padding_idx": pad, "is_sparse": is_sparse,
                    "is_distributed": is_distributed},
                   dtype=dtype, helper=helper)


def _pair(v):
    return [v, v] if isinstance(v, int) else list(v)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    """A 2-D convolution over NCHW `input` with an OIHW filter created
    here (initialized Normal(0, sqrt(2 / fan_in))), or, when
    `param_attr` is a Variable, with that existing filter: the scanned
    ResNet stage passes per-iteration slices of stacked [L, O, I, kh,
    kw] filters."""
    helper = LayerHelper("conv2d",
                         param_attr=None if isinstance(param_attr, Variable)
                         else param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    num_channels = input.shape[1]
    filter_size = _pair(filter_size)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    fan_in = (num_channels // groups) * filter_size[0] * filter_size[1]
    if isinstance(param_attr, Variable):
        if tuple(int(d) for d in param_attr.shape) != tuple(filter_shape):
            raise ValueError(
                "conv2d: provided filter var %r has shape %s, expected "
                "%s (pass the per-iteration slice, not the stack)"
                % (param_attr.name, tuple(param_attr.shape),
                   tuple(filter_shape)))
        w = param_attr
    else:
        w = helper.create_parameter(
            helper.param_attr, shape=filter_shape, dtype=input.dtype,
            default_initializer=NormalInitializer(
                0.0, (2.0 / fan_in) ** 0.5))
    pre_bias = apply_op(helper, "conv2d",
                        {"Input": [input], "Filter": [w]},
                        {"strides": _pair(stride), "paddings": _pair(padding),
                         "dilations": _pair(dilation), "groups": groups},
                        ["Output"], out_dtype=input.dtype)[0]
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True, data_format="NCHW"):
    attrs = {"pooling_type": pool_type, "ksize": _pair(pool_size),
             "strides": _pair(pool_stride), "paddings": _pair(pool_padding),
             "global_pooling": global_pooling, "ceil_mode": ceil_mode,
             "exclusive": exclusive}
    return _single("pool2d", {"X": [input]}, attrs, dtype=input.dtype)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=True,
               use_global_stats=False):
    """Batch norm with a scale (initialized 1), a bias (0) and running
    mean (0) and variance (1), the last two persistable and not
    trainable: the op writes their new values back onto them."""
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    dtype = input.dtype if input.dtype != "float16" else "float32"
    scale = helper.create_parameter(
        helper.param_attr, shape=[c], dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(helper.bias_attr, shape=[c], dtype=dtype,
                                   is_bias=True)
    stats = []
    for given, suffix, init in ((moving_mean_name, ".mean", 0.0),
                                (moving_variance_name, ".var", 1.0)):
        v = helper.create_parameter(
            ParamAttr(name=given or unique_name(helper.name + suffix),
                      trainable=False),
            shape=[c], dtype=dtype,
            default_initializer=ConstantInitializer(init))
        stats.append(v)
    mean, var = stats
    saved_mean = helper.create_variable_for_type_inference(dtype)
    saved_var = helper.create_variable_for_type_inference(dtype)
    y = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [var]},
        outputs={"Y": [y], "MeanOut": [mean], "VarianceOut": [var],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(y)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    """`scale` / `shift` may be Variables: the scan body normalizes with
    per-iteration slices of stacked [L, H] params instead of creating
    its own."""
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if isinstance(scale, Variable):
        inputs["Scale"] = [scale]
    elif scale:
        inputs["Scale"] = [helper.create_parameter(
            helper.param_attr, shape=norm_shape, dtype=input.dtype,
            default_initializer=ConstantInitializer(1.0))]
    if isinstance(shift, Variable):
        inputs["Bias"] = [shift]
    elif shift:
        inputs["Bias"] = [helper.create_parameter(
            helper.bias_attr, shape=norm_shape, dtype=input.dtype,
            is_bias=True)]
    outs = apply_op(helper, "layer_norm", inputs,
                    {"begin_norm_axis": begin_norm_axis, "epsilon": epsilon},
                    ["Y", "Mean", "Variance"], out_dtype=input.dtype)
    return helper.append_activation(outs[0])


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    return apply_op("dropout", "dropout", {"X": [x]},
                    {"dropout_prob": dropout_prob, "is_test": is_test,
                     "seed": seed or 0,
                     "dropout_implementation": dropout_implementation},
                    ["Out", "Mask"], out_dtype=x.dtype)[0]


def _make_act(op_type):
    def f(x, name=None, **kwargs):
        attrs = {k: v for k, v in kwargs.items()
                 if k in ("alpha", "beta", "threshold", "slope", "offset",
                          "approximate", "scale")}
        return _single(op_type, {"X": [x]}, attrs, dtype=x.dtype)

    f.__name__ = op_type
    return f


relu = _make_act("relu")
tanh = _make_act("tanh")
gelu = _make_act("gelu")
sigmoid = _make_act("sigmoid")
exp = _make_act("exp")
floor = _make_act("floor")
cos = _make_act("cos")
sqrt = _make_act("sqrt")
square = _make_act("square")
log = _make_act("log")
abs = _make_act("abs")
ceil = _make_act("ceil")
round = _make_act("round")
reciprocal = _make_act("reciprocal")
leaky_relu = _make_act("leaky_relu")
elu = _make_act("elu")
relu6 = _make_act("relu6")
softplus = _make_act("softplus")
softsign = _make_act("softsign")
swish = _make_act("swish")
hard_sigmoid = _make_act("hard_sigmoid")
hard_swish = _make_act("hard_swish")
logsigmoid = _make_act("logsigmoid")
erf = _make_act("erf")
sin = _make_act("sin")


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    return _single("matmul", {"X": [x], "Y": [y]},
                   {"transpose_X": transpose_x, "transpose_Y": transpose_y,
                    "alpha": float(alpha)}, dtype=x.dtype)


def _make_elementwise(op_type):
    def f(x, y, axis=-1, act=None, name=None):
        out = _single(op_type, {"X": [x], "Y": [y]}, {"axis": axis},
                      dtype=x.dtype)
        if act:
            out = _single(act, {"X": [out]}, {}, dtype=x.dtype)
        return out

    f.__name__ = op_type
    return f


elementwise_add = _make_elementwise("elementwise_add")
elementwise_sub = _make_elementwise("elementwise_sub")
elementwise_mul = _make_elementwise("elementwise_mul")
elementwise_div = _make_elementwise("elementwise_div")
elementwise_max = _make_elementwise("elementwise_max")
elementwise_min = _make_elementwise("elementwise_min")
elementwise_pow = _make_elementwise("elementwise_pow")
elementwise_mod = _make_elementwise("elementwise_mod")
elementwise_floordiv = _make_elementwise("elementwise_floordiv")


def _make_reduce(op_type):
    def f(input, dim=None, keep_dim=False, name=None):
        if dim is None:
            attrs = {"reduce_all": True, "dim": [0], "keep_dim": keep_dim}
        else:
            attrs = {"dim": dim if isinstance(dim, (list, tuple)) else [dim],
                     "keep_dim": keep_dim, "reduce_all": False}
        return _single(op_type, {"X": [input]}, attrs, dtype=input.dtype)

    f.__name__ = op_type
    return f


reduce_sum = _make_reduce("reduce_sum")
reduce_mean = _make_reduce("reduce_mean")
reduce_max = _make_reduce("reduce_max")
reduce_min = _make_reduce("reduce_min")
reduce_prod = _make_reduce("reduce_prod")
reduce_all = _make_reduce("reduce_all")
reduce_any = _make_reduce("reduce_any")


def maximum(x, y, name=None):
    return _single("maximum", {"X": [x], "Y": [y]}, {}, dtype=x.dtype)


def minimum(x, y, name=None):
    return _single("minimum", {"X": [x], "Y": [y]}, {}, dtype=x.dtype)


def clip(x, min, max, name=None):
    return _single("clip", {"X": [x]}, {"min": float(min),
                                        "max": float(max)}, dtype=x.dtype)


def clip_by_norm(x, max_norm, name=None):
    return _single("clip_by_norm", {"X": [x]},
                   {"max_norm": float(max_norm)}, dtype=x.dtype)


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    """x / sqrt(sum(x^2, axis) + epsilon), as the reference composes it."""
    sq = _single("square", {"X": [x]}, {}, dtype=x.dtype)
    ssum = reduce_sum(sq, dim=axis, keep_dim=True)
    norm = _single("sqrt", {"X": [elementwise_add(
        ssum, fill_like_eps(ssum, epsilon))]}, {}, dtype=x.dtype)
    return elementwise_div(x, norm)


def fill_like_eps(ref, eps):
    from . import tensor as t

    return t.fill_constant(shape=[1], dtype=ref.dtype, value=eps)


def slice(input, axes, starts, ends):
    return _single("slice", {"Input": [input]},
                   {"axes": list(axes), "starts": list(starts),
                    "ends": list(ends), "decrease_axis": []},
                   dtype=input.dtype)


def gather(input, index, overwrite=True):
    return _single("gather", {"X": [input], "Index": [index]}, {},
                   dtype=input.dtype)


def scatter(input, index, updates, name=None, overwrite=True):
    return _single("scatter",
                   {"X": [input], "Ids": [index], "Updates": [updates]},
                   {"overwrite": overwrite}, dtype=input.dtype)


def scaled_dot_product_attention(q, k, v, key_bias=None, causal=False,
                                 sm_scale=None, attn_dropout_prob=0.0,
                                 is_test=False, name=None,
                                 flash_impl="auto"):
    """Attention over [B, H, S, D] q/k/v with an optional [B, Sk] additive
    key bias (the `scaled_dot_product_attention` op: the flash kernels on
    the card at long keys, else the composite path). `flash_impl`
    "reference" runs the flash kernels' plain version where the kernels
    would run (a check, not a fallback)."""
    ins = {"Q": [q], "K": [k], "V": [v]}
    if key_bias is not None:
        ins["KeyBias"] = [key_bias]
    attrs = {"causal": causal,
             "sm_scale": -1.0 if sm_scale is None else float(sm_scale),
             "attn_dropout_prob": float(attn_dropout_prob),
             "is_test": is_test}
    if flash_impl != "auto":
        attrs["flash_impl"] = flash_impl
    return _single("scaled_dot_product_attention", ins, attrs,
                   dtype=q.dtype)


def softmax(input, use_cudnn=False, name=None, axis=-1):
    return _single("softmax", {"X": [input]}, {"axis": axis},
                   dtype=input.dtype)


def mean(x, name=None):
    return _single("mean", {"X": [x]}, {}, dtype=x.dtype)


def accuracy(input, label, k=1, correct=None, total=None):
    topk_out, topk_indices = topk(input, k=k)
    outs = apply_op("accuracy", "accuracy",
                    {"Out": [topk_out], "Indices": [topk_indices],
                     "Label": [label]}, {},
                    ["Accuracy", "Correct", "Total"], out_dtype="float32")
    return outs[0]


def topk(input, k=1, name=None):
    outs = apply_op("top_k", "top_k", {"X": [input]}, {"k": k},
                    ["Out", "Indices"], out_dtype=input.dtype)
    return outs[0], outs[1]


def one_hot(input, depth, allow_out_of_range=False):
    """[..., 1] int ids -> [..., depth] float32 rows."""
    return _single("one_hot", {"X": [input]}, {"depth": depth},
                   dtype="float32")


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    ins = {"X": [label]}
    if prior_dist is not None:
        ins["PriorDist"] = [prior_dist]
    return _single("label_smooth", ins, {"epsilon": float(epsilon)},
                   dtype=dtype)


def unsqueeze(input, axes, name=None):
    return apply_op("unsqueeze2", "unsqueeze2", {"X": [input]},
                    {"axes": list(axes)}, ["Out", "XShape"],
                    out_dtype=input.dtype)[0]


def squeeze(input, axes, name=None):
    return apply_op("squeeze2", "squeeze2", {"X": [input]},
                    {"axes": list(axes)}, ["Out", "XShape"],
                    out_dtype=input.dtype)[0]


def stack(x, axis=0, name=None):
    xs = x if isinstance(x, (list, tuple)) else [x]
    return apply_op("stack", "stack", {"X": list(xs)}, {"axis": axis},
                    ["Y"], out_dtype=xs[0].dtype)[0]


def where(condition, x=None, y=None, name=None):
    return _single("where", {"Condition": [condition], "X": [x], "Y": [y]},
                   {}, dtype=x.dtype)


def log_softmax(input, axis=-1, name=None):
    return _single("log_softmax", {"X": [input]}, {"axis": axis},
                   dtype=input.dtype)


def split(input, num_or_sections, dim=-1, name=None):
    """`input` split along `dim` into that many equal parts, or parts of
    the sizes listed; returns the list of vars."""
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "sections": [], "axis": dim}
    else:
        n = len(num_or_sections)
        attrs = {"num": 0, "sections": list(num_or_sections), "axis": dim}
    return apply_op("split", "split", {"X": [input]}, attrs, {"Out": n},
                    out_dtype=input.dtype)


def expand(x, expand_times, name=None):
    return _single("expand", {"X": [x]},
                   {"expand_times": list(expand_times)}, dtype=x.dtype)


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    return _single("mul", {"X": [x], "Y": [y]},
                   {"x_num_col_dims": x_num_col_dims,
                    "y_num_col_dims": y_num_col_dims}, dtype=x.dtype)


def logical_and(x, y, out=None, name=None):
    return _single("logical_and", {"X": [x], "Y": [y]}, {}, dtype="bool")


def logical_or(x, y, out=None, name=None):
    return _single("logical_or", {"X": [x], "Y": [y]}, {}, dtype="bool")


def logical_xor(x, y, out=None, name=None):
    return _single("logical_xor", {"X": [x], "Y": [y]}, {}, dtype="bool")


def logical_not(x, out=None, name=None):
    return _single("logical_not", {"X": [x]}, {}, dtype="bool")


def pad(x, paddings, pad_value=0.0, name=None):
    return _single("pad", {"X": [x]},
                   {"paddings": list(paddings), "pad_value": pad_value},
                   dtype=x.dtype)


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    return _single("pad2d", {"X": [input]},
                   {"paddings": list(paddings), "mode": mode,
                    "pad_value": pad_value}, dtype=input.dtype)


def unstack(x, axis=0, num=None):
    n = num or x.shape[axis]
    return apply_op("unstack", "unstack", {"X": [x]}, {"axis": axis},
                    {"Y": n}, out_dtype=x.dtype)


def expand_as(x, target_tensor, name=None):
    return _single("expand_as_v2", {"X": [x], "Y": [target_tensor]},
                   {"target_shape": list(target_tensor.shape)},
                   dtype=x.dtype)


def gather_nd(input, index, name=None):
    return _single("gather_nd", {"X": [input], "Index": [index]}, {},
                   dtype=input.dtype)


def strided_slice(input, axes, starts, ends, strides):
    return _single("strided_slice", {"Input": [input]},
                   {"axes": list(axes), "starts": list(starts),
                    "ends": list(ends), "strides": list(strides)},
                   dtype=input.dtype)


def flatten(x, axis=1, name=None):
    return apply_op("flatten2", "flatten2", {"X": [x]}, {"axis": axis},
                    ["Out", "XShape"], out_dtype=x.dtype)[0]


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0,
                   name=None):
    return _single("uniform_random", {},
                   {"shape": list(shape), "min": float(min),
                    "max": float(max), "seed": seed, "dtype": dtype},
                   dtype=dtype)


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32",
                    name=None):
    return _single("gaussian_random", {},
                   {"shape": list(shape), "mean": float(mean),
                    "std": float(std), "seed": seed, "dtype": dtype},
                   dtype=dtype)
