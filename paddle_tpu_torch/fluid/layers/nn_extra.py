"""fluid.layers builders of the second tranche (counterpart:
`paddle_tpu/fluid/layers/nn_extra.py`), the functions that emit the book
slice's op types: the 3-D convolutions and pools, the vision
rearrangements, the recurrent units (`dynamic_lstm`, `dynamic_lstmp`,
`dynamic_gru`, `gru_unit`, `lstm_unit`, and `lstm`, the `cudnn_lstm`
builder), `row_conv`, `fsp_matrix`, `im2sequence`, `spectral_norm`,
`cos_sim` and the small losses; `multiplex` and `py_func` (the
framework ops); and the activations `selu`, `softshrink`, `hard_shrink`,
`tanh_shrink`, `brelu`, `soft_relu`, `thresholded_relu`, with
`pad_constant_like`, `shard_index`, `uniform_random_batch_size_like`
and `sampling_id`; the interpolation functions `interpolate`,
`resize_bilinear`, `resize_trilinear`, `resize_linear`, `resize_bicubic`
and `image_resize_short` (the `*_interp` types; `image_resize` and
`resize_nearest` are in `nn.py`, emitting `interp_nearest` as the
reference's do); and for the detection slice `deformable_conv`,
`unpool`, `hsigmoid`, `sampled_softmax_with_cross_entropy`,
`add_position_encoding`, `random_crop` and `similarity_focus`. The
reference's functions that emit `specialty_ops`' other types (`nce`,
`warpctc`, `linear_chain_crf`, `crf_decoding`, `hash`,
`continuous_value_model` and `filter_by_instag`) are not ported yet
(ROADMAP Queue 1 #5)."""
from __future__ import annotations

import numpy as np

from .. import framework
from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper, apply_op
from ..param_attr import ParamAttr

__all__ = [
    "interpolate", "resize_bilinear", "resize_trilinear", "resize_linear",
    "resize_bicubic", "image_resize_short", "pool3d", "adaptive_pool3d",
    "conv3d", "conv3d_transpose",
    "grid_sampler", "affine_grid", "affine_channel", "lrn", "unfold",
    "space_to_depth", "shuffle_channel", "temporal_shift", "pixel_shuffle",
    "maxout", "row_conv", "fsp_matrix", "dynamic_lstm", "dynamic_lstmp",
    "dynamic_gru", "gru_unit", "lstm_unit", "lstm", "im2sequence",
    "dice_loss", "log_loss", "npair_loss", "rank_loss", "margin_rank_loss",
    "bpr_loss", "center_loss", "teacher_student_sigmoid_loss",
    "sigmoid_focal_loss", "cos_sim", "spectral_norm", "multiplex",
    "py_func", "selu", "softshrink", "hard_shrink", "tanh_shrink", "brelu",
    "soft_relu", "thresholded_relu", "pad_constant_like", "shard_index",
    "uniform_random_batch_size_like", "sampling_id", "deformable_conv",
    "unpool", "hsigmoid", "sampled_softmax_with_cross_entropy",
    "add_position_encoding", "random_crop", "similarity_focus",
]


def _one(op, inputs, attrs, slot="Out", dtype=None, helper=None):
    return apply_op(helper or op, op, inputs, attrs, [slot],
                    out_dtype=dtype)[0]


def _n(v, n):
    return [v] * n if isinstance(v, int) else list(v)


# -- interpolation ------------------------------------------------------------

_RESAMPLE_OP = {"NEAREST": "nearest_interp", "BILINEAR": "bilinear_interp",
                "TRILINEAR": "trilinear_interp", "BICUBIC": "bicubic_interp",
                "LINEAR": "linear_interp"}


def interpolate(input, out_shape=None, scale=None, name=None,
                resample="BILINEAR", actual_shape=None, align_corners=True,
                align_mode=1, data_format="NCHW"):
    """The `*_interp` op of `resample`, its output size static: from
    `out_shape` (or `actual_shape`; a list or an array, read here), else
    from `scale`."""
    op_type = _RESAMPLE_OP[resample.upper()]
    attrs = {"align_corners": align_corners, "align_mode": align_mode,
             "data_layout": data_format}
    shape = out_shape if out_shape is not None else actual_shape
    if shape is not None:
        dims = [int(d) for d in (
            shape.tolist() if hasattr(shape, "tolist") else shape)]
        keys = {1: ["out_w"], 2: ["out_h", "out_w"],
                3: ["out_d", "out_h", "out_w"]}[len(dims)]
        attrs.update(zip(keys, dims))
    elif scale is not None:
        attrs["scale"] = float(scale)
    else:
        raise ValueError("interpolate needs out_shape or scale")
    return _one(op_type, {"X": [input]}, attrs)


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    actual_shape=None, align_corners=True, align_mode=1,
                    data_format="NCHW"):
    return interpolate(input, out_shape, scale, name, "BILINEAR",
                       actual_shape, align_corners, align_mode, data_format)


def resize_trilinear(input, out_shape=None, scale=None, name=None,
                     actual_shape=None, align_corners=True, align_mode=1,
                     data_format="NCDHW"):
    return interpolate(input, out_shape, scale, name, "TRILINEAR",
                       actual_shape, align_corners, align_mode, data_format)


def resize_linear(input, out_shape=None, scale=None, name=None,
                  align_corners=True, align_mode=1, data_format="NCW"):
    return interpolate(input, out_shape, scale, name, "LINEAR", None,
                       align_corners, align_mode, data_format)


def resize_bicubic(input, out_shape=None, scale=None, name=None,
                   align_corners=True, data_format="NCHW"):
    return interpolate(input, out_shape, scale, name, "BICUBIC", None,
                       align_corners, 0, data_format)


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """Resizes the shorter spatial side to `out_short_len`, keeping the
    aspect ratio."""
    h, w = input.shape[2], input.shape[3]
    short, long_ = (h, w) if h < w else (w, h)
    ratio = out_short_len / float(short)
    out_shape = ([out_short_len, int(long_ * ratio)] if h < w
                 else [int(long_ * ratio), out_short_len])
    return interpolate(input, out_shape=out_shape, resample=resample)


# -- 3-d convolution and pooling ---------------------------------------------

def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, name=None):
    if global_pooling:
        pool_size, pool_padding = list(input.shape[2:]), 0
    return _one("pool3d", {"X": [input]},
                {"ksize": _n(pool_size, 3), "pooling_type": pool_type,
                 "strides": _n(pool_stride, 3),
                 "paddings": _n(pool_padding, 3)})


def adaptive_pool3d(input, pool_size, pool_type="max", name=None):
    dims = list(input.shape[2:])
    ps = _n(pool_size, 3)
    if any(d % p for d, p in zip(dims, ps)):
        raise ValueError("adaptive_pool3d needs D, H and W divisible by the "
                         "output size, got %s and %s" % (dims, ps))
    k = [d // p for d, p in zip(dims, ps)]
    return _one("pool3d", {"X": [input]},
                {"ksize": k, "pooling_type": pool_type, "strides": k,
                 "paddings": [0, 0, 0]})


def _conv3d(op_type, input, num_filters, filter_size, stride, padding,
            dilation, groups, param_attr, bias_attr, act, name,
            transpose=False):
    helper = LayerHelper(op_type, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    c_in = input.shape[1]
    groups = groups or 1
    w_shape = ([c_in, num_filters // groups] if transpose
               else [num_filters, c_in // groups]) + _n(filter_size, 3)
    w = helper.create_parameter(helper.param_attr, shape=w_shape,
                                dtype=input.dtype)
    out = apply_op(helper, op_type, {"Input": [input], "Filter": [w]},
                   {"strides": _n(stride, 3), "paddings": _n(padding, 3),
                    "dilations": _n(dilation, 3), "groups": groups},
                   ["Output"], out_dtype=input.dtype)[0]
    if helper.bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr, shape=[num_filters],
                                    dtype=input.dtype, is_bias=True)
        out = _one("elementwise_add", {"X": [out], "Y": [b]}, {"axis": 1},
                   dtype=input.dtype, helper=helper)
    return helper.append_activation(out)


def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=None, param_attr=None, bias_attr=None,
           use_cudnn=True, act=None, name=None):
    return _conv3d("conv3d", input, num_filters, filter_size, stride,
                   padding, dilation, groups, param_attr, bias_attr, act,
                   name)


def conv3d_transpose(input, num_filters, output_size=None,
                     filter_size=None, padding=0, stride=1, dilation=1,
                     groups=None, param_attr=None, bias_attr=None,
                     use_cudnn=True, act=None, name=None):
    return _conv3d("conv3d_transpose", input, num_filters, filter_size,
                   stride, padding, dilation, groups, param_attr, bias_attr,
                   act, name, transpose=True)


# -- vision -------------------------------------------------------------------

def grid_sampler(x, grid, name=None):
    return _one("grid_sampler", {"X": [x], "Grid": [grid]}, {}, "Output")


def affine_grid(theta, out_shape=None, name=None):
    attrs = {}
    if out_shape is not None and not isinstance(out_shape,
                                                framework.Variable):
        attrs["output_shape"] = [int(v) for v in out_shape]
    return _one("affine_grid", {"Theta": [theta]}, attrs, "Output")


def affine_channel(x, scale=None, bias=None, data_layout="NCHW",
                   name=None, act=None):
    from .tensor import fill_constant

    c = x.shape[1 if data_layout == "NCHW" else -1]
    if scale is None:
        scale = fill_constant([c], x.dtype, 1.0)
    if bias is None:
        bias = fill_constant([c], x.dtype, 0.0)
    out = _one("affine_channel", {"X": [x], "Scale": [scale],
                                  "Bias": [bias]},
               {"data_layout": data_layout})
    return LayerHelper("affine_channel", act=act).append_activation(out)


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None,
        data_format="NCHW"):
    return _one("lrn", {"X": [input]},
                {"n": n, "k": k, "alpha": alpha, "beta": beta,
                 "data_format": data_format})


def _pads4(paddings):
    pads = _n(paddings, 2)
    return pads + pads if len(pads) == 2 else pads


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    return _one("unfold", {"X": [x]},
                {"kernel_sizes": _n(kernel_sizes, 2),
                 "strides": _n(strides, 2), "paddings": _pads4(paddings),
                 "dilations": _n(dilations, 2)}, "Y")


def space_to_depth(x, blocksize, name=None):
    return _one("space_to_depth", {"X": [x]}, {"blocksize": blocksize})


def shuffle_channel(x, group, name=None):
    return _one("shuffle_channel", {"X": [x]}, {"group": group})


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    return _one("temporal_shift", {"X": [x]},
                {"seg_num": seg_num, "shift_ratio": shift_ratio})


def pixel_shuffle(x, upscale_factor):
    return _one("pixel_shuffle", {"X": [x]},
                {"upscale_factor": upscale_factor})


def maxout(x, groups, name=None, axis=1):
    return _one("maxout", {"X": [x]}, {"groups": groups, "axis": axis})


def row_conv(input, future_context_size, param_attr=None, act=None):
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act)
    w = helper.create_parameter(
        helper.param_attr, shape=[future_context_size + 1, input.shape[-1]],
        dtype=input.dtype)
    out = apply_op(helper, "row_conv", {"X": [input], "Filter": [w]}, {},
                   ["Out"], out_dtype=input.dtype)[0]
    return helper.append_activation(out)


def fsp_matrix(x, y):
    return _one("fsp", {"X": [x], "Y": [y]}, {})


def im2sequence(input, filter_size=1, stride=1, padding=0,
                input_image_size=None, out_stride=1, name=None):
    return _one("im2sequence", {"X": [input]},
                {"kernels": _n(filter_size, 2), "strides": _n(stride, 2),
                 "paddings": _pads4(padding)})


# -- recurrent units --------------------------------------------------------

def _lstm_state_ins(ins, h_0, c_0):
    if h_0 is not None:
        ins["H0"] = [h_0]
    if c_0 is not None:
        ins["C0"] = [c_0]
    return ins


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """The `lstm` op over the projected input [B, T, size] (size = 4D):
    creates Weight [D, 4D] and Bias [1, 7D] (peepholes) or [1, 4D];
    returns (hidden, cell), each [B, T, D]."""
    helper = LayerHelper("lstm", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    d = size // 4
    w = helper.create_parameter(helper.param_attr, shape=[d, 4 * d],
                                dtype=dtype)
    b = helper.create_parameter(
        helper.bias_attr, shape=[1, (7 if use_peepholes else 4) * d],
        dtype=dtype, is_bias=True)
    outs = apply_op(helper, "lstm", _lstm_state_ins(
        {"Input": [input], "Weight": [w], "Bias": [b]}, h_0, c_0),
        {"use_peepholes": use_peepholes, "is_reverse": is_reverse,
         "gate_activation": gate_activation,
         "cell_activation": cell_activation,
         "candidate_activation": candidate_activation},
        ["Hidden", "Cell"], out_dtype=dtype)
    return outs[0], outs[1]


def dynamic_lstmp(input, size, proj_size, h_0=None, c_0=None,
                  param_attr=None, bias_attr=None, use_peepholes=True,
                  is_reverse=False, gate_activation="sigmoid",
                  cell_activation="tanh", candidate_activation="tanh",
                  proj_activation="tanh", dtype="float32", name=None):
    """The `lstmp` op: `dynamic_lstm` with a recurrent projection to
    `proj_size`; returns (projection, cell)."""
    helper = LayerHelper("lstmp", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    d = size // 4
    w = helper.create_parameter(helper.param_attr,
                                shape=[proj_size, 4 * d], dtype=dtype)
    w_proj = helper.create_parameter(helper.param_attr,
                                     shape=[d, proj_size], dtype=dtype)
    b = helper.create_parameter(
        helper.bias_attr, shape=[1, (7 if use_peepholes else 4) * d],
        dtype=dtype, is_bias=True)
    outs = apply_op(helper, "lstmp", _lstm_state_ins(
        {"Input": [input], "Weight": [w], "ProjWeight": [w_proj],
         "Bias": [b]}, h_0, c_0),
        {"use_peepholes": use_peepholes, "is_reverse": is_reverse,
         "gate_activation": gate_activation,
         "cell_activation": cell_activation,
         "candidate_activation": candidate_activation,
         "proj_activation": proj_activation},
        ["Projection", "Cell"], out_dtype=dtype)
    return outs[0], outs[1]


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, origin_mode=False):
    """The `gru` op over the projected input [B, T, 3 * size]: creates
    Weight [size, 3 * size] and Bias [1, 3 * size]; returns the hidden
    states [B, T, size]."""
    helper = LayerHelper("gru", param_attr=param_attr, bias_attr=bias_attr)
    dtype = input.dtype
    w = helper.create_parameter(helper.param_attr, shape=[size, 3 * size],
                                dtype=dtype)
    b = helper.create_parameter(helper.bias_attr, shape=[1, 3 * size],
                                dtype=dtype, is_bias=True)
    ins = {"Input": [input], "Weight": [w], "Bias": [b]}
    if h_0 is not None:
        ins["H0"] = [h_0]
    return apply_op(helper, "gru", ins,
                    {"is_reverse": is_reverse,
                     "gate_activation": gate_activation,
                     "activation": candidate_activation,
                     "origin_mode": origin_mode},
                    ["Hidden", "BatchGate", "BatchResetHiddenPrev",
                     "BatchHidden"], out_dtype=dtype)[0]


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False):
    """One `gru_unit` step (size = 3D); returns (hidden, reset hidden
    prev, gate)."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr)
    dtype = input.dtype
    d = size // 3
    w = helper.create_parameter(helper.param_attr, shape=[d, 3 * d],
                                dtype=dtype)
    b = helper.create_parameter(helper.bias_attr, shape=[1, 3 * d],
                                dtype=dtype, is_bias=True)
    outs = apply_op(helper, "gru_unit",
                    {"Input": [input], "HiddenPrev": [hidden],
                     "Weight": [w], "Bias": [b]},
                    {"activation": activation,
                     "gate_activation": gate_activation,
                     "origin_mode": origin_mode},
                    ["Hidden", "Gate", "ResetHiddenPrev"], out_dtype=dtype)
    return outs[0], outs[2], outs[1]


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step: fc over [x_t, hidden_t_prev] to 4D gates, then the
    `lstm_unit` op; returns (hidden, cell)."""
    from .nn import fc
    from .tensor import concat

    d = cell_t_prev.shape[-1]
    gates = fc(concat([x_t, hidden_t_prev], axis=1), 4 * d,
               param_attr=param_attr, bias_attr=bias_attr)
    outs = apply_op("lstm_unit", "lstm_unit",
                    {"X": [gates], "C_prev": [cell_t_prev]},
                    {"forget_bias": forget_bias}, ["C", "H"],
                    out_dtype=x_t.dtype)
    return outs[1], outs[0]


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """The `cudnn_lstm` builder over time-major input [T, B, D]: one flat
    weight for every layer and direction; returns (out, last_h,
    last_c)."""
    helper = LayerHelper("cudnn_lstm", name=name)
    n_dir = 2 if is_bidirec else 1
    size, d_cur = 0, input.shape[-1]
    for _ in range(num_layers):
        size += n_dir * (4 * hidden_size * d_cur
                         + 4 * hidden_size * hidden_size + 8 * hidden_size)
        d_cur = hidden_size * n_dir
    w = helper.create_parameter(
        ParamAttr(initializer=default_initializer)
        if default_initializer else None, shape=[size], dtype=input.dtype)
    outs = apply_op(helper, "cudnn_lstm",
                    {"Input": [input], "W": [w], "InitH": [init_h],
                     "InitC": [init_c]},
                    {"hidden_size": hidden_size, "num_layers": num_layers,
                     "is_bidirec": is_bidirec},
                    ["Out", "last_h", "last_c"], out_dtype=input.dtype)
    return outs[0], outs[1], outs[2]


# -- losses -----------------------------------------------------------------

def dice_loss(input, label, epsilon=1e-5):
    return _one("dice_loss", {"X": [input], "Label": [label]},
                {"epsilon": epsilon})


def log_loss(input, label, epsilon=1e-4, name=None):
    return _one("log_loss", {"Predicted": [input], "Labels": [label]},
                {"epsilon": epsilon}, "Loss")


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    return _one("npair_loss", {"Anchor": [anchor], "Positive": [positive],
                               "Labels": [labels]}, {"l2_reg": l2_reg})


def rank_loss(label, left, right, name=None):
    return _one("rank_loss", {"Label": [label], "Left": [left],
                              "Right": [right]}, {})


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    return _one("margin_rank_loss", {"Label": [label], "X1": [left],
                                     "X2": [right]}, {"margin": margin})


def bpr_loss(input, label, name=None):
    return _one("bpr_loss", {"X": [input], "Label": [label]}, {}, "Y")


def center_loss(input, label, num_classes, alpha, param_attr=None,
                update_center=True):
    helper = LayerHelper("center_loss", param_attr=param_attr)
    centers = helper.create_parameter(
        helper.param_attr, shape=[num_classes, input.shape[-1]],
        dtype=input.dtype, default_initializer=ConstantInitializer(0.0))
    return apply_op(helper, "center_loss",
                    {"X": [input], "Label": [label], "Centers": [centers]},
                    {"cluster_num": num_classes, "alpha": alpha,
                     "need_update": update_center},
                    ["Loss", "SampleCenterDiff", "CentersOut"],
                    out_dtype=input.dtype)[0]


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    return _one("teacher_student_sigmoid_loss",
                {"X": [input], "Label": [label]},
                {"soft_max_up_bound": soft_max_up_bound,
                 "soft_max_lower_bound": soft_max_lower_bound}, "Y")


def sigmoid_focal_loss(x, label, fg_num=None, gamma=2.0, alpha=0.25):
    ins = {"X": [x], "Label": [label]}
    if fg_num is not None:
        ins["FgNum"] = [fg_num]
    return _one("sigmoid_focal_loss", ins, {"gamma": gamma, "alpha": alpha})


def cos_sim(X, Y):
    return _one("cos_sim", {"X": [X], "Y": [Y]}, {})


# -- misc -------------------------------------------------------------------

def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """`weight` over its spectral norm, from U [h] and V [w] params
    (Normal) that the op reads and does not update."""
    helper = LayerHelper("spectral_norm", name=name)
    h = weight.shape[dim]
    u = helper.create_parameter(None, shape=[h], dtype=weight.dtype,
                                default_initializer=NormalInitializer())
    v = helper.create_parameter(
        None, shape=[int(np.prod(weight.shape)) // h], dtype=weight.dtype,
        default_initializer=NormalInitializer())
    return apply_op(helper, "spectral_norm",
                    {"Weight": [weight], "U": [u], "V": [v]},
                    {"dim": dim, "power_iters": power_iters, "eps": eps},
                    ["Out"], out_dtype=weight.dtype)[0]


# -- the framework ops' builders ---------------------------------------------

def multiplex(inputs, index):
    return _one("multiplex", {"X": list(inputs), "Ids": [index]}, {})


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """Calls `func` on the values of `x` when the step runs (the host-side
    `py_func` op); `out` gives the number of outputs."""
    from ...ops.framework_ops import register_py_func

    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    got = apply_op("py_func", "py_func", {"X": xs},
                   {"func_id": register_py_func(func)}, {"Out": len(outs)})
    return got if len(got) > 1 else got[0]


# -- builders of types ported earlier -----------------------------------------

def _act_wrapper(op_type, attr_names=()):
    """A builder of `op_type` over X whose positional and keyword
    arguments `attr_names` become attrs."""
    def fn(x, *args, **kwargs):
        attrs = dict(zip(attr_names, args))
        attrs.update((k, v) for k, v in kwargs.items() if k in attr_names)
        return _one(op_type, {"X": [x]}, attrs)
    fn.__name__ = op_type
    return fn


selu = _act_wrapper("selu", ("scale", "alpha"))
softshrink = _act_wrapper("softshrink", ("lambda",))
hard_shrink = _act_wrapper("hard_shrink", ("threshold",))
tanh_shrink = _act_wrapper("tanh_shrink")
brelu = _act_wrapper("brelu", ("t_min", "t_max"))
soft_relu = _act_wrapper("soft_relu", ("threshold",))
thresholded_relu = _act_wrapper("thresholded_relu", ("threshold",))


def pad_constant_like(x, y, pad_value=0.0, name=None):
    return _one("pad_constant_like", {"X": [x], "Y": [y]},
                {"pad_value": pad_value})


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    return _one("shard_index", {"X": [input]},
                {"index_num": index_num, "nshards": nshards,
                 "shard_id": shard_id, "ignore_value": ignore_value},
                dtype="int64")


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    return _one("uniform_random_batch_size_like", {"Input": [input]},
                {"shape": list(shape), "input_dim_idx": input_dim_idx,
                 "output_dim_idx": output_dim_idx, "min": min,
                 "max": max, "seed": seed}, dtype=dtype)


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    return _one("sampling_id", {"X": [x]},
                {"min": min, "max": max, "seed": seed}, dtype="int64")


# -- the detection slice's builders -------------------------------------------

def deformable_conv(input, offset, mask, num_filters, filter_size,
                    stride=1, padding=0, dilation=1, groups=None,
                    deformable_groups=None, im2col_step=None,
                    param_attr=None, bias_attr=None,
                    modulated=True, name=None):
    """`deformable_conv` (modulated, with `mask`) or
    `deformable_conv_v1`; the filter [num_filters, C / groups, kh, kw]
    is a parameter, and no bias is added, as in the reference."""
    helper = LayerHelper("deformable_conv", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    groups = groups or 1
    w = helper.create_parameter(
        helper.param_attr,
        shape=[num_filters, input.shape[1] // groups] + _n(filter_size, 2),
        dtype=input.dtype)
    op = "deformable_conv" if modulated else "deformable_conv_v1"
    ins = {"Input": [input], "Offset": [offset], "Filter": [w]}
    if modulated and mask is not None:
        ins["Mask"] = [mask]
    return apply_op(helper, op, ins,
                    {"strides": _n(stride, 2), "paddings": _n(padding, 2),
                     "dilations": _n(dilation, 2), "groups": groups,
                     "deformable_groups": deformable_groups or 1},
                    ["Output"], out_dtype=input.dtype)[0]


def unpool(input, indices, unpool_size=None, name=None):
    oh, ow = unpool_size if unpool_size else (
        input.shape[2] * 2, input.shape[3] * 2)
    return _one("unpool", {"X": [input], "Indices": [indices]},
                {"unpooled_height": oh, "unpooled_width": ow})


def add_position_encoding(input, alpha, beta, name=None):
    return _one("add_position_encoding", {"X": [input]},
                {"alpha": alpha, "beta": beta})


def similarity_focus(input, axis, indexes, name=None):
    return _one("similarity_focus", {"X": [input]},
                {"axis": axis, "indexes": list(indexes)})


def random_crop(x, shape, seed=None):
    return _one("random_crop", {"X": [x]}, {"shape": list(shape)})


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       num_true=1,
                                       remove_accidental_hits=True,
                                       use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None,
                                       seed=0):
    """The loss [N, 1]; as in the reference, the customized samples are
    not bound (the op draws its own)."""
    outs = apply_op("sampled_softmax_with_cross_entropy",
                    "sampled_softmax_with_cross_entropy",
                    {"Logits": [logits], "Label": [label]},
                    {"num_samples": num_samples,
                     "remove_accidental_hits": remove_accidental_hits,
                     "seed": seed}, ["Loss", "Softmax"])
    return outs[0]


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None, is_custom=False,
             is_sparse=False):
    """Hierarchical sigmoid over the default complete tree; W
    [num_classes - 1, D] and the bias [num_classes - 1] are parameters."""
    helper = LayerHelper("hsigmoid", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dtype = input.dtype
    w = helper.create_parameter(helper.param_attr,
                                shape=[num_classes - 1, input.shape[-1]],
                                dtype=dtype)
    b = helper.create_parameter(helper.bias_attr,
                                shape=[num_classes - 1], dtype=dtype,
                                is_bias=True)
    return apply_op(helper, "hsigmoid",
                    {"X": [input], "W": [w], "Label": [label],
                     "Bias": [b]},
                    {"num_classes": num_classes}, ["Out", "PreOut"],
                    out_dtype=dtype)[0]
