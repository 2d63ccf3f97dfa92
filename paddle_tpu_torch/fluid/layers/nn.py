"""Neural-network layers of the slice (counterpart:
`paddle_tpu/fluid/layers/nn.py`): `fc`, `softmax`, `mean`, `accuracy`
and `topk`. Each builder creates its params through LayerHelper (init ops
go to the startup program) and appends its compute op."""
from __future__ import annotations

import numpy as np

from ..layer_helper import LayerHelper, apply_op

__all__ = ["fc", "softmax", "mean", "accuracy", "topk"]


def _single(op_type, inputs, attrs, dtype=None, helper=None):
    return apply_op(helper or op_type, op_type, inputs, attrs, ["Out"],
                    out_dtype=dtype)[0]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully-connected (reference: layers/nn.py fc) = mul + bias + act.
    One input only: several inputs are summed by the `sum` op, which is
    not ported yet."""
    if isinstance(input, (list, tuple)):
        if len(input) != 1:
            raise NotImplementedError(
                "fc over several inputs needs the sum op, not ported yet")
        input = input[0]
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    w_attr = helper.param_attr
    if isinstance(w_attr, list):
        w_attr = w_attr[0]
    in_dim = int(np.prod(input.shape[num_flatten_dims:]))
    w = helper.create_parameter(w_attr, shape=[in_dim, size],
                                dtype=input.dtype)
    pre_bias = _single("mul", {"X": [input], "Y": [w]},
                       {"x_num_col_dims": num_flatten_dims,
                        "y_num_col_dims": 1}, dtype=input.dtype,
                       helper=helper)
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


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
