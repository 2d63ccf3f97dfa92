"""Loss layers (counterpart: `paddle_tpu/fluid/layers/loss.py`):
`cross_entropy` (of probabilities), `softmax_with_cross_entropy`,
`sigmoid_cross_entropy_with_logits`, `square_error_cost`, `mse_loss`,
`huber_loss`, `smooth_l1`, `kldiv_loss` and `fused_linear_softmax_xent`."""
from __future__ import annotations

from ..layer_helper import LayerHelper, apply_op

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "square_error_cost", "huber_loss",
    "smooth_l1", "kldiv_loss", "mse_loss", "fused_linear_softmax_xent",
]


def _loss(op_type, inputs, attrs, outs, dtype):
    return apply_op(op_type, op_type, inputs, attrs, outs,
                    out_dtype=dtype)[0]


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """-log(input[label] + 1e-9) of probabilities `input` ([..., 1]), 0
    for `ignore_index`; soft labels sum over the classes."""
    return _loss("cross_entropy", {"X": [input], "Label": [label]},
                 {"soft_label": soft_label, "ignore_index": ignore_index},
                 ["Y"], input.dtype)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    outs = apply_op("softmax_with_cross_entropy",
                    "softmax_with_cross_entropy",
                    {"Logits": [logits], "Label": [label]},
                    {"soft_label": soft_label, "ignore_index": ignore_index,
                     "axis": axis},
                    ["Softmax", "Loss"], out_dtype=logits.dtype)
    softmax, loss = outs[0], outs[1]
    if return_softmax:
        return loss, softmax
    return loss


def fused_linear_softmax_xent(input, label, size, param_attr=None,
                              bias_attr=None, chunk_size=8192, name=None):
    """A classifier projection to `size` classes fused with softmax
    cross-entropy: creates the [H, size] weight (and a [size] bias unless
    `bias_attr` is False) and returns the float32 per-example loss
    [..., 1] without the [N, size] logits (`fused_linear_softmax_xent`
    op, streamed over vocab chunks of `chunk_size`)."""
    helper = LayerHelper("fused_linear_softmax_xent", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    in_dim = int(input.shape[-1])
    w = helper.create_parameter(helper.param_attr, shape=[in_dim, size],
                                dtype=input.dtype)
    inputs = {"X": [input], "W": [w], "Label": [label]}
    if helper.bias_attr is not False and helper.bias_attr is not None:
        inputs["Bias"] = [helper.create_parameter(
            helper.bias_attr, shape=[size], dtype=input.dtype,
            is_bias=True)]
    return apply_op(helper, "fused_linear_softmax_xent", inputs,
                    {"chunk_size": int(chunk_size)}, ["Loss"],
                    out_dtype="float32")[0]


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      name=None, normalize=False):
    return _loss("sigmoid_cross_entropy_with_logits",
                 {"X": [x], "Label": [label]},
                 {"ignore_index": ignore_index, "normalize": normalize},
                 ["Out"], x.dtype)


def square_error_cost(input, label):
    return _loss("square_error_cost", {"X": [input], "Y": [label]}, {},
                 ["Out"], input.dtype)


def mse_loss(input, label):
    from . import nn

    return nn.reduce_mean(square_error_cost(input, label))


def huber_loss(input, label, delta):
    return _loss("huber_loss", {"X": [input], "Y": [label]},
                 {"delta": float(delta)}, ["Out", "Residual"], input.dtype)


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    """The smooth L1 loss summed over the last axis (the weights are not
    read, as in the reference)."""
    return _loss("smooth_l1_loss", {"X": [x], "Y": [y]},
                 {"sigma": sigma or 1.0}, ["Out", "Diff"], x.dtype)


def kldiv_loss(x, target, reduction="mean", name=None):
    return _loss("kldiv_loss", {"X": [x], "Target": [target]},
                 {"reduction": reduction}, ["Loss"], x.dtype)
