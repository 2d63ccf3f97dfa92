"""Loss layers of the slice (counterpart:
`paddle_tpu/fluid/layers/loss.py`): `softmax_with_cross_entropy` and
`fused_linear_softmax_xent`."""
from __future__ import annotations

from ..layer_helper import LayerHelper, apply_op

__all__ = ["softmax_with_cross_entropy", "fused_linear_softmax_xent"]


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
