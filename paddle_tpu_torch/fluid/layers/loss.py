"""Loss layers of the slice (counterpart:
`paddle_tpu/fluid/layers/loss.py`): `softmax_with_cross_entropy`."""
from __future__ import annotations

from ..layer_helper import apply_op

__all__ = ["softmax_with_cross_entropy"]


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
