"""Weight decay regularizers (counterpart:
`paddle_tpu/fluid/regularizer.py`): each appends, after the backward
section, the ops that add its decay term to a parameter's gradient,
rebinding the gradient's name."""
from __future__ import annotations

from .framework import unique_name


class WeightDecayRegularizer:
    def _append(self, block, param, grad):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """grad += coeff * param."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _append(self, block, param, grad):
        tmp = block.create_var(name=unique_name("l2_decay"),
                               shape=param.shape, dtype=param.dtype)
        block.append_op(type="scale", inputs={"X": [param]},
                        outputs={"Out": [tmp]},
                        attrs={"scale": self._coeff, "bias": 0.0,
                               "bias_after_scale": True})
        block.append_op(type="elementwise_add",
                        inputs={"X": [grad], "Y": [tmp]},
                        outputs={"Out": [grad]}, attrs={"axis": -1})
        return grad


class L1DecayRegularizer(WeightDecayRegularizer):
    """grad += coeff * sign(param)."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _append(self, block, param, grad):
        sign = block.create_var(name=unique_name("l1_sign"),
                                shape=param.shape, dtype=param.dtype)
        block.append_op(type="sign", inputs={"X": [param]},
                        outputs={"Out": [sign]})
        block.append_op(type="scale", inputs={"X": [sign]},
                        outputs={"Out": [sign]},
                        attrs={"scale": self._coeff, "bias": 0.0,
                               "bias_after_scale": True})
        block.append_op(type="elementwise_add",
                        inputs={"X": [grad], "Y": [sign]},
                        outputs={"Out": [grad]}, attrs={"axis": -1})
        return grad


def append_regularization_ops(params_grads, regularization=None):
    """Append each parameter's decay ops (its own ParamAttr regularizer,
    else `regularization`); returns `params_grads` unchanged."""
    for p, g in params_grads:
        reg = getattr(p, "regularizer", None) or regularization
        if reg is not None and g is not None:
            reg._append(g.block, p, g)
    return list(params_grads)


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
