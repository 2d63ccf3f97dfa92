"""Gradient clipping (counterpart: `paddle_tpu/fluid/clip.py`; reference:
`python/paddle/fluid/clip.py`), for the static graph.

Each clip attr takes the (param, grad) pairs the backward produced and
appends ops after it that rewrite each gradient in place (the op's Out
is its grad var): `GradientClipByValue` a `clip` op a gradient,
`GradientClipByNorm` a `clip_by_norm`, and `GradientClipByGlobalNorm`
one `squared_l2_norm` a gradient, their `sum`, its `sqrt` (the global
norm, a var that can be fetched), the scale clip / max(norm, clip) and
an `elementwise_mul` a gradient. An optimizer's ``grad_clip`` applies
its attr; without one, `set_gradient_clip`'s default or each param's
``gradient_clip_attr`` (`append_gradient_clip_ops`). Under the sharded
update these ops run on the gradient shards, the norms as sums of the
shards' partial sums (`parallel/sharded_update.py`).
"""
from __future__ import annotations

from .framework import unique_name

__all__ = ["BaseGradientClipAttr", "GradientClipByValue",
           "GradientClipByNorm", "GradientClipByGlobalNorm",
           "ErrorClipByValue", "set_gradient_clip",
           "append_gradient_clip_ops"]


class BaseGradientClipAttr:
    def __call__(self, params_grads):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClipAttr):
    """Each gradient clamped to [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        for _, g in params_grads:
            if g is not None:
                g.block.append_op(type="clip", inputs={"X": [g]},
                                  outputs={"Out": [g]},
                                  attrs={"min": self.min, "max": self.max})
        return list(params_grads)


class GradientClipByNorm(BaseGradientClipAttr):
    """Each gradient scaled down to L2 norm `clip_norm` where it exceeds
    it."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        for _, g in params_grads:
            if g is not None:
                g.block.append_op(type="clip_by_norm", inputs={"X": [g]},
                                  outputs={"Out": [g]},
                                  attrs={"max_norm": self.clip_norm})
        return list(params_grads)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Every gradient times clip_norm / max(global norm, clip_norm), the
    global norm taken over all of them."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def __call__(self, params_grads):
        from .layers import tensor

        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        block = grads[0].block

        def var(stem):
            return block.create_var(name=unique_name(stem), shape=(1,),
                                    dtype="float32")

        sq_sums = []
        for g in grads:
            sq = var("gsq")
            block.append_op(type="squared_l2_norm", inputs={"X": [g]},
                            outputs={"Out": [sq]})
            sq_sums.append(sq)
        total = var("global_norm_sq")
        block.append_op(type="sum", inputs={"X": sq_sums},
                        outputs={"Out": [total]})
        gnorm = var("global_norm")
        block.append_op(type="sqrt", inputs={"X": [total]},
                        outputs={"Out": [gnorm]})
        clip_var = tensor.fill_constant([1], "float32", self.clip_norm)
        maxed = var("gn_max")
        block.append_op(type="elementwise_max",
                        inputs={"X": [gnorm], "Y": [clip_var]},
                        outputs={"Out": [maxed]}, attrs={"axis": -1})
        scale = var("gn_scale")
        block.append_op(type="elementwise_div",
                        inputs={"X": [clip_var], "Y": [maxed]},
                        outputs={"Out": [scale]}, attrs={"axis": -1})
        for g in grads:
            block.append_op(type="elementwise_mul",
                            inputs={"X": [g], "Y": [scale]},
                            outputs={"Out": [g]}, attrs={"axis": -1})
        return params_grads


_clip_attr = {}


def set_gradient_clip(clip, param_list=None, program=None):
    """The default clip attr of every later `minimize` without its own
    ``grad_clip`` (the reference's: `param_list` and `program` are not
    read)."""
    _clip_attr["default"] = clip


def append_gradient_clip_ops(params_grads):
    """The default clip attr over all pairs, else each param's own
    ``gradient_clip_attr`` over its pair."""
    clip = _clip_attr.get("default")
    if clip is not None:
        return clip(params_grads)
    if not any(getattr(p, "gradient_clip_attr", None) is not None
               for p, _ in params_grads):
        return params_grads
    out = []
    for p, g in params_grads:
        attr = getattr(p, "gradient_clip_attr", None)
        if attr is not None and g is not None:
            out.extend(attr([(p, g)]))
        else:
            out.append((p, g))
    return out


ErrorClipByValue = GradientClipByValue
