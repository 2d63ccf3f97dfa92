"""Operator registry: the compute layer of the static graph (counterpart:
`paddle_tpu/ops/registry.py`).

Every op is ONE torch function `compute(ins, attrs) -> outs`. `ins` maps
an input slot to a list of tensors; the returned dict maps an output slot
to a tensor or a list of them. Two attrs are supplied by the caller, not
by the program: `attrs["_device"]`, the device an op that has no input
tensor creates its output on, and, for an op registered `needs_rng`,
`attrs["_rng_generator"]`, a `torch.Generator` on that device.

Shape/dtype inference runs the same compute function on `meta` tensors
(in place of `jax.eval_shape`), so no per-op InferShape code exists to
keep in sync. Gradients come from `torch.autograd` over the forward
segment (`fluid/lowering.py`), so no per-op grad rules exist either.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.types import normalize_dtype, to_torch_dtype

_REGISTRY: Dict[str, "OpDef"] = {}

# Sentinel dimension used in place of -1 ("any batch") during
# compile-time shape inference; mapped back to -1 in inferred shapes.
_DYN_SENTINEL = 97

_META = torch.device("meta")


class OpDef:
    __slots__ = ("type", "compute", "needs_rng", "infer_shape")

    def __init__(self, type_: str, compute: Callable, needs_rng: bool = False,
                 infer_shape: Optional[Callable] = None):
        self.type = type_
        self.compute = compute
        self.needs_rng = needs_rng
        self.infer_shape = infer_shape


def register_op(type_: str, needs_rng: bool = False,
                infer_shape: Optional[Callable] = None):
    """Decorator: register `compute(ins, attrs) -> {slot: [tensor, ...]}`
    (see the module docstring for `ins` and the supplied attrs)."""

    def deco(fn):
        _REGISTRY[type_] = OpDef(type_, fn, needs_rng=needs_rng,
                                 infer_shape=infer_shape)
        return fn

    return deco


def get_op(type_: str) -> OpDef:
    try:
        return _REGISTRY[type_]
    except KeyError:
        raise NotImplementedError(
            "op %r is not registered in paddle_tpu_torch.ops (have %d ops)"
            % (type_, len(_REGISTRY))) from None


def has_op(type_: str) -> bool:
    return type_ in _REGISTRY


def registered_ops() -> List[str]:
    return sorted(_REGISTRY)


def normalize_outs(outs) -> Dict[str, list]:
    return {slot: list(v) if isinstance(v, (list, tuple)) else [v]
            for slot, v in outs.items()}


def run_op(type_: str, ins: Dict[str, list], attrs: dict) -> Dict[str, list]:
    """Execute an op's compute function. Without `_device`, the op runs
    on its first input's device; a random op without a generator gets a
    fresh one."""
    op = get_op(type_)
    attrs = dict(attrs)
    if "_device" not in attrs:
        first = next((v for vs in ins.values() for v in vs), None)
        if first is None:
            raise ValueError("op %r has no input tensor: pass "
                             "attrs['_device']" % type_)
        attrs["_device"] = first.device
    if op.needs_rng and "_rng_generator" not in attrs:
        g = torch.Generator(device=attrs["_device"])
        g.manual_seed(int(np.random.randint(0, 2**31 - 1)))
        attrs["_rng_generator"] = g
    return normalize_outs(op.compute(ins, attrs))


# ---------------------------------------------------------------------------
# Compile-time shape/dtype inference on meta tensors.
# ---------------------------------------------------------------------------

def infer_outputs(type_: str, input_specs: Dict[str, list], attrs: dict):
    """input_specs: slot -> list of (shape_tuple_with_-1, dtype_str).

    Returns slot -> list of (shape_tuple_with_-1, dtype_str).
    """
    op = get_op(type_)
    if op.infer_shape is not None:
        return op.infer_shape(input_specs, attrs)

    dynamic = False

    def to_meta(spec):
        nonlocal dynamic
        shape, dtype = spec
        concrete = []
        for d in shape:
            if d is None or d < 0:
                concrete.append(_DYN_SENTINEL)
                dynamic = True
            else:
                concrete.append(int(d))
        return torch.empty(concrete, dtype=to_torch_dtype(dtype),
                           device=_META)

    meta_ins = {slot: [to_meta(s) for s in specs]
                for slot, specs in input_specs.items()}
    run_attrs = dict(attrs, _device=_META)
    if op.needs_rng:
        run_attrs["_rng_generator"] = None  # meta tensors draw nothing
    outs = normalize_outs(op.compute(meta_ins, run_attrs))
    return {
        slot: [(tuple(-1 if (dynamic and d == _DYN_SENTINEL) else int(d)
                      for d in t.shape), normalize_dtype(t.dtype))
               for t in ts]
        for slot, ts in outs.items()}
