"""Operator registry: the compute layer of the static graph (counterpart:
`paddle_tpu/ops/registry.py`).

Every op is ONE torch function `compute(ins, attrs) -> outs`. `ins` maps
an input slot to a list of tensors; the returned dict maps an output slot
to a tensor or a list of them. Attrs supplied by the caller, not by the
program: `attrs["_device"]`, the device an op that has no input tensor
creates its output on; for an op registered ``rng="device"`` (dropout,
attention), `attrs["_rng_seed"]`, its op seed as an int64 tensor on that
device (`core/rng.py`: the step's seed folded with the op index there,
never read on the host); for one registered ``rng="host"`` (the
initializers), `attrs["_rng_generator"]`, a `torch.Generator` seeded on
the host.

Two flags mirror the reference's: `no_jit` (a host-side op) and
`dynamic_shape` (the output's shape depends on input values). A block
holding either, or a ``rng="host"`` op, is never captured as a CUDA graph
(`fluid/lowering.py capture_blocker`). No ported op sets either flag yet.

Shape/dtype inference runs the same compute function on `meta` tensors
(in place of `jax.eval_shape`), so no per-op InferShape code exists to
keep in sync. Gradients come from `torch.autograd` over the forward
segment (`fluid/lowering.py`), so no per-op grad rules exist either.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.rng import seed_tensor
from ..core.types import normalize_dtype, to_torch_dtype

_REGISTRY: Dict[str, "OpDef"] = {}

# Sentinel dimension used in place of -1 ("any batch") during
# compile-time shape inference; mapped back to -1 in inferred shapes.
_DYN_SENTINEL = 97

_META = torch.device("meta")


_RNG_KINDS = (None, "device", "host")


class OpDef:
    __slots__ = ("type", "compute", "rng", "infer_shape", "no_jit",
                 "dynamic_shape")

    def __init__(self, type_: str, compute: Callable,
                 rng: Optional[str] = None,
                 infer_shape: Optional[Callable] = None,
                 no_jit: bool = False, dynamic_shape: bool = False):
        if rng not in _RNG_KINDS:
            raise ValueError("rng must be one of %s, got %r"
                             % (_RNG_KINDS, rng))
        self.type = type_
        self.compute = compute
        self.rng = rng
        self.infer_shape = infer_shape
        # a host-side op (the reference lowers it via pure_callback)
        self.no_jit = no_jit
        # the output SHAPE depends on input VALUES
        self.dynamic_shape = dynamic_shape


def register_op(type_: str, rng: Optional[str] = None,
                infer_shape: Optional[Callable] = None,
                no_jit: bool = False, dynamic_shape: bool = False):
    """Decorator: register `compute(ins, attrs) -> {slot: [tensor, ...]}`
    (see the module docstring for `ins`, the supplied attrs and the
    flags)."""

    def deco(fn):
        _REGISTRY[type_] = OpDef(type_, fn, rng=rng,
                                 infer_shape=infer_shape, no_jit=no_jit,
                                 dynamic_shape=dynamic_shape)
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


def meta_rng_attrs() -> dict:
    """The random attrs of a run on meta tensors (which draw nothing)."""
    return {"_rng_generator": None,
            "_rng_seed": torch.zeros((), dtype=torch.int64, device=_META)}


def normalize_outs(outs) -> Dict[str, list]:
    return {slot: list(v) if isinstance(v, (list, tuple)) else [v]
            for slot, v in outs.items()}


def run_op(type_: str, ins: Dict[str, list], attrs: dict) -> Dict[str, list]:
    """Execute an op's compute function. Without `_device`, the op runs
    on its first input's device; a random op without its seed or
    generator gets a fresh one."""
    op = get_op(type_)
    attrs = dict(attrs)
    if "_device" not in attrs:
        first = next((v for vs in ins.values() for v in vs), None)
        if first is None:
            raise ValueError("op %r has no input tensor: pass "
                             "attrs['_device']" % type_)
        attrs["_device"] = first.device
    if op.rng == "device" and "_rng_seed" not in attrs:
        attrs["_rng_seed"] = seed_tensor(
            int(np.random.randint(0, 2**31 - 1)) << 32, attrs["_device"])
    if op.rng == "host" and "_rng_generator" not in attrs:
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
    run_attrs.update(meta_rng_attrs())
    outs = normalize_outs(op.compute(meta_ins, run_attrs))
    return {
        slot: [(tuple(-1 if (dynamic and d == _DYN_SENTINEL) else int(d)
                      for d in t.shape), normalize_dtype(t.dtype))
               for t in ts]
        for slot, ts in outs.items()}
