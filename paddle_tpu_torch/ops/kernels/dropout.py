"""Dropout: the Hopper kernel's wrapper and its plain PyTorch version.

The reference's dropout op (`paddle_tpu/ops/nn_ops.py` `_dropout`) draws
a Bernoulli keep mask from its traced key and XLA fuses it with the
multiply. Here ``csrc/dropout.cu`` does it in one pass: it reads x, draws
each element's keep decision from `core/rng.py keep_hash` of the op seed
(an int64 on the device, read by the kernel through a pointer) and the
element's index, and writes Out and the uint8 Mask. The plain version
computes the same hash with torch integer ops (several passes over the
tensor) and the same products, so its Mask equals the kernel's exactly
and its Out within one rounding of the multiply.

Semantics on x (any shape, float32, bfloat16 or float16): kept elements
are ``x * scale`` with ``scale = float32(1 / (1 - p))`` when `upscale`
(Paddle's ``upscale_in_train``), else x itself
(``downgrade_in_infer``); dropped elements are 0. `dropout` is
differentiable in x: the gradient is the incoming one masked and scaled
the same way.

``impl="auto"`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; ``"kernel"`` raises on the CPU; ``"reference"``
runs the plain version anywhere. ``dropout.launches`` counts kernel
launches, ``dropout.dtype_launches`` them by dtype name.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...core.rng import keep_mask, keep_threshold

__all__ = ["dropout", "dropout_reference", "dropout_scale"]

#: x dtype -> the kernel's dtype argument
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def dropout_scale(p: float) -> float:
    """float32(1 / (1 - p)), the factor kept elements are scaled by (as
    PyTorch on the card divides by a scalar: a multiply by its float32
    reciprocal)."""
    return float(np.float32(1.0) / np.float32(1.0 - float(p)))


def dropout_reference(x, seed, p, upscale=True):
    """Plain version: ``(out, mask)`` with mask uint8 of x's shape."""
    keep = keep_mask(seed, x.shape, p)
    kept = x * dropout_scale(p) if upscale else x
    out = torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                              device=x.device))
    return out, keep.to(torch.uint8)


def _kernel_lib():
    from . import _build

    lib = _build.load("dropout")
    if lib.dropout_forward.argtypes is None:
        ptr = ctypes.c_void_p
        lib.dropout_forward.argtypes = [
            ctypes.c_int, ptr, ptr, ptr, ctypes.c_longlong, ptr,
            ctypes.c_uint32, ctypes.c_float, ctypes.c_int, ptr]
        lib.dropout_forward.restype = ctypes.c_int
    return lib


def _launch(x, seed, p, upscale, want_mask):
    kind = _DTYPES.get(x.dtype)
    if kind is None:
        raise TypeError("the dropout kernel takes float32, bfloat16 or "
                        "float16, got %s" % x.dtype)
    if seed.device != x.device or seed.dtype != torch.int64 \
            or seed.numel() != 1:
        raise ValueError("seed must be one int64 on %s, got %s %s on %s"
                         % (x.device, tuple(seed.shape), seed.dtype,
                            seed.device))
    x = x.contiguous()
    out = torch.empty_like(x)
    mask = torch.empty(x.shape, dtype=torch.uint8, device=x.device) \
        if want_mask else None
    rc = _kernel_lib().dropout_forward(
        kind, x.data_ptr(), out.data_ptr(),
        None if mask is None else mask.data_ptr(), x.numel(),
        seed.data_ptr(), keep_threshold(p), dropout_scale(p), int(upscale),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("dropout kernel launch failed: CUDA error %d"
                           % rc)
    dropout.launches += 1
    name = str(x.dtype).replace("torch.", "")
    dropout.dtype_launches[name] = dropout.dtype_launches.get(name, 0) + 1
    return out, mask


def _forward(x, seed, p, upscale, impl, want_mask=True):
    if impl not in ("auto", "kernel", "reference"):
        raise ValueError("impl must be auto|kernel|reference, got %r"
                         % (impl,))
    on_card = x.device.type == "cuda"
    if impl == "reference" or (impl == "auto" and not on_card):
        return dropout_reference(x, seed, p, upscale)
    if not on_card:
        raise ValueError("impl='kernel' needs CUDA tensors, x is on %s"
                         % (x.device,))
    return _launch(x, seed, p, upscale, want_mask)


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, p, upscale, impl):
        out, mask = _forward(x, seed, p, upscale, impl)
        ctx.save_for_backward(mask)
        ctx.mark_non_differentiable(mask)
        ctx.settings = (p, upscale)
        return out, mask

    @staticmethod
    def backward(ctx, g, _gmask):
        mask, = ctx.saved_tensors
        p, upscale = ctx.settings
        kept = g * dropout_scale(p) if upscale else g
        return (torch.where(mask.bool(), kept,
                            torch.zeros((), dtype=g.dtype, device=g.device)),
                None, None, None, None)


def dropout(x, seed, p, upscale=True, impl="auto"):
    """Dropout of x with keep probability 1 - p under op seed `seed` (an
    int64 tensor of one element on x's device). Returns ``(out, mask)``,
    mask uint8 (1 = kept); differentiable in x."""
    p = float(p)
    if not 0.0 <= p < 1.0:
        raise ValueError("p must be in [0, 1): %r" % p)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Dropout.apply(x, seed, p, bool(upscale), impl)
    return _forward(x, seed, p, bool(upscale), impl)


dropout.launches = 0
dropout.dtype_launches = {}
