"""Dtype system: VarType names <-> numpy and torch dtypes (counterpart:
`paddle_tpu/core/types.py`).

A program's vars keep the dtype they were declared with ("int64" for a
label). On the device a var holds `to_torch_dtype` of it: 64-bit types
narrowed to 32 bits, as the reference holds them with JAX's x64 mode off
(an int64 label feed reaches its ops as int32, and an op asked for int64
gives int32).
"""
from __future__ import annotations

import sys

import numpy as np
import torch


def _bf16_numpy():
    """numpy's bfloat16 dtype where the process has one: the port never
    imports `ml_dtypes`, but a process that did (JAX imports it) hands
    bfloat16 arrays across, and those are taken and given back bit for
    bit. None where it has none."""
    ml = sys.modules.get("ml_dtypes")
    return np.dtype(ml.bfloat16) if ml is not None else None


def is_bf16_array(arr) -> bool:
    """Whether `arr` is a numpy array of bfloat16 (an ``ml_dtypes``
    dtype, recognised by its name)."""
    return isinstance(arr, np.ndarray) and arr.dtype.name == "bfloat16"

# Canonical string names used throughout the framework.
_STR_TO_NP = {
    "bool": np.dtype("bool"),
    "int8": np.dtype("int8"),
    "uint8": np.dtype("uint8"),
    "int16": np.dtype("int16"),
    "int32": np.dtype("int32"),
    "int64": np.dtype("int64"),
    "float16": np.dtype("float16"),
    "bfloat16": None,  # `_bf16_numpy()` where there is one
    "float32": np.dtype("float32"),
    "float64": np.dtype("float64"),
    "complex64": np.dtype("complex64"),
    "complex128": np.dtype("complex128"),
}

# framework.proto VarType.Type integer codes
_STR_TO_PROTO = {
    "bool": 0,
    "int16": 1,
    "int32": 2,
    "int64": 3,
    "float16": 4,
    "float32": 5,
    "float64": 6,
    "int8": 21,
    "uint8": 20,
    "bfloat16": 22,
    "complex64": 23,
    "complex128": 24,
}
_PROTO_TO_STR = {v: k for k, v in _STR_TO_PROTO.items()}

# the dtype a var of each type holds on the device (x64 off)
_STR_TO_TORCH = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float32,
    "complex64": torch.complex64,
    "complex128": torch.complex64,
}
_TORCH_TO_STR = {
    torch.bool: "bool", torch.int8: "int8", torch.uint8: "uint8",
    torch.int16: "int16", torch.int32: "int32", torch.int64: "int64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.float32: "float32", torch.float64: "float64",
    torch.complex64: "complex64", torch.complex128: "complex128",
}


class VarDesc:
    class VarType:
        BOOL = 0
        INT16 = 1
        INT32 = 2
        INT64 = 3
        FP16 = 4
        FP32 = 5
        FP64 = 6
        UINT8 = 20
        INT8 = 21
        BF16 = 22
        COMPLEX64 = 23
        COMPLEX128 = 24
        # container kinds
        LOD_TENSOR = 7
        SELECTED_ROWS = 8
        FEED_MINIBATCH = 9
        FETCH_LIST = 10
        STEP_SCOPES = 11
        LOD_RANK_TABLE = 12
        LOD_TENSOR_ARRAY = 13
        RAW = 17


def normalize_dtype(dtype) -> str:
    """Accept str / numpy dtype / torch dtype / VarType int -> canonical
    str."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, str):
        s = {"float": "float32", "double": "float64", "int": "int32",
             "half": "float16", "long": "int64"}.get(dtype, dtype)
        if s not in _STR_TO_NP:
            raise ValueError("unknown dtype %r" % (dtype,))
        return s
    if isinstance(dtype, torch.dtype):
        if dtype not in _TORCH_TO_STR:
            raise ValueError("unsupported dtype %r" % (dtype,))
        return _TORCH_TO_STR[dtype]
    if isinstance(dtype, int):
        return _PROTO_TO_STR[dtype]
    npdt = np.dtype(dtype)
    name = npdt.name
    if name == "bfloat16":
        return name
    if name not in _STR_TO_NP:
        raise ValueError("unsupported dtype %r" % (dtype,))
    return name


def to_numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of `dtype`; bfloat16 is ``ml_dtypes``' where the
    process has loaded it, else float32 (which holds every bfloat16
    value)."""
    name = normalize_dtype(dtype)
    if name == "bfloat16":
        return _bf16_numpy() or np.dtype("float32")
    return _STR_TO_NP[name]


def from_numpy(arr, device) -> torch.Tensor:
    """A numpy array as a new tensor on `device`, in the dtype a var of
    its dtype holds there. A bfloat16 array (``ml_dtypes.bfloat16``, what
    JAX hands back) crosses bit for bit through an int16 view, never
    through float32."""
    arr = np.asarray(arr)
    if is_bf16_array(arr):
        return torch.tensor(arr.view(np.int16), device=device).view(
            torch.bfloat16)
    return torch.tensor(arr, dtype=to_torch_dtype(arr.dtype), device=device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bfloat16 as ``ml_dtypes.bfloat16``,
    bit for bit, where the process has loaded ``ml_dtypes``, else as
    float32 (numpy has no bfloat16; float32 holds every bfloat16 value
    exactly)."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bf16 = _bf16_numpy()
    if bf16 is None:
        return t.float().numpy()
    return t.view(torch.int16).numpy().view(bf16)


def to_torch_dtype(dtype) -> torch.dtype:
    """The torch dtype a var of `dtype` holds on the device (64-bit types
    narrowed to 32 bits, see the module docstring)."""
    return _STR_TO_TORCH[normalize_dtype(dtype)]


