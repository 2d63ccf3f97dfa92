"""Framework operators (counterpart: `paddle_tpu/ops/framework_ops.py`):
the checkpoint ops `save`, `load`, `save_combine`, `load_combine`; the
debugging ops `print` and `assert`; `py_func`; the tensor-array aliases
`write_to_array` and `read_from_array`; the routing ops `multiplex`,
`select_input`, `select_output`, `split_lod_tensor`,
`merge_lod_tensor`; `coalesce_tensor`; `shuffle_batch`; the
selected-rows ops `get_tensor_from_selected_rows`,
`merge_selected_rows`, `split_selected_rows`; int8 `quantize`,
`dequantize`, `requantize`; and `run_program`.

The IO, debugging, routing and selected-rows ops run on the host
(`no_jit`), as the reference's do, so a block holding one runs eagerly
(`fluid/lowering.py capture_blocker`); in the reference `print` and
`assert` run inside its jitted block through an ordered debug callback,
with the same message. `save` and `load` write and read the reference's
`PTPU0001` format byte for byte, so a file crosses between the packages
either way. `multiplex`, `coalesce_tensor` (a functional concat, as in
the reference), `shuffle_batch` and the quantize ops run on the device
and are captured; `shuffle_batch` draws its permutation from the op's
device seed (`core/rng.py`), as `randperm` does.
"""
from __future__ import annotations

import os
import struct
from typing import Callable, Dict

import numpy as np
import torch

from .array_ops import _array_read, _array_write
from .registry import register_op
from .rng_ops import device_bits
from ..core.selected_rows import SelectedRows
from ..core.types import from_numpy, to_numpy, to_torch_dtype

# -- save / load ------------------------------------------------------------

_MAGIC = b"PTPU0001"


def save_arrays(path: str, named: Dict[str, np.ndarray]):
    """Write `named` (name -> numpy array) to `path` in the `PTPU0001`
    format: the magic, a u32 count, then per array its name, its
    "dtype.str|d0,d1,..." header and its C-order bytes, each after its
    length (u32, u32, u64; little endian)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(named)))
        for name, arr in named.items():
            nb = name.encode()
            f.write(struct.pack("<I", len(nb)))
            f.write(nb)
            hdr = ("%s|%s" % (arr.dtype.str,
                              ",".join(map(str, arr.shape)))).encode()
            f.write(struct.pack("<I", len(hdr)))
            f.write(hdr)
            payload = np.ascontiguousarray(arr).tobytes()
            f.write(struct.pack("<Q", len(payload)))
            f.write(payload)


def load_arrays(path: str) -> Dict[str, np.ndarray]:
    """The arrays of a `PTPU0001` file, in its order."""
    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            raise ValueError("not a paddle_tpu checkpoint: %s" % path)
        (n,) = struct.unpack("<I", f.read(4))
        out = {}
        for _ in range(n):
            (ln,) = struct.unpack("<I", f.read(4))
            name = f.read(ln).decode()
            (hl,) = struct.unpack("<I", f.read(4))
            dtype_s, shape_s = f.read(hl).decode().split("|")
            shape = tuple(int(s) for s in shape_s.split(",") if s)
            (pl,) = struct.unpack("<Q", f.read(8))
            out[name] = np.frombuffer(
                f.read(pl), dtype=np.dtype(dtype_s)).reshape(shape).copy()
    return out


@register_op("save", no_jit=True)
def _save(ins, attrs):
    x = to_numpy(ins["X"][0])
    if attrs.get("save_as_fp16", False):
        x = x.astype("float16")
    save_arrays(attrs["file_path"], {attrs.get("var_name", "X"): x})
    return {}


@register_op("load", no_jit=True)
def _load(ins, attrs):
    arr = next(iter(load_arrays(attrs["file_path"]).values()))
    if attrs.get("load_as_fp16", False):
        arr = arr.astype("float16")
    return {"Out": from_numpy(arr, attrs["_device"])}


@register_op("save_combine", no_jit=True)
def _save_combine(ins, attrs):
    names = attrs.get("var_names") or [
        "X_%d" % i for i in range(len(ins["X"]))]
    save_arrays(attrs["file_path"],
                {n: to_numpy(v) for n, v in zip(names, ins["X"])})
    return {}


@register_op("load_combine", no_jit=True)
def _load_combine(ins, attrs):
    return {"Out": [from_numpy(v, attrs["_device"])
                    for v in load_arrays(attrs["file_path"]).values()]}


# -- debugging ---------------------------------------------------------------

def _print_infer(ins, attrs):
    return {"Out": list(ins.get("In") or ins["X"])}


@register_op("print", no_jit=True, infer_shape=_print_infer)
def _print(ins, attrs):
    """Prints "<message> dtype=... shape=... data=<the first `summarize`
    values>", the reference's line; Out is its input."""
    x = ins["In"][0] if ins.get("In") else ins["X"][0]
    arr = to_numpy(x)
    first_n = attrs.get("summarize", 20)
    flat = arr.reshape(-1)[:max(int(first_n), 0) or None]
    print("%s dtype=%s shape=%s data=%s"
          % (attrs.get("message", ""), arr.dtype, arr.shape, flat))
    return {"Out": x}


@register_op("assert", no_jit=True, infer_shape=lambda ins, attrs: {})
def _assert(ins, attrs):
    """Raises AssertionError where Cond is not all true (reference:
    operators/assert_op.cc), naming `message` or the Data values."""
    if not bool(to_numpy(ins["Cond"][0]).all()):
        summarize = int(attrs.get("summarize", -1))
        parts = []
        for d in ins.get("Data", []):
            flat = to_numpy(d).reshape(-1)
            parts.append(str(flat[:summarize] if summarize > 0 else flat))
        raise AssertionError(
            attrs.get("message", "") or
            "Assert failed%s" % ((": " + "; ".join(parts)) if parts else ""))
    return {}


# -- py_func -------------------------------------------------------------------

_PY_FUNCS: Dict[int, Callable] = {}


def register_py_func(fn: Callable) -> int:
    """Register a Python callable; returns the id that the py_func op's
    `func_id` attr names (reference: py_func_op.cc keeps callables in a
    Python-side registry by index)."""
    fid = len(_PY_FUNCS)
    _PY_FUNCS[fid] = fn
    return fid


@register_op("py_func", no_jit=True)
def _py_func(ins, attrs):
    """The registered callable on X's values as numpy arrays; its
    results (an array, a list of them, or None) as Out."""
    out = _PY_FUNCS[int(attrs["func_id"])](
        *[to_numpy(v) for v in ins.get("X", [])])
    if out is None:
        return {"Out": []}
    if not isinstance(out, (list, tuple)):
        out = [out]
    return {"Out": [from_numpy(np.asarray(o), attrs["_device"])
                    for o in out]}


# -- tensor-array aliases ----------------------------------------------------

register_op("write_to_array")(_array_write)
register_op("read_from_array")(_array_read)


# -- routing -----------------------------------------------------------------

@register_op("multiplex")
def _multiplex(ins, attrs):
    """Row n of Out is row n of X[Ids[n]]."""
    ids = ins["Ids"][0].reshape(-1).to(torch.int64)
    stacked = torch.stack(list(ins["X"]), dim=0)        # [K, N, ...]
    return {"Out": stacked[ids, torch.arange(stacked.shape[1],
                                             device=ids.device)]}


def _host_int(t):
    return int(to_numpy(t).reshape(()))


@register_op("select_input", no_jit=True)
def _select_input(ins, attrs):
    return {"Out": ins["X"][_host_int(ins["Mask"][0])]}


@register_op("select_output", no_jit=True)
def _select_output(ins, attrs):
    """X routed to output branch Mask; the other branches get empty
    placeholders (reference: controlflow/select_output_op.cc)."""
    x = ins["X"][0]
    outs = [x.new_zeros((0,))] * int(attrs.get("n_outputs", 1))
    outs[_host_int(ins["Mask"][0])] = x
    return {"Out": outs}


def _row_mask(t):
    return t.reshape(-1).to(torch.bool)


@register_op("split_lod_tensor", no_jit=True)
def _split_lod_tensor(ins, attrs):
    """X's rows where Mask is true, and where it is false (their counts
    read on the host)."""
    x = ins["X"][0]
    mask = _row_mask(ins["Mask"][0])
    return {"OutTrue": x[mask], "OutFalse": x[~mask]}


@register_op("merge_lod_tensor", no_jit=True)
def _merge_lod_tensor(ins, attrs):
    """The rows of InTrue where Mask is true and of InFalse elsewhere."""
    in_true, in_false = ins["InTrue"][0], ins["InFalse"][0]
    like = in_true if in_true.numel() else in_false
    mask = _row_mask(ins["Mask"][0])
    out = like.new_zeros((mask.shape[0],) + tuple(like.shape[1:]))
    out = out.index_put((mask,), in_true.to(out.dtype))
    return {"Out": out.index_put((~mask,), in_false.to(out.dtype))}


@register_op("coalesce_tensor")
def _coalesce_tensor(ins, attrs):
    """FusedOutput the concatenation of the flattened inputs, Output the
    inputs (the reference's functional form: nothing aliases)."""
    xs = list(ins["Input"])
    flat = torch.cat([x.reshape(-1) for x in xs]) if xs else \
        torch.zeros((0,), device=attrs["_device"])
    return {"Output": xs, "FusedOutput": flat}


@register_op("shuffle_batch", rng="device")
def _shuffle_batch(ins, attrs):
    """X's rows in a permutation drawn from the op's seed (the stable
    sort of 62-bit hash keys), and the permutation."""
    x = ins["X"][0]
    n, seed = x.shape[0], attrs["_rng_seed"]
    key = (device_bits(seed, (n,), 0) << 30) ^ device_bits(seed, (n,), 1)
    perm = torch.sort(key, stable=True)[1]
    return {"Out": x[perm], "ShuffleIdx": perm.to(to_torch_dtype("int64")),
            "SeedOut": torch.zeros((1,), dtype=to_torch_dtype("int64"),
                                   device=x.device)}


# -- selected rows -----------------------------------------------------------

@register_op("get_tensor_from_selected_rows", no_jit=True)
def _get_tensor_from_selected_rows(ins, attrs):
    x = ins["X"][0]
    return {"Out": x.values if isinstance(x, SelectedRows) else x}


@register_op("merge_selected_rows", no_jit=True)
def _merge_selected_rows(ins, attrs):
    x = ins["X"][0]
    return {"Out": x.merge() if isinstance(x, SelectedRows) else x}


@register_op("split_selected_rows", no_jit=True)
def _split_selected_rows(ins, attrs):
    """Shards by row range, `height_sections` rows each (reference:
    split_selected_rows_op.cc, the parameter-server send path): a
    SelectedRows' rows in each range, renumbered from its start, or the
    dense rows of each range."""
    sections = [int(s) for s in attrs["height_sections"]]
    bounds = np.cumsum([0] + sections)
    x = ins["X"][0]
    outs = []
    for i, h in enumerate(sections):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        if isinstance(x, SelectedRows):
            sel = (x.rows >= lo) & (x.rows < hi)
            outs.append(SelectedRows(x.rows[sel] - lo, x.values[sel], h))
        else:
            outs.append(x[lo:hi])
    return {"Out": outs}


# -- int8 (re)quantization ---------------------------------------------------

@register_op("quantize")
def _quantize(ins, attrs):
    x = ins["Input"][0]
    q = torch.round(x * float(attrs.get("Scale", 1.0)))
    if attrs.get("is_negative_input", True):
        return {"Output": torch.clamp(q, -128, 127).to(torch.int8)}
    return {"Output": torch.clamp(q, 0, 255).to(torch.uint8)}


@register_op("dequantize")
def _dequantize(ins, attrs):
    x = ins["Input"][0]
    return {"Output": x.to(torch.float32) / float(attrs.get("Scale", 1.0))}


@register_op("requantize")
def _requantize(ins, attrs):
    x = ins["Input"][0]
    ratio = float(attrs.get("Scale_out", 1.0)) / float(
        attrs.get("Scale_in", 1.0))
    y = torch.round(x.to(torch.float32) * ratio)
    info = torch.iinfo(x.dtype)
    return {"Output": torch.clamp(y, info.min, info.max).to(x.dtype)}


# -- run_program -------------------------------------------------------------

@register_op("run_program", no_jit=True)
def _run_program(ins, attrs):
    """Runs the Program of attr `program` through the port's Executor on
    the op's device (run_program_op.cc, the path of a program saved
    from dygraph): X fed as `feed_names`, Out the `fetch_names`."""
    from ..fluid import framework
    from ..fluid.executor import Executor

    dev = torch.device(attrs["_device"])
    place = framework.CPUPlace() if dev.type == "cpu" else \
        framework.CUDAPlace(dev.index or 0)
    feed = dict(zip(attrs.get("feed_names", []), ins.get("X", [])))
    exe = Executor(place)
    try:
        outs = exe.run(attrs["program"], feed=feed,
                       fetch_list=list(attrs.get("fetch_names", [])),
                       return_numpy=False)
    finally:
        exe.close()
    return {"Out": [f.value for f in outs]}

