"""LoDTensorArray operators (counterpart: `paddle_tpu/ops/array_ops.py`):
`array_write`, `array_read`, `lod_array_length`, `array_to_lod_tensor`,
`lod_tensor_to_array`, `tensor_array_to_tensor`,
`reorder_lod_tensor_by_rank`, `reorder_lod_tensor_by_rank_grad`,
`lod_rank_table`, `max_sequence_len` and `shrink_rnn_memory`
(`write_to_array` and `read_from_array` alias the first two in
`ops/framework_ops.py`).

As in the reference, a tensor array of static length is one stacked
[T, ...] buffer: a write is a masked select of the written slot, a read
an `index_select`, both with the index on the device and clamped into
[0, T) as `lax.dynamic_update_slice` clamps it. `array_write` raises
`IndexError` for an index past the end where it can read the index
without waiting inside a capture (a CPU tensor, or an eager call on the
card), as the reference raises for a concrete index; inside a CUDA
graph capture it clamps and reads nothing (ROADMAP Queue 3,
reference-side). `lod_rank_table` sorts by length descending with a
stable sort; `reorder_lod_tensor_by_rank_grad` inverts the permutation
on the device.
"""
from __future__ import annotations

import torch

from .registry import register_op
from ..core.types import to_torch_dtype

_INT64 = to_torch_dtype("int64")


def _index(t):
    return t.reshape(()).to(torch.int32)


def _readable(t):
    """Whether `t`'s value can be read here: not a meta tensor, and not
    on the card while a CUDA graph is being captured."""
    if t.device.type == "meta":
        return False
    return t.device.type != "cuda" or \
        not torch.cuda.is_current_stream_capturing()


@register_op("array_write")
def _array_write(ins, attrs):
    """Array [T, ...] (zeros of `max_len` slots without it) with X
    written at I; OutLen the logical length max(Len, I + 1)."""
    x = ins["X"][0]
    arr = ins["Array"][0] if ins.get("Array") else x.new_zeros(
        (attrs.get("max_len", 64),) + tuple(x.shape))
    i = _index(ins["I"][0])
    n = arr.shape[0]
    if _readable(i) and int(i) >= n:
        raise IndexError("array_write index %d out of range for "
                         "TensorArray of max_len %d" % (int(i), n))
    slot = torch.arange(n, device=arr.device) == torch.clamp(i, 0, n - 1)
    prev_len = _index(ins["Len"][0]) if ins.get("Len") else \
        torch.zeros((), dtype=torch.int32, device=arr.device)
    return {"Out": torch.where(slot.reshape((n,) + (1,) * x.ndim),
                               x[None].to(arr.dtype), arr),
            "OutLen": torch.maximum(prev_len, i + 1)}


@register_op("array_read")
def _array_read(ins, attrs):
    arr = ins["Array"][0] if ins.get("Array") else ins["X"][0]
    i = torch.clamp(_index(ins["I"][0]), 0, arr.shape[0] - 1)
    return {"Out": torch.index_select(arr, 0, i.reshape(1))[0]}


@register_op("lod_array_length")
def _lod_array_length(ins, attrs):
    """The written length from array_write's OutLen fed as Len; without
    it the buffer's capacity (the reference's fallback)."""
    if ins.get("Len"):
        return {"Out": ins["Len"][0].reshape(1).to(_INT64)}
    arr = ins["X"][0]
    return {"Out": torch.full((1,), arr.shape[0], dtype=_INT64,
                              device=arr.device)}


@register_op("array_to_lod_tensor")
def _array_to_lod_tensor(ins, attrs):
    # stacked [T, B, ...] -> concatenated over time, [T*B, ...]
    arr = ins["X"][0]
    return {"Out": arr.reshape((-1,) + tuple(arr.shape[2:]))}


@register_op("lod_tensor_to_array")
def _lod_tensor_to_array(ins, attrs):
    x = ins["X"][0]
    t = attrs.get("max_len", x.shape[0])
    return {"Out": x.reshape((t, -1) + tuple(x.shape[1:]))}


@register_op("tensor_array_to_tensor")
def _tensor_array_to_tensor(ins, attrs):
    """The entries of the stacked [T, ...] buffer concatenated (or, with
    `use_stack`, stacked) along `axis`; OutIndex each entry's extent
    along `axis` (reference: tensor_array_to_tensor_op.cc:85,115-118)."""
    arr = ins["X"][0]
    axis = int(attrs.get("axis", 0))
    if attrs.get("use_stack", False):
        out = torch.movedim(arr, 0, axis)
    else:
        out = torch.cat(list(torch.unbind(arr, 0)), dim=axis)
    return {"Out": out, "OutIndex": torch.full(
        (arr.shape[0],), arr.shape[1:][axis], dtype=torch.int32,
        device=arr.device)}


@register_op("reorder_lod_tensor_by_rank")
def _reorder_lod_tensor_by_rank(ins, attrs):
    """X's rows in the rank table's order (the order vector that
    lod_rank_table gives)."""
    order = ins["RankTable"][0].reshape(-1).to(torch.int64)
    return {"Out": torch.index_select(ins["X"][0], 0, order)}


@register_op("reorder_lod_tensor_by_rank_grad")
def _reorder_lod_tensor_by_rank_grad(ins, attrs):
    """The rows put back in their first order: X taken by the inverse
    permutation, made on the device."""
    order = ins["RankTable"][0].reshape(-1).to(torch.int64)
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.shape[0], device=order.device))
    return {"Out": torch.index_select(ins["X"][0], 0, inv)}


@register_op("lod_rank_table")
def _lod_rank_table(ins, attrs):
    """The row indices by length, longest first (ties in row order), and
    the lengths in that order; without Length every row is T long."""
    if ins.get("Length"):
        length = ins["Length"][0].reshape(-1)
    else:
        x = ins["X"][0]
        length = torch.full((x.shape[0],), x.shape[1] if x.ndim > 1 else 1,
                            dtype=_INT64, device=x.device)
    order = torch.sort(-length, stable=True)[1]
    return {"Out": order.to(_INT64), "Lengths": length[order].to(_INT64)}


@register_op("max_sequence_len")
def _max_sequence_len(ins, attrs):
    for slot in ("Length", "Lengths"):
        if ins.get(slot):
            return {"Out": torch.amax(ins[slot][0]).to(_INT64)}
    raise ValueError(
        "max_sequence_len: wire a Length/Lengths input (feed "
        "lod_rank_table's Lengths output); the rank-table order alone "
        "does not carry sequence lengths in the padded representation")


@register_op("shrink_rnn_memory")
def _shrink_rnn_memory(ins, attrs):
    """X with the rows whose sequence ended before step I zeroed (the
    static-shape form of the reference's shrink)."""
    x = ins["X"][0]
    if not ins.get("Length"):
        return {"Out": x}
    i = _index(ins["I"][0]) if ins.get("I") else 0
    active = (ins["Length"][0].reshape(-1) > i).to(x.dtype)
    return {"Out": x * active.reshape((-1,) + (1,) * (x.ndim - 1))}
