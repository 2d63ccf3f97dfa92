"""SelectedRows: a sparse row-set gradient container (counterpart:
`paddle_tpu/core/selected_rows.py`).

Reference parity: `paddle/fluid/framework/selected_rows.h`, the (rows,
value, height) triple that an embedding's backward produces and the
optimizers' sparse kernels consume. The static lowering keeps dense
lookup gradients, as the reference's does; this container serves the
selected-rows ops (`ops/framework_ops.py`) and, later, the dygraph
sparse path.

Shapes stay static and nothing is read on the host: `merge` keeps one
slot per input row, the distinct rows sorted first and the rest row -1
with zero values (as `jnp.unique(size=n, fill_value=-1)` pads), and
sums each row's values in a fixed order (the rows' order in the input),
as does `to_dense`, on the card too (`index_put_` with accumulate under
PyTorch's deterministic algorithms)."""
from __future__ import annotations

import numpy as np
import torch

from .place import deterministic_algorithms


def ordered_row_sum(out, rows, values):
    """`out` with `values[i]` added to row `rows[i]` for every i, each
    row's values summed in their order in `rows` (no atomics)."""
    with deterministic_algorithms():
        return out.index_put((rows.long(),), values, accumulate=True)


class SelectedRows:
    __slots__ = ("rows", "values", "height")

    def __init__(self, rows, values, height: int):
        self.rows = rows          # int tensor [k]
        self.values = values      # [k, ...] row payloads
        self.height = int(height)  # dense dim-0 extent

    # -- framework duck-typing --------------------------------------------
    @property
    def shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    def __repr__(self):
        return "SelectedRows(rows=%d, height=%d, dim=%s)" % (
            len(self.rows), self.height, tuple(self.values.shape[1:]))

    # -- algebra -----------------------------------------------------------
    def merge(self) -> "SelectedRows":
        """Deduplicate the rows by a segment sum (reference:
        operators/math/selected_rows_functor.cc MergeAdd), in static
        shapes: the distinct rows ascending, then -1 rows with zero
        values up to the input's row count."""
        rows = torch.as_tensor(self.rows, device=self.values.device)
        n = rows.shape[0]
        srt, perm = torch.sort(rows, stable=True)
        first = torch.ones_like(srt, dtype=torch.bool)
        first[1:] = srt[1:] != srt[:-1]
        seg = torch.cumsum(first.to(torch.int64), 0) - 1
        uniq = torch.full_like(rows, -1).index_put(
            (seg,), srt)  # a segment's members write one value
        summed = ordered_row_sum(
            self.values.new_zeros((n,) + tuple(self.values.shape[1:])),
            seg, self.values[perm])
        return SelectedRows(uniq, summed, self.height)

    def to_dense(self):
        rows = torch.as_tensor(self.rows, device=self.values.device)
        valid = rows >= 0
        vals = torch.where(valid.reshape((-1,) + (1,) * (
            self.values.ndim - 1)), self.values,
            torch.zeros((), dtype=self.values.dtype,
                        device=self.values.device))
        dense = self.values.new_zeros((self.height,)
                                      + tuple(self.values.shape[1:]))
        return ordered_row_sum(dense, torch.where(valid, rows, 0), vals)

    def __add__(self, other):
        if isinstance(other, SelectedRows):
            assert other.height == self.height, (other.height, self.height)
            return SelectedRows(torch.cat([self.rows, other.rows]),
                                torch.cat([self.values, other.values]),
                                self.height)
        if other is None or (np.isscalar(other) and other == 0):
            return self
        return self.to_dense() + other

    __radd__ = __add__


def sr_add(a, b):
    """An add where either side may be a SelectedRows or dense."""
    if isinstance(a, SelectedRows) or isinstance(b, SelectedRows):
        if isinstance(a, SelectedRows):
            return a + b
        return b + a
    return a + b
