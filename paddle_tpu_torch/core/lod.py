"""Multi-level LoD (level-of-detail: nested ragged sequences), the
port's own copy of `paddle_tpu/core/lod.py` (pure numpy; the port
imports nothing of the JAX package).

Reference parity: `paddle/fluid/framework/lod_tensor.h:52` (offset-based
LoD over a dense tensor, arbitrarily nested: a 2-level LoD models
paragraphs -> sentences -> words) and the python surface
`python/paddle/fluid/lod_tensor.py` (create_lod_tensor /
create_random_int_lodtensor, length-based <-> offset-based conversion).

The ragged structure lives on the host next to a dense row-major
payload, as in Paddle, where LoD never reaches a kernel either.
`to_padded()` bridges to the padded [n_seq, max_len, ...] + lengths
layout the sequence ops take on the device (`ops/sequence_ops.py`);
`from_padded()` comes back. A `LoDTensor` feeds the Executor through
`__array__` (its payload)."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = [
    "LoDTensor", "create_lod_tensor", "create_random_int_lodtensor",
]


def _lens_to_offsets(lens: Sequence[int]) -> List[int]:
    out = [0]
    for n in lens:
        out.append(out[-1] + int(n))
    return out


def _offsets_to_lens(offsets: Sequence[int]) -> List[int]:
    return [int(offsets[i + 1] - offsets[i])
            for i in range(len(offsets) - 1)]


class LoDTensor:
    """Dense payload + offset-based multi-level LoD.

    lod() returns the OFFSET form (reference LoDTensor::lod):
    lod()[i] partitions the entries of level i+1 (or the payload rows
    for the innermost level). recursive_sequence_lengths() is the
    LENGTH form users build (reference: set_recursive_sequence_lengths).
    """

    def __init__(self, data=None, lod: Optional[List[List[int]]] = None):
        self._data = None if data is None else np.asarray(data)
        self._lod: List[List[int]] = [list(map(int, lv))
                                      for lv in (lod or [])]

    # -- payload -----------------------------------------------------------
    def set(self, data, place=None):
        self._data = np.asarray(data)

    def numpy(self):
        return self._data

    def __array__(self, dtype=None):
        a = self._data
        return a.astype(dtype) if dtype is not None else a

    def shape(self):
        return list(self._data.shape) if self._data is not None else []

    # -- LoD metadata ------------------------------------------------------
    def lod(self) -> List[List[int]]:
        return [list(lv) for lv in self._lod]

    def set_lod(self, lod: List[List[int]]):
        self._lod = [list(map(int, lv)) for lv in lod]

    def recursive_sequence_lengths(self) -> List[List[int]]:
        return [_offsets_to_lens(lv) for lv in self._lod]

    def set_recursive_sequence_lengths(self, lens: List[List[int]]):
        self._lod = [_lens_to_offsets(lv) for lv in lens]

    def lod_level(self) -> int:
        return len(self._lod)

    def has_valid_recursive_sequence_lengths(self) -> bool:
        """Reference CheckLoD (lod_tensor.cc): every level's offsets are
        non-decreasing from 0; level i's last offset equals the number
        of entries of level i+1; the innermost level's last offset
        equals the payload's first dimension."""
        if self._data is None:
            return False
        for i, lv in enumerate(self._lod):
            if not lv or lv[0] != 0:
                return False
            if any(lv[j] > lv[j + 1] for j in range(len(lv) - 1)):
                return False
            end = (len(self._lod[i + 1]) - 1 if i + 1 < len(self._lod)
                   else int(self._data.shape[0]))
            if lv[-1] != end:
                return False
        return True

    # -- bridges to the device-side padded layout -------------------------
    def innermost_lengths(self) -> List[int]:
        """Sequence lengths at the finest granularity (rows per leaf
        sequence)."""
        if not self._lod:
            return [int(self._data.shape[0])]
        return _offsets_to_lens(self._lod[-1])

    def to_padded(self, pad_value=0.0):
        """(padded [n_seq, max_len, ...], lengths int64 [n_seq]): the
        static-shape layout the sequence ops take on device."""
        lens = self.innermost_lengths()
        offsets = _lens_to_offsets(lens)
        max_len = max(lens) if lens else 0
        feat = self._data.shape[1:]
        out = np.full((len(lens), max_len) + feat, pad_value,
                      self._data.dtype)
        for i, n in enumerate(lens):
            out[i, :n] = self._data[offsets[i]:offsets[i] + n]
        return out, np.asarray(lens, np.int64)

    @staticmethod
    def from_padded(padded, lengths, outer_lens=None):
        """Inverse of to_padded; optional outer_lens adds a second LoD
        level (how many inner sequences each outer sequence owns)."""
        padded = np.asarray(padded)
        lengths = [int(x) for x in np.asarray(lengths).reshape(-1)]
        rows = [padded[i, :n] for i, n in enumerate(lengths)]
        data = (np.concatenate(rows, axis=0) if rows
                else padded[:0].reshape((0,) + padded.shape[2:]))
        lod = [_lens_to_offsets(lengths)]
        if outer_lens is not None:
            lod.insert(0, _lens_to_offsets(
                [int(x) for x in outer_lens]))
        return LoDTensor(data, lod)

    def __repr__(self):
        return "LoDTensor(shape=%s, lod=%s)" % (self.shape(), self._lod)


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """Reference: lod_tensor.py create_lod_tensor — numpy array, list of
    sequences (single-level, like the reference's DataToLoDTensorConverter
    path), or LoDTensor + LENGTH-based LoD -> LoDTensor with offset LoD."""
    if isinstance(data, LoDTensor):
        return create_lod_tensor(data.numpy(), recursive_seq_lens, place)
    if isinstance(data, list):
        # reference contract: the top list is the batch of sequences and
        # must match recursive_seq_lens exactly (lod_tensor.py:137)
        lens = [len(seq) for seq in data]
        if [lens] != [list(map(int, lv)) for lv in recursive_seq_lens]:
            raise AssertionError(
                "data and recursive_seq_lens do not match")
        flat = [np.asarray(x).reshape(-1) for seq in data for x in seq]
        t = LoDTensor(np.stack(flat) if flat else np.zeros((0, 1)))
    else:
        t = LoDTensor(np.asarray(data))
    t.set_recursive_sequence_lengths(recursive_seq_lens)
    if not t.has_valid_recursive_sequence_lengths():
        raise AssertionError(
            "the provided recursive_seq_lens info is invalid for the "
            "data (innermost total %r vs payload rows %r)"
            % (recursive_seq_lens, t.shape()))
    return t


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place=None,
                                low=0, high=10, seed=None):
    """Reference: lod_tensor.py create_random_int_lodtensor — payload
    rows = sum of the innermost lengths, feature dims = base_shape."""
    total = sum(int(x) for x in recursive_seq_lens[-1])
    r = np.random.RandomState(seed)
    data = r.randint(low, high + 1,
                     (total,) + tuple(base_shape)).astype("int64")
    return create_lod_tensor(data, recursive_seq_lens, place)
