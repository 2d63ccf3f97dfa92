"""Control-flow layers of the slice (counterpart:
`paddle_tpu/fluid/layers/control_flow.py`): `Scan`, the fixed-trip loop
over stacked [n, ...] inputs. While, cond and switch_case are not ported
yet."""
from __future__ import annotations

import contextlib
from typing import List, Optional

from .. import framework
from ..framework import Variable, unique_name

__all__ = ["Scan"]


class Scan:
    """A fixed-trip loop whose body (a sub-block) runs `n` times; the
    lowering's `_exec_scan` runs it. Loop-carried vars are created and
    initialized before the loop and rebound inside the body
    (``layers.assign(new_x, output=x)``); per-iteration parameters are
    stacked on a leading [n, ...] axis and sliced with
    ``scan.slice_input(stacked)`` inside the body; ``scan.iteration()``
    gives the iteration's index. ``remat=True``
    recomputes each iteration's activations in the backward
    (`torch.utils.checkpoint`) instead of keeping them.

    Usage::

        scan = layers.Scan(n=num_layers)
        with scan.block():
            w = scan.slice_input(stacked_w)   # [n, H, H] -> [H, H]
            new_x = layers.matmul(x, w)
            layers.assign(new_x, output=x)    # rebind the carry
    """

    def __init__(self, n: int, remat: bool = False,
                 name: Optional[str] = None):
        if int(n) < 1:
            raise ValueError("Scan needs n >= 1, got %r" % (n,))
        self.n = int(n)
        self.remat = bool(remat)
        self._main = framework.default_main_program()
        self._sub = None
        self._xs_stacked: List[Variable] = []
        self._xs_slice: List[Variable] = []
        self._iter_var: Optional[Variable] = None

    def iteration(self) -> Variable:
        """An int32 [1] var holding the current iteration's index inside
        the body, e.g. the row of stacked [n, ...] state that the
        iteration reads with `gather` and writes back with `scatter`
        (the BN running statistics of a scanned ResNet stage)."""
        if self._sub is None:
            raise ValueError(
                "iteration() must be called inside `with scan.block():`")
        if self._iter_var is None:
            self._iter_var = self._sub.create_var(
                name=unique_name("scan_iter"), shape=(1,), dtype="int32")
        return self._iter_var

    def slice_input(self, stacked: Variable) -> Variable:
        """Declare `stacked` [n, ...] as a per-iteration input; returns
        its [...] slice for use inside the body."""
        if self._sub is None:
            raise ValueError(
                "slice_input must be called inside `with scan.block():`")
        if not isinstance(stacked, Variable):
            raise TypeError("slice_input expects a Variable")
        if int(stacked.shape[0]) != self.n:
            raise ValueError(
                "stacked input %r leading dim %s != scan n %d"
                % (stacked.name, stacked.shape[0], self.n))
        sl = self._sub.create_var(
            name=unique_name("scan_slice"),
            shape=tuple(int(d) for d in stacked.shape[1:]),
            dtype=stacked.dtype)
        self._xs_stacked.append(stacked)
        self._xs_slice.append(sl)
        return sl

    @contextlib.contextmanager
    def block(self):
        """Build the body; on exit, append the `scan` op to the enclosing
        block (nothing is appended if the body raised)."""
        prog = self._main
        self._sub = prog._create_block()
        self._xs_stacked, self._xs_slice = [], []
        self._iter_var = None
        try:
            yield self
        finally:
            prog._rollback()
            sub, self._sub = self._sub, None
        prog.current_block().append_op(
            type="scan", inputs={"X": list(self._xs_stacked)}, outputs={},
            attrs={"sub_block": sub.idx, "n": self.n, "remat": self.remat,
                   "xs_stacked": [v.name for v in self._xs_stacked],
                   "xs_slice": [v.name for v in self._xs_slice],
                   "iter_var": self._iter_var.name
                   if self._iter_var is not None else ""})
