"""Control-flow layers (counterpart:
`paddle_tpu/fluid/layers/control_flow.py`): `Scan`, the fixed-trip loop
over stacked [n, ...] inputs; `While` and `while_loop`; `cond`,
`switch_case` and `case`; `increment`, `is_empty` and the comparison
layers.

Each builds its body or branches into sub-blocks of the program and
appends one op (`scan`, `while`, `cond`, `switch_case`) that
`fluid/lowering.py` runs. Loop-carried vars are created and initialized
before the loop and rebound inside it (``layers.assign(new, output=x)``);
a branch's results are assigned onto output vars created in the
enclosing block. `StaticRNN`, `Print`, `Assert` and
`reorder_lod_tensor_by_rank` are not ported yet.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence

from .. import framework
from ..framework import Variable, unique_name
from ..layer_helper import LayerHelper
from . import tensor as tensor_layers

__all__ = ["Scan", "While", "while_loop", "cond", "switch_case", "case",
           "increment", "is_empty", "less_than", "less_equal",
           "greater_than", "greater_equal", "equal", "not_equal"]


def _flatten(x):
    if isinstance(x, (list, tuple)):
        out = []
        for e in x:
            out.extend(_flatten(e))
        return out
    return [x]


def _pack_like(template, flat):
    it = iter(flat)

    def rec(t):
        if isinstance(t, (list, tuple)):
            return type(t)(rec(e) for e in t)
        return next(it)

    return rec(template)


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


# ---------------------------------------------------------------------------
# While (the 1.x context-manager form) and while_loop
# ---------------------------------------------------------------------------

class While:
    """``while cond_var:`` over a sub-block (reference: control_flow.py
    While / while_op.cc). The body must rebind `cond`; every loop-carried
    var is created and initialized before the loop.

    Usage::

        cond = layers.less_than(i, n)
        w = layers.While(cond)
        with w.block():
            ...
            layers.increment(i)
            layers.less_than(i, n, cond=cond)
    """

    def __init__(self, cond, is_test=False, name=None):
        if not isinstance(cond, Variable):
            raise TypeError("While cond must be a Variable")
        self.cond_var = cond
        self._main = framework.default_main_program()

    @contextlib.contextmanager
    def block(self):
        """Build the body; on exit, append the `while` op to the
        enclosing block (nothing is appended if the body raised)."""
        prog = self._main
        sub = prog._create_block()
        try:
            yield self
        finally:
            prog._rollback()
        prog.current_block().append_op(
            type="while", inputs={"Condition": [self.cond_var]},
            outputs={}, attrs={"sub_block": sub.idx,
                               "cond_name": self.cond_var.name})


def while_loop(cond: Callable, body: Callable, loop_vars: Sequence,
               is_test: bool = False, name: Optional[str] = None):
    """Functional while (reference: control_flow.py while_loop): runs
    ``body`` while ``cond(*loop_vars)`` holds; returns the loop vars,
    which hold the final values."""
    loop_list = list(loop_vars)
    pre_cond = cond(*loop_list)
    w = While(pre_cond, is_test=is_test, name=name)
    with w.block():
        out = body(*loop_list)
        out_list = out if isinstance(out, (list, tuple)) else [out]
        flat_in = _flatten(loop_list)
        flat_out = _flatten(list(out_list))
        if len(flat_in) != len(flat_out):
            raise ValueError(
                "body returned %d vars, expected %d (the loop_vars "
                "structure)" % (len(flat_out), len(flat_in)))
        for lv, ov in zip(flat_in, flat_out):
            if ov is not lv:
                tensor_layers.assign(ov, output=lv)
        tensor_layers.assign(cond(*loop_list), output=pre_cond)
    return loop_vars


# ---------------------------------------------------------------------------
# cond / switch_case / case
# ---------------------------------------------------------------------------

def _trace_branch(prog, fn, out_vars=None):
    """Build `fn` in a new sub-block and assign its results onto
    `out_vars` (created in the enclosing block for the first branch).
    Returns (block index, out_vars, fn's result)."""
    sub = prog._create_block()
    try:
        ret = fn() if fn is not None else None
    except BaseException:
        prog._rollback()
        raise
    flat = _flatten(ret) if ret is not None else []
    if out_vars is None:
        parent = prog.block(sub.parent_idx)
        out_vars = []
        for i, r in enumerate(flat):
            if not isinstance(r, Variable):
                r = tensor_layers.fill_constant([1], "float32", float(r))
                flat[i] = r
            out_vars.append(parent.create_var(
                name=framework.unique_name("cond_out"),
                shape=r.shape, dtype=r.dtype))
    if len(flat) != len(out_vars):
        prog._rollback()
        raise ValueError("branches must return the same structure "
                         "(%d vs %d leaves)" % (len(flat), len(out_vars)))
    for r, ov in zip(flat, out_vars):
        if not isinstance(r, Variable):
            r = tensor_layers.fill_constant(ov.shape, ov.dtype, float(r))
        tensor_layers.assign(r, output=ov)
    prog._rollback()
    return sub.idx, out_vars, ret


def cond(pred, true_fn: Optional[Callable] = None,
         false_fn: Optional[Callable] = None, name: Optional[str] = None):
    """Two-way branch (reference: control_flow.py cond). Both branches
    return the same structure of vars, of equal shapes and dtypes; the
    lowering runs the one `pred` picks."""
    prog = framework.default_main_program()
    t_idx, out_vars, template = _trace_branch(prog, true_fn)
    f_idx, _, _ = _trace_branch(prog, false_fn, out_vars)
    prog.current_block().append_op(
        type="cond", inputs={"Cond": [pred]},
        outputs={"Out": list(out_vars)},
        attrs={"sub_block_t": t_idx, "sub_block_f": f_idx,
               "out_names": [v.name for v in out_vars],
               "cond_name": pred.name})
    if template is None:
        return None
    if isinstance(template, (list, tuple)):
        return _pack_like(template, out_vars)
    return out_vars[0]


def switch_case(branch_index, branch_fns, default=None,
                name: Optional[str] = None):
    """N-way branch on an integer [1] index (reference: control_flow.py
    switch_case). `branch_fns` is a list of callables (keys 0, 1, ...),
    a dict or a list of (key, callable) pairs; an index that matches no
    key runs `default` (the last branch when none is given)."""
    prog = framework.default_main_program()
    if isinstance(branch_fns, dict):
        items = sorted(branch_fns.items())
    elif branch_fns and all(isinstance(f, (list, tuple)) and len(f) == 2
                            for f in branch_fns):
        items = sorted((int(k), f) for k, f in branch_fns)
    else:
        items = list(enumerate(branch_fns))
    keys = [int(k) for k, _ in items]
    fns = [f for _, f in items]
    if default is None:
        # the last branch becomes the default (and is built only once)
        default = fns.pop()
        keys.pop()

    out_vars, blocks, template = None, [], None
    for f in fns:
        idx, out_vars, tmpl = _trace_branch(prog, f, out_vars)
        template = template if template is not None else tmpl
        blocks.append(idx)
    d_idx, out_vars, _ = _trace_branch(prog, default, out_vars)
    blocks.append(d_idx)
    prog.current_block().append_op(
        type="switch_case", inputs={"Index": [branch_index]},
        outputs={"Out": list(out_vars)},
        attrs={"sub_blocks": blocks, "keys": keys,
               "out_names": [v.name for v in out_vars],
               "index_name": branch_index.name})
    if isinstance(template, (list, tuple)):
        return _pack_like(template, out_vars)
    return out_vars[0]


def case(pred_fn_pairs, default=None, name: Optional[str] = None):
    """The first (pred, fn) whose pred holds runs, else `default`
    (reference: control_flow.py case), built from nested `cond`s."""
    pairs = list(pred_fn_pairs)
    if not pairs:
        raise ValueError("pred_fn_pairs must be non-empty")
    if default is None:
        default = pairs[-1][1]
        pairs = pairs[:-1]
        if not pairs:
            return default()

    def build(i):
        if i == len(pairs):
            return default
        pred, fn = pairs[i]
        return lambda: cond(pred, fn, build(i + 1))

    return build(0)()


# ---------------------------------------------------------------------------
# increment and the comparisons
# ---------------------------------------------------------------------------

def increment(x, value=1.0, in_place=True):
    """x + value; in place (the default) rebinds `x` itself."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        dtype=x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def is_empty(x, cond=None):
    """[x has no element], a bool [1] (shapes are static: the answer is
    known when the block runs)."""
    helper = LayerHelper("is_empty")
    out = cond if cond is not None else \
        helper.create_variable_for_type_inference(dtype="bool")
    helper.append_op(type="is_empty", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={})
    return out


def _compare(op_type, x, y, out):
    helper = LayerHelper(op_type)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype="bool")
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def less_than(x, y, force_cpu=None, cond=None):
    return _compare("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _compare("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _compare("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _compare("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _compare("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _compare("not_equal", x, y, cond)
