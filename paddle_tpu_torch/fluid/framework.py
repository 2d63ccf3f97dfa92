"""Graph-building front end: Program / Block / Operator / Variable
(counterpart: `paddle_tpu/fluid/framework.py`).

The IR is the reference's ProgramDesc shape: blocks of ops over named
vars. Shape inference runs each op's torch compute function on meta
tensors at `append_op` time (`ops.registry.infer_outputs`). Execution is
`fluid/lowering.py` (eager, op by op) under `fluid/executor.py`.
"""
from __future__ import annotations

import collections
import contextlib
import copy
from typing import Dict, List

import numpy as np

from ..core import types as core_types
from ..core.errors import capture_user_callstack
from ..core.place import (  # noqa: F401  (re-exported)
    CPUPlace, CUDAPlace, Place, _current_expected_place,
)

# ---------------------------------------------------------------------------
# unique_name (reference: python/paddle/fluid/unique_name.py)
# ---------------------------------------------------------------------------


class _UniqueNameGenerator:
    def __init__(self, prefix=None):
        self.ids = collections.defaultdict(int)
        self.prefix = prefix or ""

    def __call__(self, key):
        tmp = self.ids[key]
        self.ids[key] += 1
        return self.prefix + "_".join([key, str(tmp)])


_name_generator = _UniqueNameGenerator()


def unique_name(key: str) -> str:
    return _name_generator(key)


@contextlib.contextmanager
def unique_name_guard(prefix: str = ""):
    global _name_generator
    old = _name_generator
    _name_generator = _UniqueNameGenerator(prefix)
    try:
        yield
    finally:
        _name_generator = old


GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


# ---------------------------------------------------------------------------
# Variable
# ---------------------------------------------------------------------------

class Variable:
    """Symbolic variable in a Block (reference: framework.py:835)."""

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 persistable=False, stop_gradient=False, is_data=False,
                 trainable=True, type=None, lod_level=0, **kwargs):
        self.block = block
        self.name = name or unique_name("_generated_var")
        self.shape = tuple(shape) if shape is not None else ()
        self.dtype = core_types.normalize_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.trainable = trainable
        self.type = type or "LOD_TENSOR"
        self.lod_level = lod_level
        self.op = None  # producing Operator (set by append_op)

    @property
    def grad_name(self):
        return grad_var_name(self.name)

    @property
    def ndim(self):
        return len(self.shape)

    def __repr__(self):
        return "Var(%s, shape=%s, dtype=%s%s)" % (
            self.name, self.shape, self.dtype,
            ", persistable" if self.persistable else "")

    __str__ = __repr__

    # -- operator sugar (reference: framework.py:227-291) -------------------
    def _binary(self, other, op, reverse=False):
        from .layers import math_op_patch

        return math_op_patch.binary(self, other, op, reverse)

    def __add__(self, o):
        return self._binary(o, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._binary(o, "elementwise_sub", reverse=True)

    def __mul__(self, o):
        return self._binary(o, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "elementwise_div")

    def __rtruediv__(self, o):
        return self._binary(o, "elementwise_div", reverse=True)

    def __pow__(self, o):
        return self._binary(o, "elementwise_pow")

    def __mod__(self, o):
        return self._binary(o, "elementwise_mod")

    def __floordiv__(self, o):
        return self._binary(o, "elementwise_floordiv")

    def __neg__(self):
        from .layers import tensor as _t

        return _t.scale(self, scale=-1.0)

    def __matmul__(self, o):
        from .layers import nn as _nn

        return _nn.matmul(self, o)

    def __lt__(self, o):
        return self._binary(o, "less_than")

    def __le__(self, o):
        return self._binary(o, "less_equal")

    def __gt__(self, o):
        return self._binary(o, "greater_than")

    def __ge__(self, o):
        return self._binary(o, "greater_equal")

    def __eq__(self, o):
        # identity, not an op: vars are dict keys and list members
        if isinstance(o, Variable) or np.isscalar(o):
            return id(self) == id(o) if isinstance(o, Variable) else False
        return NotImplemented

    def __hash__(self):
        return id(self)


class Parameter(Variable):
    """Trainable persistable variable (reference: framework.py:5080)."""

    def __init__(self, block, shape, dtype, **kwargs):
        kwargs.setdefault("persistable", True)
        self.regularizer = kwargs.pop("regularizer", None)
        self.optimize_attr = kwargs.pop("optimize_attr",
                                        {"learning_rate": 1.0})
        self.do_model_average = kwargs.pop("do_model_average", None)
        self.is_distributed = kwargs.pop("is_distributed", False)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------

def _var_name(v):
    return v.name if isinstance(v, Variable) else v


def _as_list(vs):
    return vs if isinstance(vs, (list, tuple)) else [vs]


class Operator:
    """One op in a block: type + slot->var-name maps + attrs
    (reference: framework.py:1822 / framework.proto OpDesc)."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        # var NAMES (IR form); Variables resolve through the block
        self.input_names: Dict[str, List[str]] = {
            slot: [_var_name(v) for v in _as_list(vs)]
            for slot, vs in (inputs or {}).items()}
        self.output_names: Dict[str, List[str]] = {
            slot: [_var_name(v) for v in _as_list(vs)]
            for slot, vs in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        # creation-site frames for error attribution (reference:
        # framework/op_call_stack.cc)
        self._creation_stack = capture_user_callstack()

    def input(self, slot):
        return self.input_names.get(slot, [])

    def output(self, slot):
        return self.output_names.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for vs in self.input_names.values() for n in vs]

    @property
    def output_arg_names(self):
        return [n for vs in self.output_names.values() for n in vs]

    def attr(self, name):
        return self.attrs.get(name)

    def has_attr(self, name):
        return name in self.attrs

    def __repr__(self):
        return "{%s: %s -> %s}" % (self.type, self.input_names,
                                   self.output_names)


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

class Block:
    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = collections.OrderedDict()
        self.ops: List[Operator] = []

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    # -- vars --------------------------------------------------------------
    def create_var(self, **kwargs) -> Variable:
        name = kwargs.get("name") or unique_name("_generated_var")
        kwargs["name"] = name
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, **kwargs)
        self.vars[name] = v
        return v

    def create_parameter(self, **kwargs) -> Parameter:
        # parameters live in the top (global) block
        gb = self.program.global_block()
        name = kwargs.pop("name", None) or unique_name("_param")
        shape = kwargs.pop("shape")
        dtype = kwargs.pop("dtype", "float32")
        p = Parameter(gb, shape=shape, dtype=dtype, name=name, **kwargs)
        gb.vars[name] = p
        return p

    def var(self, name) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError("var %r not found in block %d" % (name, self.idx))
        return v

    def _find_var_recursive(self, name):
        if name in self.vars:
            return self.vars[name]
        pb = self.parent_block
        return pb._find_var_recursive(name) if pb is not None else None

    def has_var(self, name):
        return self._find_var_recursive(name) is not None

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # -- ops ---------------------------------------------------------------
    def append_op(self, type=None, inputs=None, outputs=None, attrs=None,
                  stop_gradient=False) -> Operator:
        op = Operator(self, type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.append(op)
        self.program._version += 1
        self._infer_op_shapes(op, inputs or {}, outputs or {})
        for vs in (outputs or {}).values():
            for v in _as_list(vs):
                if isinstance(v, Variable):
                    v.op = op
                    if stop_gradient:
                        v.stop_gradient = True
        return op

    def _prepend_op(self, **kwargs) -> Operator:
        """`append_op`, then move the op to the front of the block (the
        learning-rate schedules' step counter increments first)."""
        op = self.append_op(**kwargs)
        self.ops.insert(0, self.ops.pop())
        return op

    def _infer_op_shapes(self, op, inputs, outputs):
        from .. import ops as ops_lib

        if not ops_lib.has_op(op.type):
            return  # framework-level pseudo op (feed/fetch/backward/...)
        in_specs = {}
        for slot, vs in inputs.items():
            specs = []
            for v in _as_list(vs):
                var = v if isinstance(v, Variable) else self.var(v)
                specs.append((var.shape, var.dtype))
            in_specs[slot] = specs
        try:
            out_specs = ops_lib.infer_outputs(op.type, in_specs, op.attrs)
        except Exception:  # noqa: BLE001 - keep the declared shapes
            return
        for slot, vs in outputs.items():
            specs = out_specs.get(slot, [])
            for v, spec in zip(_as_list(vs), specs):
                var = v if isinstance(v, Variable) else self.var(v)
                var.shape, var.dtype = tuple(spec[0]), spec[1]

    def __repr__(self):
        lines = ["Block(%d) {" % self.idx]
        for v in self.vars.values():
            lines.append("  " + repr(v))
        for op in self.ops:
            lines.append("  " + repr(op))
        lines.append("}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------

# op types a for_test clone drops (the backward section and the updates)
_OPTIMIZER_OPS = frozenset({
    "sgd", "momentum", "adam", "adamw", "adamax", "adagrad",
    "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "lamb",
    "lars_momentum", "dpsgd", "backward",
    "fused_sgd", "fused_momentum", "fused_adam",
})
# op types whose `is_test` attr a for_test clone sets
_IS_TEST_OPS = frozenset({"dropout", "batch_norm"})


def _touches_grad(op):
    """Whether `op` reads or writes a gradient (weight decay's ops do):
    a for_test clone, which has no backward section, drops it."""
    return any(n.endswith(GRAD_SUFFIX) for n in op.input_arg_names
               + op.output_arg_names)


class Program:
    """A list of blocks; block 0 is global (reference: framework.py:3852)."""

    _uid_counter = 0

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0  # bumped on mutation; part of the cache key
        # never-reused identity for cache keys (id() can alias after GC)
        Program._uid_counter += 1
        self._uid = Program._uid_counter
        self._is_test = False
        self._seed_counter = 0
        # data parallelism (`CompiledProgram.with_data_parallel`, fleet's
        # `transpile_collective`): the executor runs the program as this
        # process's rank of the world, over the "dp" ring; on a hybrid
        # world over the (dcn, ici) pair of `_mesh`
        # (`parallel/env.create_hybrid_mesh`, decided once for the world
        # whose uid is `_mesh_world`), sharding over "ici"
        self._data_parallel = False
        self._dp_axis = "dp"
        self._dcn_axis = None
        self._mesh = None
        self._mesh_world = None
        # rank 0's seed base of a data-parallel program with random_seed
        # 0, set by the executor at its first run
        self._shared_seed = None

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def block(self, idx) -> Block:
        return self.blocks[idx]

    def _create_block(self, parent_idx=None) -> Block:
        """A new sub-block of the current block (or of `parent_idx`),
        made current."""
        parent = self.current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        self._version += 1
        return b

    def _rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    @property
    def num_blocks(self):
        return len(self.blocks)

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def all_parameters(self):
        return self.global_block().all_parameters()

    def clone(self, for_test=False) -> "Program":
        """A copy; with `for_test`, without the backward section, the ops
        over gradients and the optimizer updates, and with dropout and
        batch_norm in their `is_test` mode (an evaluation program)."""
        p = Program()
        p.random_seed = self.random_seed
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            for name, v in b.vars.items():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[name] = nv
            for op in b.ops:
                if for_test and (op.type in _OPTIMIZER_OPS
                                 or op.attrs.get("_is_backward", False)
                                 or _touches_grad(op)):
                    continue
                nop = Operator(nb, op.type)
                # keep the original creation site for error attribution
                nop._creation_stack = op._creation_stack
                nop.input_names = {k: list(v)
                                   for k, v in op.input_names.items()}
                nop.output_names = {k: list(v)
                                    for k, v in op.output_names.items()}
                nop.attrs = dict(op.attrs)
                if for_test and op.type in _IS_TEST_OPS:
                    nop.attrs["is_test"] = True
                nb.ops.append(nop)
            p.blocks.append(nb)
        p._is_test = for_test
        p._version = self._version
        p._data_parallel = self._data_parallel
        p._dp_axis, p._dcn_axis = self._dp_axis, self._dcn_axis
        p._mesh, p._mesh_world = self._mesh, self._mesh_world
        for attr in ("_amp", "_amp_lists", "_amp_dtype", "_amp_master_of"):
            if hasattr(self, attr):
                setattr(p, attr, getattr(self, attr))
        return p

    def __repr__(self):
        return "\n".join(repr(b) for b in self.blocks)

    __str__ = __repr__


# ---------------------------------------------------------------------------
# default programs + guards (reference: framework.py:5340-5470)
# ---------------------------------------------------------------------------

_main_program_ = Program()
_startup_program_ = Program()


def default_main_program() -> Program:
    return _main_program_


def default_startup_program() -> Program:
    return _startup_program_


def switch_main_program(p: Program) -> Program:
    global _main_program_
    old, _main_program_ = _main_program_, p
    return old


def switch_startup_program(p: Program) -> Program:
    global _startup_program_
    old, _startup_program_ = _startup_program_, p
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    old_start = None
    if startup_program is not None:
        old_start = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_start is not None:
            switch_startup_program(old_start)


@contextlib.contextmanager
def name_scope(prefix=None):
    yield


def _global_seed_and_bump(program: Program):
    """Per-run RNG seed (deterministic when program.random_seed is set;
    with random_seed 0 a data-parallel program counts up from rank 0's
    draw, so every rank draws the same masks)."""
    if program.random_seed:
        s = program.random_seed + program._seed_counter
    elif program._shared_seed is not None:
        s = program._shared_seed + program._seed_counter
    else:
        s = np.random.randint(0, 2**31 - 1)
    program._seed_counter += 1
    return s
