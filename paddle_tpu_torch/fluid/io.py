"""Saving and loading a scope's variables, and the inference model
(counterpart: `paddle_tpu/fluid/io.py`; reference:
`python/paddle/fluid/io.py:224-1669`, `operators/save_op.cc` /
`load_op.cc`, `framework/prune.cc`).

The formats are the reference's (the `.npy` files byte for byte), so
that files cross between the two packages:

- `save_vars` / `save_params` / `save_persistables`: one ``<name>.npy``
  a var (``/`` in a name written as ``%2F``); a bfloat16 var is its bits
  as uint16 with a ``<name>.dtype`` sidecar reading ``bfloat16``. With
  `filename`, one pickle of ``{name: ndarray}`` instead.
- `save` / `load`: ``<path>.pdparams`` (the parameters), ``.pdopt`` (the
  other persistables) and ``.pdmodel`` (the program desc), pickles.
- `save_inference_model`: the pruned program's desc (``__model__``, a
  pickle) beside its persistables.

The port writes its pickles with protocol 4 (`PICKLE_PROTOCOL`) where
the reference writes protocol 2; each reads the other's.

numpy has no bfloat16, and the port never imports ``ml_dtypes``. A
bfloat16 value crosses as a ``torch.bfloat16`` tensor: written as its
uint16 bits, read back from them. In a pickle the reference names the
global ``ml_dtypes.bfloat16`` for each bfloat16 array; every pickle is
read here through a restricted unpickler that admits numpy's array and
dtype reconstruction, maps that global to a marker and so gives a
bfloat16 tensor without ``ml_dtypes``, and refuses any other class. The
port writes a bfloat16 array into a pickle as the same numpy reduction,
the dtype reached through ``importlib.import_module("ml_dtypes")``: the
reference's ``pickle.load`` reads it as its own bfloat16 array, and this
module reads it back without ``ml_dtypes``.

Values land in the scope as tensors on the executor's device, in the
dtype the var holds there (a float32 file loads into a bfloat16 param of
an AMP O2 program as bfloat16). A var the sharded weight update (ZeRO-1)
keeps as this rank's flat slice is saved at its logical shape, gathered
over the world (`parallel/sharded_update.py gather_logical`): that is a
collective, so in a data-parallel world every rank calls the save
functions alike, rank 0 writes, and they return once the files are
there. A load puts the logical value into the scope; the program's next
run lays it out as this rank's slice (`Executor._layout_sharded`), so a
file does not depend on the world or the flag that wrote it. A captured
block's next replay copies the loaded values into its static buffers.
"""
from __future__ import annotations

import codecs
import collections
import os
import pickle
from typing import Dict

import numpy as np
import torch

from . import framework
from .framework import Parameter, Program, Variable
from ..core.scope import global_scope
from ..core.types import is_bf16_array, normalize_dtype, to_torch_dtype
from ..parallel.sharded_update import logical_value

__all__ = [
    "save_vars", "load_vars", "save_params", "load_params",
    "save_persistables", "load_persistables", "save", "load",
    "save_inference_model", "load_inference_model", "prune_program",
    "load_program_state", "set_program_state", "get_program_persistable_vars",
    "get_parameter_value", "get_parameter_value_by_name",
    "get_program_parameter", "is_belong_to_optimizer", "is_persistable",
    "is_parameter",
]


# -- values on the host ----------------------------------------------------

def _host_array(value):
    """(numpy array, sidecar dtype name or None) of a tensor or array; a
    bfloat16 value as its uint16 bits with "bfloat16"."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(
                np.uint16), "bfloat16"
        return t.numpy(), None
    arr = np.asarray(value)
    if is_bf16_array(arr):
        return arr.view(np.uint16), "bfloat16"
    return arr, None


def _bf16_tensor(bits):
    """A CPU bfloat16 tensor of uint16 bits."""
    bits = np.ascontiguousarray(bits)
    return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def _as_tensor(value) -> torch.Tensor:
    """A loaded value (numpy array, ml_dtypes bfloat16 array, tensor) as
    a tensor, bfloat16 bit for bit."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    if is_bf16_array(arr):
        return _bf16_tensor(arr.view(np.uint16))
    return torch.from_numpy(np.array(arr, copy=True))


def _ensure_dir(d):
    if d:
        os.makedirs(d, exist_ok=True)


# -- pickles ---------------------------------------------------------------

class _BF16Array:
    """A bfloat16 array to pickle: its uint16 bits."""

    def __init__(self, bits):
        self.bits = np.ascontiguousarray(bits)


class _Sentinel:
    def __init__(self, name):
        self.name = name


_BF16_DTYPE = _Sentinel("bfloat16 dtype")
_BF16_TYPE = _Sentinel("ml_dtypes.bfloat16")
_ML_DTYPES = _Sentinel("ml_dtypes")
#: the state numpy pickles an ml_dtypes bfloat16 dtype with
_BF16_DTYPE_STATE = (3, "<", None, None, None, 2, 2, 64)


class _Pickler(pickle.Pickler):
    """numpy's own reductions, with bfloat16 arrays written as the
    reference writes them (see the module docstring)."""

    def reducer_override(self, obj):
        if isinstance(obj, _BF16Array):
            fn, args, state = obj.bits.__reduce__()
            return fn, args, (state[0], state[1], _BF16_DTYPE) + state[3:]
        if obj is _BF16_DTYPE:
            return np.dtype, (_BF16_TYPE, False, True), _BF16_DTYPE_STATE
        if obj is _BF16_TYPE:
            return getattr, (_ML_DTYPES, "bfloat16")
        if obj is _ML_DTYPES:
            import importlib

            return importlib.import_module, ("ml_dtypes",)
        return NotImplemented


def _picklable(d):
    """{name: numpy array} with bfloat16 values wrapped for `_Pickler`."""
    out = {}
    for name, v in d.items():
        arr, tag = _host_array(v)
        out[name] = _BF16Array(arr) if tag == "bfloat16" else arr
    return out


#: the pickle protocol the port writes: 4, PaddlePaddle 2.x's
#: `paddle.save` default. The reference writes 2, which carries every
#: array's bytes as latin-1 text: about 1.33x the bytes and 4-6x the
#: time to write and read. Either package reads either protocol.
PICKLE_PROTOCOL = 4


def _dump(obj, f):
    _Pickler(f, protocol=PICKLE_PROTOCOL).dump(obj)


class _BF16Marker:
    """What the unpickler gives for ``ml_dtypes.bfloat16``."""


class _MLDtypesStub:
    bfloat16 = _BF16Marker


class _BF16DtypeStub:
    def __setstate__(self, state):
        pass


def _np_reconstruct():
    return np.zeros(1).__reduce__()[0]


class _ArrayStub:
    """numpy's array reconstruction, deferred: its state gives a numpy
    array, or a bfloat16 tensor where the dtype is bfloat16."""

    value = None

    def __setstate__(self, state):
        version, shape, dtype, fortran, raw = state
        if isinstance(dtype, _BF16DtypeStub):
            bits = np.frombuffer(raw, np.uint16)
            bits = bits.reshape(shape[::-1]).T if fortran else \
                bits.reshape(shape)
            self.value = _bf16_tensor(bits)
            return
        arr = _np_reconstruct()(np.ndarray, (0,), b"b")
        arr.__setstate__(state)
        self.value = arr


def _reconstruct(cls, shape, dtype_char):
    if cls is not np.ndarray:
        raise pickle.UnpicklingError("only numpy arrays may be loaded")
    return _ArrayStub()


def _dtype(obj, align=False, copy=True):
    if obj is _BF16Marker:
        return _BF16DtypeStub()
    return np.dtype(obj, align, copy)


def _scalar(dtype, raw=b""):
    if isinstance(dtype, _BF16DtypeStub):
        return _bf16_tensor(np.frombuffer(raw, np.uint16)).reshape(())
    return np.frombuffer(raw, dtype)[0] if raw else dtype.type()


def _getattr(obj, name):
    if obj is _MLDtypesStub and name == "bfloat16":
        return _BF16Marker
    raise pickle.UnpicklingError("getattr(%r, %r) is not allowed in a "
                                 "checkpoint" % (obj, name))


def _import_module(name):
    if name == "ml_dtypes":
        return _MLDtypesStub
    raise pickle.UnpicklingError("module %r is not allowed in a checkpoint"
                                 % name)


_SAFE_GLOBALS = {
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): _dtype,
    ("_codecs", "encode"): codecs.encode,
    ("builtins", "getattr"): _getattr,
    ("builtins", "set"): set,
    ("builtins", "frozenset"): frozenset,
    ("builtins", "slice"): slice,
    ("builtins", "complex"): complex,
    ("importlib", "import_module"): _import_module,
    ("collections", "OrderedDict"): collections.OrderedDict,
    ("ml_dtypes", "bfloat16"): _BF16Marker,
    ("ml_dtypes._ml_dtypes_ext", "bfloat16"): _BF16Marker,
}
# protocol 2 names Python 3's builtins module as Python 2's
for (_mod, _name), _fn in list(_SAFE_GLOBALS.items()):
    if _mod == "builtins":
        _SAFE_GLOBALS[("__builtin__", _name)] = _fn
for _mod in ("numpy.core.multiarray", "numpy._core.multiarray"):
    _SAFE_GLOBALS[(_mod, "_reconstruct")] = _reconstruct
    _SAFE_GLOBALS[(_mod, "scalar")] = _scalar


class _Unpickler(pickle.Unpickler):
    """Admits numpy arrays, dtypes and scalars, Python's containers and
    the bfloat16 forms (see the module docstring); any other global
    raises."""

    def find_class(self, module, name):
        fn = _SAFE_GLOBALS.get((module, name))
        if fn is None:
            raise pickle.UnpicklingError(
                "global %s.%s is not allowed in a checkpoint" % (module,
                                                                 name))
        return fn


def _resolve(obj):
    if isinstance(obj, _ArrayStub):
        return obj.value
    if isinstance(obj, dict):
        return type(obj)((k, _resolve(v)) for k, v in obj.items())
    if isinstance(obj, list):
        return [_resolve(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_resolve(v) for v in obj)
    return obj


def _load_pickle(path):
    """A pickle written by either package: numpy arrays, with bfloat16
    ones as CPU ``torch.bfloat16`` tensors."""
    with open(path, "rb") as f:
        return _resolve(_Unpickler(f).load())


# -- directories of vars ---------------------------------------------------

def _save_dict(dirname, d, filename=None):
    """Write {name: tensor or array} under `dirname`: one pickle named
    `filename`, or one .npy a var (with the bfloat16 sidecar)."""
    _ensure_dir(dirname)
    if filename:
        with open(os.path.join(dirname, filename), "wb") as f:
            _dump(_picklable(d), f)
        return
    for name, value in d.items():
        arr, tag = _host_array(value)
        safe = name.replace("/", "%2F")
        path = os.path.join(dirname, safe + ".npy")
        sidecar = os.path.join(dirname, safe + ".dtype")
        np.save(path, arr, allow_pickle=False)
        if tag is not None:
            with open(sidecar, "w") as f:
                f.write(tag)
        elif os.path.exists(sidecar):
            os.remove(sidecar)


def _np_load(path):
    arr = np.load(path, allow_pickle=False)
    sidecar = path[:-4] + ".dtype"
    if not os.path.exists(sidecar):
        return arr
    with open(sidecar) as f:
        tag = f.read().strip()
    if tag != "bfloat16":
        raise ValueError("%s: stored dtype %r is not supported" % (path,
                                                                   tag))
    return _bf16_tensor(arr.view(np.uint16))


def _load_dict(dirname, names=None, filename=None):
    """{name: numpy array or bfloat16 tensor} from `dirname` (all of it,
    or the `names` present)."""
    if filename:
        return _load_pickle(os.path.join(dirname, filename))
    out = {}
    if names is not None:
        for name in names:
            p = os.path.join(dirname, name.replace("/", "%2F") + ".npy")
            if os.path.exists(p):
                out[name] = _np_load(p)
    else:
        for fn in sorted(os.listdir(dirname)):
            if fn.endswith(".npy"):
                out[fn[:-4].replace("%2F", "/")] = _np_load(
                    os.path.join(dirname, fn))
    return out


# -- the scope ---------------------------------------------------------------

def _main(program):
    """`program` (default: the default main program), a CompiledProgram
    unwrapped."""
    from .compiler import CompiledProgram

    program = program or framework.default_main_program()
    return program._unwrap() if isinstance(program, CompiledProgram) \
        else program


def _program_vars(program, predicate):
    """Names of `program`'s vars that `predicate` takes, once each, in
    the program's order (every rank's order)."""
    out = collections.OrderedDict()
    for var in program.list_vars():
        if predicate(var) and var.name not in out:
            out[var.name] = var
    return out


def _collect(program, predicate, scope, names=None):
    """{name: tensor at its logical shape} of the scope's values of
    `names` (default: `program`'s vars that `predicate` takes)."""
    if names is None:
        names = list(_program_vars(program, predicate))
    vals = {}
    for name in names:
        v = scope.find_var(name)
        if isinstance(v, torch.Tensor):
            vals[name] = logical_value(program, name, v)
    return vals


def _dp_ring(program):
    """The ring of a data-parallel `program` in a world of more than one
    rank, else None."""
    from ..parallel import env as penv

    ring = penv.program_ring(program) if program._data_parallel else None
    return ring if ring is not None and ring.size > 1 else None


def _barrier(ring):
    if ring is not None:
        import torch.distributed as dist

        dist.barrier(group=ring.group)


def _writer(program):
    """(whether this process writes, the ring to wait on): in a
    data-parallel world rank 0 writes; elsewhere every process."""
    ring = _dp_ring(program)
    return ring is None or ring.rank == 0, ring


def _device_of(executor, scope, names):
    """Where loaded values go: the executor's device, else that of the
    scope's values (of `names` first), else the default place (the
    card)."""
    dev = getattr(executor, "device", None)
    if dev is not None:
        return dev
    for n in list(names) + scope.local_var_names():
        v = scope.find_var(n)
        if isinstance(v, torch.Tensor):
            return v.device
    return framework._current_expected_place().torch_device()


def _bind(program, scope, values, device):
    """Set each of {name: value} in `scope` as a new tensor on `device`,
    in the dtype the scope's current value has (else the program var's
    on the device, else the value's own), so that a captured block's
    next replay takes it. A logical value for a var the scope holds as a
    flat slice stays logical: the next run lays it out."""
    block = program.global_block()
    for n, v in values.items():
        t = _as_tensor(v)
        cur = scope.find_var(n)
        var = block._find_var_recursive(n)
        if isinstance(cur, torch.Tensor):
            dtype = cur.dtype
        elif var is not None:
            dtype = to_torch_dtype(var.dtype)
        else:
            dtype = to_torch_dtype(normalize_dtype(t.dtype))
        scope.set_var(n, t.to(device=device, dtype=dtype, copy=True))


def is_persistable(var):
    return var.persistable


def is_parameter(var):
    return isinstance(var, Parameter)


def _var_names(vars):
    return [v.name if isinstance(v, Variable) else v for v in vars]


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Write the scope's values of `vars` (or of the program's vars that
    `predicate` takes) to `dirname`: one .npy a var, or one pickle named
    `filename`. Sharded state is gathered to its logical shape; in a
    data-parallel world every rank calls this, rank 0 writes."""
    program = _main(main_program)
    scope = global_scope()
    names = _var_names(vars) if vars is not None else None
    d = _collect(program, predicate or is_persistable, scope, names)
    writes, ring = _writer(program)
    if writes:
        _save_dict(dirname, d, filename)
    _barrier(ring)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Load `vars` (or the program's vars that `predicate` takes) from
    `dirname` into the scope; a var the files lack raises."""
    program = _main(main_program)
    scope = global_scope()
    if vars is not None:
        names = _var_names(vars)
    else:
        names = list(_program_vars(program, predicate or is_persistable))
    d = _load_dict(dirname, names, filename)
    missing = [n for n in names if n not in d]
    if missing:
        raise RuntimeError("checkpoint at %r is missing vars %s"
                           % (dirname, missing))
    _bind(program, scope, {n: d[n] for n in names},
          _device_of(executor, scope, names))


def save_persistables(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=is_persistable,
              filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=is_persistable,
              filename=filename)


def save_params(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=is_parameter,
              filename=filename)


def load_params(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=is_parameter,
              filename=filename)


# -- program state (reference: io.py:1605 fluid.save / :1669 load) ----------

def save(program, model_path):
    """``<model_path>.pdparams`` (parameters), ``.pdopt`` (the other
    persistables) and ``.pdmodel`` (the program desc). In a
    data-parallel world every rank calls this, rank 0 writes."""
    program = _main(program)
    scope = global_scope()
    params = _collect(program, is_parameter, scope)
    others = {k: v for k, v in _collect(program, is_persistable,
                                        scope).items() if k not in params}
    writes, ring = _writer(program)
    if writes:
        _ensure_dir(os.path.dirname(model_path) or ".")
        with open(model_path + ".pdparams", "wb") as f:
            _dump(_picklable(params), f)
        with open(model_path + ".pdopt", "wb") as f:
            _dump(_picklable(others), f)
        with open(model_path + ".pdmodel", "wb") as f:
            _dump(_program_to_desc(program), f)
    _barrier(ring)


def load(program, model_path, executor=None, var_list=None):
    """Load ``.pdparams`` and ``.pdopt`` (where present) into the scope
    (only the vars of `var_list`, if given)."""
    program = _main(program)
    scope = global_scope()
    keep = set(_var_names(var_list)) if var_list else None
    values = {}
    for suffix in (".pdparams", ".pdopt"):
        p = model_path + suffix
        if os.path.exists(p):
            values.update((k, v) for k, v in _load_pickle(p).items()
                          if keep is None or k in keep)
    _bind(program, scope, values, _device_of(executor, scope, values))


# -- inference model export (reference: io.py:1100) -------------------------

def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         program_only=False):
    """The program pruned to what `target_vars` need from the feeds
    (``__model__`` or `model_filename`) and its persistables (one .npy a
    var, or one pickle `params_filename`). In a data-parallel world every
    rank calls this, rank 0 writes. Returns the targets' names."""
    program = _main(main_program)
    fetch_names = [v.name if isinstance(v, Variable) else v
                   for v in target_vars]
    inference_program = prune_program(program, feeded_var_names,
                                      fetch_names)
    desc = _program_to_desc(inference_program)
    desc["_feed_names"] = list(feeded_var_names)
    desc["_fetch_names"] = fetch_names
    params = {} if program_only else _collect(
        inference_program, is_persistable, global_scope())
    writes, ring = _writer(program)
    if writes:
        _ensure_dir(dirname)
        with open(os.path.join(dirname, model_filename or "__model__"),
                  "wb") as f:
            _dump(desc, f)
        if not program_only:
            _save_dict(dirname, params, params_filename)
    _barrier(ring)
    return fetch_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """(program, feed names, fetch vars) of a saved inference model, its
    persistables loaded into the scope on the executor's device."""
    desc = _load_pickle(os.path.join(dirname, model_filename or "__model__"))
    program = _desc_to_program(desc)
    feed_names = desc.get("_feed_names", [])
    fetch_names = desc.get("_fetch_names", [])
    scope = global_scope()
    persist_names = [v.name for v in program.list_vars() if v.persistable]
    d = _load_dict(dirname, persist_names, params_filename)
    _bind(program, scope, d, _device_of(executor, scope, persist_names))
    fetch_targets = [program.global_block().var(n) for n in fetch_names]
    return program, feed_names, fetch_targets


# -- program (de)serialization (reference: framework.proto round trip) ------

def _amp_desc(program):
    """The AMP policy the lowering applies (not in the reference's desc,
    which its loader ignores): the loaded program then casts as the
    saved one did."""
    lists = getattr(program, "_amp_lists", None)
    if not getattr(program, "_amp", False) or lists is None:
        return None
    return {"dtype": getattr(program, "_amp_dtype", "bfloat16"),
            "white_list": sorted(lists.white_list),
            "black_list": sorted(lists.black_list),
            "gray_list": sorted(getattr(lists, "gray_list", ()) or ()),
            "black_varnames": sorted(getattr(lists, "black_varnames", ())
                                     or ())}


def _program_to_desc(program: Program) -> dict:
    blocks = []
    for b in program.blocks:
        vars_d = []
        for v in b.vars.values():
            vars_d.append({
                "name": v.name, "shape": list(v.shape), "dtype": v.dtype,
                "persistable": v.persistable,
                "stop_gradient": v.stop_gradient,
                "is_parameter": isinstance(v, Parameter),
                "trainable": getattr(v, "trainable", True),
                "is_data": v.is_data,
            })
        ops_d = [{"type": op.type, "inputs": op.input_names,
                  "outputs": op.output_names, "attrs": op.attrs}
                 for op in b.ops]
        blocks.append({"idx": b.idx, "parent_idx": b.parent_idx,
                       "vars": vars_d, "ops": ops_d})
    desc = {"blocks": blocks, "random_seed": program.random_seed,
            "version": 1}
    amp = _amp_desc(program)
    if amp is not None:
        desc["amp"] = amp
    return desc


def _desc_to_program(desc: dict) -> Program:
    p = Program()
    p.random_seed = desc.get("random_seed", 0)
    p.blocks = []
    for bd in desc["blocks"]:
        b = framework.Block(p, bd["idx"], bd["parent_idx"])
        for vd in bd["vars"]:
            if vd.get("is_parameter"):
                v = Parameter(b, shape=vd["shape"], dtype=vd["dtype"],
                              name=vd["name"],
                              trainable=vd.get("trainable", True))
            else:
                v = Variable(b, name=vd["name"], shape=vd["shape"],
                             dtype=vd["dtype"],
                             persistable=vd["persistable"],
                             stop_gradient=vd.get("stop_gradient", False),
                             is_data=vd.get("is_data", False))
            b.vars[v.name] = v
        for od in bd["ops"]:
            op = framework.Operator(b, od["type"])
            op.input_names = {k: list(v) for k, v in od["inputs"].items()}
            op.output_names = {k: list(v) for k, v in od["outputs"].items()}
            op.attrs = dict(od["attrs"])
            b.ops.append(op)
        p.blocks.append(b)
    amp = desc.get("amp")
    if amp is not None:
        from .contrib.mixed_precision.fp16_lists import \
            AutoMixedPrecisionLists

        lists = AutoMixedPrecisionLists()
        lists.white_list = set(amp["white_list"])
        lists.black_list = set(amp["black_list"])
        lists.gray_list = set(amp["gray_list"])
        lists.black_varnames = set(amp["black_varnames"])
        p._amp, p._amp_lists, p._amp_dtype = True, lists, amp["dtype"]
    p._version = 1
    return p


def prune_program(program: Program, feed_names, fetch_names) -> Program:
    """The program pruned to the ops the fetches need (reference:
    framework/prune.cc), without the backward and the updates: a
    for_test clone, then, from the last op back, each op that writes a
    needed var (looking through control flow's sub-blocks)."""
    from .lowering import _op_reads_writes

    pruned = program.clone(for_test=True)
    block = pruned.global_block()
    needed = set(fetch_names)
    keep = []
    for op in reversed(block.ops):
        if op.type == "backward":
            continue
        reads, writes = _op_reads_writes(op)
        if set(writes) & needed:
            keep.append(op)
            needed |= set(reads)
    block.ops = list(reversed(keep))
    pruned._version += 1
    return pruned


def get_program_persistable_vars(program):
    return [v for v in program.list_vars() if v.persistable]


def get_parameter_value(para, executor=None):
    """The scope's value of a parameter on the host: a numpy array, a
    bfloat16 one as a CPU tensor (reference: io.py get_parameter_value)."""
    v = global_scope().find_var(para.name)
    if v is None:
        raise ValueError(
            "parameter %r is absent from the scope — run the startup "
            "program" % para.name)
    return _host_value(v)


def _host_value(v):
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(v)


def get_parameter_value_by_name(name, executor=None, program=None):
    """reference: io.py get_parameter_value_by_name."""
    program = program or framework.default_main_program()
    var = program.global_block()._find_var_recursive(name)
    if var is None:
        raise ValueError("no parameter named %r in the program" % name)
    return get_parameter_value(var, executor)


def get_program_parameter(program):
    """All Parameter vars of a program (reference: io.py
    get_program_parameter)."""
    return list(program.all_parameters())


def is_belong_to_optimizer(var):
    """Optimizer state: accumulators are named
    '<OptimizerClass>_<n>_<param>_<slot>_<n>', so the marker is the
    'Optimizer_' class-name segment (plus the learning-rate var)."""
    name = getattr(var, "name", "")
    return bool(getattr(var, "persistable", False)) and (
        "Optimizer_" in name or name.startswith("learning_rate"))


def load_program_state(model_path, var_list=None) -> Dict[str, object]:
    """A `fluid.save` archive (``.pdparams`` and ``.pdopt`` merged), or a
    directory of per-var files, as {name: numpy array}, without touching
    the scope; a bfloat16 value is a CPU ``torch.bfloat16`` tensor
    (numpy has no bfloat16). Reference: io.py load_program_state."""
    names = set(v.name for v in var_list) if var_list else None

    def filt(d):
        return (d if names is None
                else {k: v for k, v in d.items() if k in names})

    if os.path.isdir(model_path):
        return filt(_load_dict(model_path,
                               sorted(names) if names else None))
    d = os.path.dirname(model_path) or "."
    f = os.path.basename(model_path)
    state = {}
    found = False
    for suffix in (".pdparams", ".pdopt", ""):
        cand = os.path.join(d, f + suffix)
        if suffix == "" and found:
            continue
        if os.path.isfile(cand):
            state.update(filt(_load_pickle(cand)))
            found = True
    if not found:
        raise IOError("no saved program state at %r" % model_path)
    return state


def set_program_state(program, state_dict):
    """Bind {name: array or tensor} into the scope for the program's
    persistable vars, on the device and in the dtype each holds there;
    returns the entries the program has no persistable var for
    (reference: io.py set_program_state)."""
    program = _main(program)
    scope = global_scope()
    unused = dict(state_dict)
    take = {}
    for var in program.list_vars():
        if getattr(var, "persistable", False) and var.name in unused:
            take[var.name] = unused.pop(var.name)
    _bind(program, scope, take, _device_of(None, scope, list(take)))
    return unused
