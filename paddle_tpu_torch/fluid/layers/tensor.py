"""Tensor layers of the slice (counterpart:
`paddle_tpu/fluid/layers/tensor.py`): `data`, `fill_constant`,
`fill_constant_batch_size_like`, `cast`, `assign` (of a var, or of a
numpy array as `assign_value`), `create_parameter`, `create_global_var`,
`reshape`, `transpose`, `scale`, `take_along_axis`, `cumsum`, `concat`,
`create_tensor`, `argmax`, `argmin`, `argsort`, `zeros`, `ones`,
`zeros_like`, `ones_like`, `reverse`, `range`, `linspace`, `shape`,
`eye`, `diag`, `tril` and `triu` (`tensor_array_to_tensor` waits for
the array ops)."""
from __future__ import annotations

import numpy as np

from .. import framework
from ...core.types import normalize_dtype
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper, apply_op

__all__ = ["data", "fill_constant", "fill_constant_batch_size_like", "cast",
           "assign", "create_parameter", "create_global_var", "reshape",
           "transpose", "scale", "take_along_axis", "cumsum", "concat",
           "create_tensor", "argmax", "argmin", "argsort", "zeros", "ones",
           "zeros_like", "ones_like", "reverse", "range", "linspace",
           "shape", "eye", "diag", "tril", "triu"]


def _single(op_type, inputs, attrs, dtype=None):
    return apply_op(op_type, op_type, inputs, attrs, ["Out"],
                    out_dtype=dtype)[0]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True, type=None):
    """Declare an input variable (reference: layers/io.py data /
    fluid.data). With append_batch_size, -1 is prepended."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = framework.default_main_program().current_block()
    return block.create_var(
        name=name, shape=shape, dtype=dtype, is_data=True,
        stop_gradient=stop_gradient, persistable=False,
        lod_level=lod_level)


def fill_constant(shape, dtype, value, force_cpu=False, out=None,
                  name=None):
    """A `shape` var of `dtype` filled with `value` (no gradient)."""
    dtype = normalize_dtype(dtype)
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value)})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    """`fill_constant` whose dim `output_dim_idx` follows `input`'s dim
    `input_dim_idx` at run time."""
    return _single("fill_constant_batch_size_like", {"Input": [input]},
                   {"shape": list(shape), "dtype": normalize_dtype(dtype),
                    "value": float(value), "input_dim_idx": input_dim_idx,
                    "output_dim_idx": output_dim_idx}, dtype=dtype)


def cast(x, dtype):
    dtype = normalize_dtype(dtype)
    return _single("cast", {"X": [x]}, {"out_dtype": dtype}, dtype=dtype)


def assign(input, output=None):
    """`output = input` (the `assign` op). Inside a loop body,
    ``assign(new_x, output=x)`` rebinds the carry `x`. A numpy array
    becomes an `assign_value` op holding its values in the program."""
    if isinstance(input, np.ndarray):
        attrs = {"shape": list(input.shape),
                 "dtype": normalize_dtype(input.dtype)}
        key = ("fp32_values" if input.dtype in (np.float32, np.float64)
               else "int32_values" if input.dtype == np.int32
               else "int64_values")
        attrs[key] = input.astype(
            "float64" if "fp" in key else input.dtype).flatten().tolist()
        helper = LayerHelper("assign_value")
        out = output or helper.create_variable_for_type_inference(
            normalize_dtype(input.dtype))
        helper.append_op(type="assign_value", outputs={"Out": [out]},
                         attrs=attrs)
        return out
    helper = LayerHelper("assign")
    out = output or helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="assign", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..param_attr import ParamAttr

    helper = LayerHelper("create_parameter")
    if attr is None:
        attr = ParamAttr(name=name)
    elif name is not None and attr.name is None:
        attr.name = name
    return helper.create_parameter(attr, list(shape), dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global-block var of `shape` that the startup program fills with
    `value`."""
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        name=name or framework.unique_name("global_var"),
        shape=list(shape), dtype=dtype, persistable=persistable)
    helper.set_variable_initializer(var, ConstantInitializer(value))
    return var


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    return apply_op("reshape2", "reshape2", {"X": [x]},
                    {"shape": [int(s) for s in shape]}, ["Out", "XShape"],
                    out_dtype=x.dtype)[0]


def transpose(x, perm, name=None):
    return apply_op("transpose2", "transpose2", {"X": [x]},
                    {"axis": list(perm)}, ["Out", "XShape"],
                    out_dtype=x.dtype)[0]


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    out = _single("scale", {"X": [x]},
                  {"scale": float(scale), "bias": float(bias),
                   "bias_after_scale": bias_after_scale}, dtype=x.dtype)
    if act:
        out = _single(act, {"X": [out]}, {}, dtype=x.dtype)
    return out


def take_along_axis(input, index, axis, name=None):
    """out[..., i, ...] = input[..., index[..., i, ...], ...] along
    `axis` (numpy's take_along_axis)."""
    return apply_op("take_along_axis", "take_along_axis",
                    {"Input": [input], "Index": [index]},
                    {"Axis": int(axis)}, ["Result"],
                    out_dtype=input.dtype)[0]


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    return _single("cumsum", {"X": [x]},
                   {"axis": axis, "exclusive": exclusive, "reverse": reverse},
                   dtype=x.dtype)


def concat(input, axis=0, name=None):
    return _single("concat", {"X": list(input)}, {"axis": axis},
                   dtype=input[0].dtype)


def create_tensor(dtype, name=None, persistable=False):
    block = framework.default_main_program().current_block()
    return block.create_var(name=name, dtype=dtype, persistable=persistable,
                            shape=())


def argmax(x, axis=0, name=None):
    return _single("arg_max", {"X": [x]}, {"axis": axis}, dtype="int64")


def argmin(x, axis=0, name=None):
    return _single("arg_min", {"X": [x]}, {"axis": axis}, dtype="int64")


def argsort(input, axis=-1, descending=False, name=None):
    outs = apply_op("argsort", "argsort", {"X": [input]},
                    {"axis": axis, "descending": descending},
                    ["Out", "Indices"], out_dtype=input.dtype)
    return outs[0], outs[1]


def zeros(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros_like(x, out=None):
    return _single("fill_any_like", {"X": [x]}, {"value": 0.0, "dtype": -1},
                   dtype=x.dtype)


def ones_like(x, out=None):
    return _single("fill_any_like", {"X": [x]}, {"value": 1.0, "dtype": -1},
                   dtype=x.dtype)


def reverse(x, axis):
    return _single("flip", {"X": [x]},
                   {"axis": list(axis) if isinstance(axis, (list, tuple))
                    else [axis]}, dtype=x.dtype)


def range(start, end, step, dtype="float32"):
    """[start, end) by step; each bound a Variable or a number (filled
    into a [1] var). The `range` op is host-side: a block holding it
    runs eagerly."""
    s, e, st = (v if isinstance(v, framework.Variable)
                else fill_constant([1], dtype, v) for v in (start, end, step))
    return _single("range", {"Start": [s], "End": [e], "Step": [st]}, {},
                   dtype=dtype)


def linspace(start, stop, num, dtype="float32"):
    s = fill_constant([1], dtype, start)
    e = fill_constant([1], dtype, stop)
    n = fill_constant([1], "int32", num)
    return _single("linspace", {"Start": [s], "Stop": [e], "Num": [n]},
                   {"dtype": dtype}, dtype=dtype)


def shape(input):
    return _single("shape", {"Input": [input]}, {}, dtype="int32")


def eye(num_rows, num_columns=None, batch_shape=None, dtype="float32"):
    return _single("eye", {}, {"num_rows": num_rows,
                               "num_columns": num_columns or -1,
                               "dtype": normalize_dtype(dtype)}, dtype=dtype)


def diag(diagonal):
    return _single("diag_v2", {"X": [diagonal]}, {"offset": 0},
                   dtype=diagonal.dtype)


def tril(x, diagonal=0, name=None):
    return _single("tril_triu", {"X": [x]},
                   {"diagonal": diagonal, "lower": True}, dtype=x.dtype)


def triu(x, diagonal=0, name=None):
    return _single("tril_triu", {"X": [x]},
                   {"diagonal": diagonal, "lower": False}, dtype=x.dtype)
