"""Tensor layers of the slice (counterpart:
`paddle_tpu/fluid/layers/tensor.py`): `data`, `assign`,
`create_parameter`, `create_global_var`, `reshape`, `transpose`, `scale`
and `take_along_axis`."""
from __future__ import annotations

from .. import framework
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper, apply_op

__all__ = ["data", "assign", "create_parameter", "create_global_var",
           "reshape", "transpose", "scale", "take_along_axis"]


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


def assign(input, output=None):
    """`output = input` (the `assign` op). Inside a scan body,
    ``assign(new_x, output=x)`` rebinds the loop carry `x`. Numpy inputs
    (`assign_value`) are not ported."""
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
