"""LayerHelper: shared plumbing for the layers.* builders (counterpart:
`paddle_tpu/fluid/layer_helper.py`, without its dygraph branch). Creates
parameters (appending their init op to the startup program) and
intermediate output vars, and appends ops to the main program."""
from __future__ import annotations

from . import framework
from .framework import unique_name
from .initializer import (
    _global_bias_initializer, _global_weight_initializer,
)
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name else unique_name(layer_type)

    @property
    def main_program(self):
        return framework.default_main_program()

    @property
    def startup_program(self):
        return framework.default_startup_program()

    @property
    def main_block(self):
        return self.main_program.current_block()

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    def multiple_param_attr(self, length):
        """One param attr an input: a named attr names only the first, its
        copies auto-name (reusing the name would alias every weight)."""
        attr = self.param_attr
        if isinstance(attr, ParamAttr):
            attr = [attr] + [ParamAttr(**{
                k: v for k, v in attr.__dict__.items() if k != "name"})
                for _ in range(length - 1)]
        return attr

    # -- creation ----------------------------------------------------------
    def create_parameter(self, attr, shape, dtype="float32", is_bias=False,
                         default_initializer=None, stop_gradient=False):
        if attr is False:
            return None
        attr = ParamAttr._to_attr(attr)
        if attr.name is None:
            attr.name = unique_name(".".join([self.name, "w" if not is_bias
                                              else "b"]))
        init = attr.initializer or default_initializer or (
            _global_bias_initializer() if is_bias
            else _global_weight_initializer())
        main_block = self.main_program.global_block()
        param = main_block.create_parameter(
            shape=shape, dtype=dtype, **attr._to_kwargs())
        # mirror var in the startup program + its init op there
        startup_block = self.startup_program.global_block()
        s_param = startup_block.create_var(
            name=param.name, shape=shape, dtype=dtype, persistable=True)
        init(s_param, startup_block)
        return param

    def create_variable_for_type_inference(self, dtype="float32",
                                           stop_gradient=False):
        return self.main_block.create_var(
            name=unique_name(".".join([self.name, "tmp"])),
            dtype=dtype, shape=(), stop_gradient=stop_gradient)

    def create_global_variable(self, persistable=True, **kwargs):
        return self.main_program.global_block().create_var(
            persistable=persistable, **kwargs)

    def set_variable_initializer(self, var, initializer):
        startup_block = self.startup_program.global_block()
        s_var = startup_block.create_var(
            name=var.name, shape=var.shape, dtype=var.dtype,
            persistable=True)
        initializer(s_var, startup_block)

    # -- op dispatch -------------------------------------------------------
    def append_op(self, **kwargs):
        return self.main_block.append_op(**kwargs)

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        bias_attr = self.bias_attr
        if bias_attr is False or bias_attr is None:
            return input_var
        size = list(input_var.shape[dim_start:dim_end])
        b = self.create_parameter(bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [out]},
            attrs={"axis": dim_start})
        return out

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act_type = act.pop("type")
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [out]}, attrs=act)
        return out


def apply_op(helper_or_type, op_type, inputs, attrs, out_slots,
             out_dtype=None):
    """Append `op_type` with one new var per output slot (a list of slot
    names, or a dict slot -> count). Returns the output vars in slot
    order."""
    helper = (helper_or_type if isinstance(helper_or_type, LayerHelper)
              else LayerHelper(op_type))
    outs = {}
    flat = []
    counts = out_slots if isinstance(out_slots, dict) \
        else dict.fromkeys(out_slots, 1)
    for slot, n in counts.items():
        vs = [helper.create_variable_for_type_inference(
            out_dtype or "float32") for _ in range(n)]
        outs[slot] = vs
        flat.extend(vs)
    helper.append_op(type=op_type, inputs=inputs, outputs=outs, attrs=attrs)
    return flat
