"""The QAT program rewrites (counterpart:
`paddle_tpu/fluid/contrib/slim/quantization/quantization_pass.py`;
reference: contrib/slim/quantization/quantization_pass.py).

`QuantizationTransformPass` puts fake quantize/dequantize ops before the
weight and activation inputs of the quantizable ops (conv2d,
depthwise_conv2d, mul, matmul, matmul_v2); `OutScaleForTrainingPass`
tracks each tracked op's output abs-max in a persistable state;
`OutScaleForInferencePass` writes those as `out_threshold` attrs;
`QuantizationFreezePass` turns a trained QAT program into its int8
inference form. The fake-quant ops carry straight-through gradients
(`ops/quant_ops.py`), and their scale state is persistable, so a QAT
step is captured like any other.

The freeze pass snaps each quantized weight to the int8 grid in place:
it writes the snapped values into the tensor the scope already holds
(`copy_`), as EMA's `apply()` does, so a captured step that holds that
tensor sees them (the reference rebinds the scope entry). The
per-channel scales become `weight_quant_scale` attrs on the consumer
op, which ignores them when it runs, as in the reference.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ....framework import Operator
from .... import framework
from .....core.types import to_numpy


_QUANTIZABLE = ("conv2d", "depthwise_conv2d", "mul", "matmul",
                "matmul_v2")
_WEIGHT_SLOTS = {"conv2d": "Filter", "depthwise_conv2d": "Filter",
                 "mul": "Y", "matmul": "Y", "matmul_v2": "Y"}
_INPUT_SLOTS = {"conv2d": "Input", "depthwise_conv2d": "Input",
                "mul": "X", "matmul": "X", "matmul_v2": "X"}
# channel axis of the weight tensor (conv filters are [oc, ic, kh, kw];
# mul/matmul weights are [in, out] — per-OUT-channel is axis 1). This
# goes beyond the reference, whose per-channel path covers only 4-D
# conv filters (always dim 0, no quant_axis attr in this version):
# per-out-channel quantization of mul/matmul weights is an extension.
# Custom `quantizable_op_type` entries outside this table default to
# axis 0 via `.get(op.type, 0)`.
_W_QUANT_AXIS = {"conv2d": 0, "depthwise_conv2d": 0, "mul": 1,
                 "matmul": 1, "matmul_v2": 1}
# ops whose output scale equals their input scale: OutScaleForInference
# propagates out_threshold through them (reference: freeze-pass scale
# propagation over the _op_real_in_out_name identity list)
_SCALE_INVARIANT = ("relu", "relu6", "reshape", "reshape2", "transpose",
                    "transpose2", "flatten", "flatten2", "squeeze",
                    "squeeze2", "unsqueeze", "unsqueeze2", "pool2d")


class QuantizationTransformPass:
    def __init__(self, scope=None, place=None, weight_bits=8,
                 activation_bits=8,
                 activation_quantize_type="moving_average_abs_max",
                 weight_quantize_type="abs_max",
                 quantizable_op_type=_QUANTIZABLE, moving_rate=0.9,
                 skip_pattern="skip_quant"):
        self._wbits = weight_bits
        self._abits = activation_bits
        self._act_type = activation_quantize_type
        self._w_type = weight_quantize_type
        self._ops = tuple(quantizable_op_type)
        self._rate = moving_rate
        self._skip = skip_pattern

    def apply(self, program, startup_program=None):
        """Insert fake quant/dequant before each quantizable op's weight
        and activation inputs. Returns the (mutated) program."""
        startup = startup_program or framework.default_startup_program()
        block = program.global_block()
        new_ops: List[Operator] = []
        quantized_acts = {}
        for op in list(block.ops):
            if op.type in self._ops and not op.attrs.get(self._skip) \
                    and not op.attrs.get("skip_quant"):
                # custom quantizable_op_type outside the builtin five:
                # default to the generic X (activation) / Y (weight)
                # slots and per-channel axis 0
                for slot, maker in (
                        (_INPUT_SLOTS.get(op.type, "X"),
                         self._quant_act),
                        (_WEIGHT_SLOTS.get(op.type, "Y"),
                         self._quant_weight)):
                    names = op.input_names.get(slot)
                    if not names:
                        continue
                    src = names[0]
                    v = block._find_var_recursive(src)
                    if v is None or str(v.dtype) not in (
                            "float32", "float16", "bfloat16"):
                        continue
                    key = (src, maker is self._quant_weight)
                    if key not in quantized_acts:
                        if maker is self._quant_weight:
                            quantized_acts[key] = maker(
                                block, startup, src, v, new_ops,
                                quant_axis=_W_QUANT_AXIS.get(
                                    op.type, 0))
                        else:
                            quantized_acts[key] = maker(
                                block, startup, src, v, new_ops)
                    op.input_names[slot] = [quantized_acts[key]]
            new_ops.append(op)
        block.ops[:] = new_ops
        program._version += 1
        return program

    def _quant_weight(self, block, startup, src, v, new_ops,
                      quant_axis=0):
        out = block.create_var(name=src + ".quantized",
                               shape=v.shape, dtype=v.dtype,
                               stop_gradient=False)
        channel_wise = self._w_type == "channel_wise_abs_max"
        # per-channel: one scale per slice along quant_axis (the
        # reference's per-channel conv weight quantization in the
        # TRANSFORM, not just at freeze)
        scale_shape = ([int(v.shape[quant_axis])] if channel_wise
                       else [1])
        scale = block.create_var(name=src + ".quant_scale",
                                 shape=scale_shape, dtype="float32",
                                 stop_gradient=True)
        op_type = ("fake_channel_wise_quantize_abs_max" if channel_wise
                   else "fake_quantize_abs_max")
        attrs = {"bit_length": self._wbits}
        if channel_wise:
            attrs["quant_axis"] = quant_axis
        new_ops.append(Operator(
            block, op_type, inputs={"X": [src]},
            outputs={"Out": [out.name], "OutScale": [scale.name]},
            attrs=attrs))
        return out.name

    def _quant_act(self, block, startup, src, v, new_ops):
        out = block.create_var(name=src + ".quantized",
                               shape=v.shape, dtype=v.dtype,
                               stop_gradient=False)
        if self._act_type == "moving_average_abs_max":
            state = block.create_var(name=src + ".quant_state",
                                     shape=[1], dtype="float32",
                                     persistable=True,
                                     stop_gradient=True)
            sblock = startup.global_block()
            sblock.create_var(name=state.name, shape=[1],
                              dtype="float32", persistable=True)
            sblock.append_op(type="fill_constant", inputs={},
                             outputs={"Out": [state.name]},
                             attrs={"shape": [1], "dtype": "float32",
                                    "value": 0.0})
            new_ops.append(Operator(
                block, "fake_quantize_moving_average_abs_max",
                inputs={"X": [src], "InScale": [state.name]},
                outputs={"Out": [out.name], "OutScale": [state.name]},
                attrs={"bit_length": self._abits,
                       "moving_rate": self._rate}))
        else:
            # persistable OutScale: the executor then writes each
            # batch's scale back to scope, so FreezePass can bake the
            # last calibrated value in as static_scale (a dead
            # non-persistable OutScale never reaches scope)
            scale = block.create_var(name=src + ".quant_scale",
                                     shape=[1], dtype="float32",
                                     persistable=True,
                                     stop_gradient=True)
            sblock = startup.global_block()
            sblock.create_var(name=scale.name, shape=[1],
                              dtype="float32", persistable=True)
            sblock.append_op(type="fill_constant", inputs={},
                             outputs={"Out": [scale.name]},
                             attrs={"shape": [1], "dtype": "float32",
                                    "value": 0.0})
            new_ops.append(Operator(
                block, "fake_quantize_abs_max", inputs={"X": [src]},
                outputs={"Out": [out.name], "OutScale": [scale.name]},
                attrs={"bit_length": self._abits}))
        return out.name


class OutScaleForTrainingPass:
    """Track the moving-average abs-max of every quantizable op's
    output activation in a persistable state var (reference:
    OutScaleForTrainingPass — it feeds out_threshold at inference).
    The tracker op's OutScale writes a persistable var, so lowering
    keeps it as block state; the passthrough Out is left dangling."""

    _TRACKED = _QUANTIZABLE + ("relu", "pool2d", "elementwise_add",
                               "batch_norm", "softmax")

    def __init__(self, scope=None, place=None, moving_rate=0.9):
        self._rate = moving_rate

    @staticmethod
    def _state_name(act):
        return act + ".out_scale"

    def apply(self, program, startup_program=None):
        startup = startup_program or framework.default_startup_program()
        block = program.global_block()
        sblock = startup.global_block()
        new_ops: List[Operator] = []
        for op in list(block.ops):
            new_ops.append(op)
            if op.type not in self._TRACKED:
                continue
            out_slot = {"batch_norm": "Y", "conv2d": "Output",
                        "depthwise_conv2d": "Output"}.get(op.type, "Out")
            names = op.output_names.get(out_slot)
            if not names:
                continue
            act = names[0]
            v = block._find_var_recursive(act)
            if v is None or str(v.dtype) != "float32":
                continue
            state = self._state_name(act)
            if block._find_var_recursive(state) is not None:
                continue
            sv = block.create_var(name=state, shape=[1],
                                  dtype="float32", persistable=True)
            sv.stop_gradient = True
            sblock.create_var(name=state, shape=[1], dtype="float32",
                              persistable=True)
            sblock.append_op(type="fill_constant", inputs={},
                             outputs={"Out": [state]},
                             attrs={"shape": [1], "dtype": "float32",
                                    "value": 0.0})
            passthrough = block.create_var(name=act + ".scale_obs",
                                           shape=v.shape,
                                           dtype=v.dtype)
            new_ops.append(Operator(
                block, "moving_average_abs_max_scale",
                inputs={"X": [act], "InScale": [state]},
                outputs={"Out": [passthrough.name],
                         "OutScale": [state]},
                attrs={"moving_rate": self._rate}))
        block.ops[:] = new_ops
        program._version += 1
        return program


class OutScaleForInferencePass:
    """Write the tracked output scales onto the producing ops as the
    `out_threshold` attr (reference: OutScaleForInferencePass), then
    propagate through scale-invariant ops (relu/reshape/transpose/
    max-pool...) so every tensor on the quantized path carries a
    threshold. Drops the tracker ops."""

    def __init__(self, scope=None):
        self._scope = scope

    def apply(self, program, scope=None):
        scope = scope or self._scope
        if scope is None:
            # proceeding would drop every tracker op while writing zero
            # thresholds — calibration silently destroyed
            raise ValueError(
                "OutScaleForInferencePass needs the scope holding the "
                "trained .out_scale state (pass scope= to __init__ or "
                "apply)")
        block = program.global_block()
        thresholds = {}  # act name -> float scale
        kept: List[Operator] = []
        for op in block.ops:
            if op.type == "moving_average_abs_max_scale":
                state = op.output_names["OutScale"][0]
                v = scope.find_var(state) if scope is not None else None
                if v is not None:
                    s = float(to_numpy(v).reshape(-1)[0])
                    if s > 0:
                        thresholds[op.input_names["X"][0]] = s
                continue  # tracker consumed; drop it
            kept.append(op)
        for op in kept:
            for names in op.output_names.values():
                for n in names:
                    if n in thresholds:
                        op.attrs["out_threshold"] = thresholds[n]
            if op.type in _SCALE_INVARIANT \
                    and "out_threshold" not in op.attrs:
                # scale-invariant: inherit the input's threshold
                for names in op.input_names.values():
                    for n in names:
                        if n in thresholds:
                            op.attrs["out_threshold"] = thresholds[n]
                            for onames in op.output_names.values():
                                for o in onames:
                                    thresholds.setdefault(
                                        o, thresholds[n])
                            break
                    if "out_threshold" in op.attrs:
                        break
        block.ops[:] = kept
        program._version += 1
        return program


class QuantizationFreezePass:
    """Reference: QuantizationFreezePass
    (`contrib/slim/quantization/quantization_pass.py:700`) — after QAT,
    convert the program for int8 inference: weights are snapped to the
    int8 grid in the tensors the scope holds (int8-simulated fp32
    values), the weight fake-quant ops are removed (consumers rewired to
    the original param, which now holds quantized values), per-channel
    scales land on the consumer op as `weight_quant_scale`, and
    activation quantizers freeze to their learned static scales
    (is_test=True)."""

    def __init__(self, scope=None, place=None, weight_bits=8,
                 activation_bits=8, weight_quantize_type="abs_max"):
        self._scope = scope
        self._wbits = weight_bits
        self._abits = activation_bits
        self._w_type = weight_quantize_type

    def apply(self, program, scope=None):
        scope = scope or self._scope
        block = program.global_block()
        bnt = (1 << (self._wbits - 1)) - 1
        # pass 1: collect weight fake-quant ops (X persistable)
        weight_q = {}  # quantized-name -> (src, op, axis)
        kept: List[Operator] = []
        for op in block.ops:
            if op.type in ("fake_quantize_abs_max",
                           "fake_channel_wise_quantize_abs_max"):
                src = op.input_names["X"][0]
                v = block._find_var_recursive(src)
                if v is not None and getattr(v, "persistable", False) \
                        and scope is not None \
                        and scope.find_var(src) is not None:
                    weight_q[op.output_names["Out"][0]] = (
                        src, op, op.attrs.get("quant_axis", 0))
                    continue  # op removed: weights pre-quantized below
            kept.append(op)

        # pass 2: snap the weights to the int8 grid in place; rewire
        for qname, (src, qop, axis) in weight_q.items():
            t = scope.find_var(src)
            w = to_numpy(t)
            if qop.type == "fake_channel_wise_quantize_abs_max":
                red = tuple(i for i in range(w.ndim) if i != axis)
                scale = np.max(np.abs(w), axis=red, keepdims=True)
            else:
                scale = np.asarray(np.max(np.abs(w))).reshape(
                    tuple(1 for _ in w.shape))
            s = np.maximum(scale, 1e-8)
            wq = np.clip(np.round(w / s * bnt), -bnt, bnt) * s / bnt
            with torch.no_grad():
                t.copy_(torch.from_numpy(np.ascontiguousarray(
                    wq.astype(w.dtype))))
            for op in kept:
                for slot, names in op.input_names.items():
                    if qname in names:
                        op.input_names[slot] = [
                            src if n == qname else n for n in names]
                        op.attrs["quantization_type"] = (
                            "qat_with_weight_quantize")
                        op.attrs["quant_weight_bits"] = self._wbits
                        op.attrs["weight_quant_scale"] = [
                            float(x) for x in
                            np.asarray(scale).reshape(-1)]

        # pass 3: freeze activation quantizers to their learned scales.
        # moving_average/range variants honor is_test (fixed InScale);
        # plain abs_max has no state input and recomputes per batch —
        # bake the last calibrated OutScale from scope in as the static
        # scale, or inference would silently keep dynamic scales.
        for op in kept:
            if not op.type.startswith("fake_quantize"):
                continue
            op.attrs["is_test"] = True
            if op.type in ("fake_quantize_abs_max",
                           "fake_quantize_dequantize_abs_max") \
                    and scope is not None \
                    and "static_scale" not in op.attrs:
                sv = scope.find_var(op.output_names["OutScale"][0])
                if sv is not None:
                    s = float(to_numpy(sv).reshape(-1)[0])
                    if s > 0:
                        op.attrs["static_scale"] = s
        block.ops[:] = kept
        program._version += 1
        return program
