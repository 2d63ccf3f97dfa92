"""The op types of the float16 AMP, LAMB and clipping slice: the port's
registry (paddle_tpu_torch.ops, on the CPU) against the JAX package's
(`paddle_tpu.ops`), type by type: the 36 of `math_ops.py` the port did
not have, 44 unary elementwise types of `nn_ops.py` and the 16 of
`optimizer_ops.py`.

Seeded numpy inputs go through the reference's `get_op(t).compute` and
the port's: float outputs within rtol 1e-5 (float32 on both sides),
integer and bool outputs exactly (the JAX package runs without x64, so
its int64 results come back as int32: values compare, widths do not),
and for differentiable types the gradient of every float input under
one seeded cotangent (`jax.vjp` against `torch.autograd.grad`) within
rtol 1e-5. Looser, and why: `lgamma`, `digamma` and `erfinv` (and their
gradients, the polygamma series) within 1e-4, as XLA's and ATen's series
differ in the last bits. `infer_outputs` with a -1 batch agrees in shape
and dtype kind. `dpsgd` runs with sigma 0 (its noise comes from another
stream in each package); its noise is held by its moments. The port's
op types stay a subset of the reference's, 472 of its 524
(`tools/port_op_coverage.py`), and each new type keeps the reference's
`no_jit` and `dynamic_shape` flags. Last, the float16 plain versions of
the flash kernels against the reference's in float16."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.rng import make_key
from paddle_tpu.ops import registry as rreg

from paddle_tpu_torch.core.rng import seed_tensor
from paddle_tpu_torch.core.types import to_torch_dtype
from paddle_tpu_torch.ops import registry as treg

RTOL, ATOL = 1e-5, 1e-6
#: looser float32 tolerances, each with its reason (module docstring)
SPECIAL_RTOL = {"lgamma": 1e-4, "digamma": 1e-4, "erfinv": 1e-4}
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _f(*shape, lo=None, hi=None):
    if lo is None:
        return lambda r: r.randn(*shape).astype("float32")
    return lambda r: r.uniform(lo, hi, size=shape).astype("float32")


def _i(high, *shape):
    return lambda r: r.randint(0, high, size=shape).astype("int64")


def _const(v, dtype="float32"):
    return lambda r: np.asarray(v, dtype=dtype)


def _away(*shape, gap=0.05):
    """Normal values kept `gap` away from 0, +-0.5, +-1 and +-3, the
    kinks of the piecewise activations (no gradient tie)."""
    def make(r):
        x = r.randn(*shape).astype("float32") * 2
        for k in (0.0, 0.5, -0.5, 1.0, -1.0, 3.0, -3.0):
            x = np.where(np.abs(x - k) < gap, k + gap * 2, x)
        return x.astype("float32")
    return make


def _sorted(n):
    return lambda r: np.sort(r.randn(n)).astype("float32")


def _mask(*shape):
    return lambda r: r.rand(*shape) > 0.5


def _ints(vals):
    return lambda r: np.asarray(vals, dtype="int64")


#: name -> (op type, {slot: [numpy maker]}, attrs, float input slots to
#: differentiate, batch-carrying slots for the -1 inference check)
MATH_CASES = {
    "sum": ("sum", {"X": [_f(3, 4), _f(3, 4), _f(3, 4)]}, {}, ["X"], ["X"]),
    "squared_l2_norm": ("squared_l2_norm", {"X": [_f(3, 5)]}, {}, ["X"], []),
    "clip": ("clip", {"X": [_away(4, 5)]}, {"min": -0.5, "max": 0.5},
             ["X"], ["X"]),
    "clip_by_norm": ("clip_by_norm", {"X": [_f(4, 5)]}, {"max_norm": 1.0},
                     ["X"], []),
    "clip_by_norm_below": ("clip_by_norm", {"X": [_f(4, 5)]},
                           {"max_norm": 100.0}, ["X"], []),
    "p_norm": ("p_norm", {"X": [_f(3, 6, lo=0.2, hi=2.0)]},
               {"porder": 3.0, "axis": 1, "keepdim": True}, ["X"], ["X"]),
    "l1_norm": ("l1_norm", {"X": [_away(4, 3)]}, {}, ["X"], []),
    "frobenius_norm": ("frobenius_norm", {"X": [_f(3, 4, 5)]},
                       {"dim": [1, 2], "keep_dim": False}, ["X"], ["X"]),
    "dist": ("dist", {"X": [_f(3, 4)], "Y": [_f(4)]}, {"p": 3.0},
             ["X", "Y"], []),
    "dist_inf": ("dist", {"X": [_f(3, 4)], "Y": [_f(3, 4)]},
                 {"p": float("inf")}, ["X"], []),
    "dist_zero": ("dist", {"X": [_i(3, 3, 4)], "Y": [_i(3, 3, 4)]},
                  {"p": 0.0}, [], []),
    "reduce_all": ("reduce_all", {"X": [_mask(3, 4, 2)]},
                   {"dim": [1], "keep_dim": False}, [], ["X"]),
    "reduce_any": ("reduce_any", {"X": [_mask(3, 4)]},
                   {"reduce_all": True}, [], []),
    "reduce_max": ("reduce_max", {"X": [_f(3, 4, 5)]},
                   {"dim": [0, 2], "keep_dim": True}, ["X"], []),
    "reduce_mean": ("reduce_mean", {"X": [_f(3, 4, 5)]},
                    {"dim": [-1], "keep_dim": False}, ["X"], ["X"]),
    "reduce_min": ("reduce_min", {"X": [_f(3, 4)]}, {"dim": [1]}, ["X"],
                   ["X"]),
    "reduce_prod": ("reduce_prod", {"X": [_f(3, 4, 2, lo=0.5, hi=1.5)]},
                    {"dim": [0, 1], "keep_dim": False}, ["X"], []),
    "matmul_v2": ("matmul_v2", {"X": [_f(2, 4, 3)], "Y": [_f(2, 5, 4)]},
                  {"trans_x": True, "trans_y": True}, ["X", "Y"], ["X", "Y"]),
    "maximum": ("maximum", {"X": [_f(3, 4)], "Y": [_f(4)]}, {}, ["X", "Y"],
                ["X"]),
    "minimum": ("minimum", {"X": [_f(3, 4)], "Y": [_f(3, 4)]}, {},
                ["X", "Y"], ["X", "Y"]),
    "pow": ("pow", {"X": [_f(3, 4, lo=0.5, hi=2.0)]}, {"factor": 2.5},
            ["X"], ["X"]),
    "pow_tensor": ("pow", {"X": [_f(3, 4, lo=0.5, hi=2.0)],
                           "FactorTensor": [_const([1.5])]}, {}, ["X"],
                   ["X"]),
    "minus": ("minus", {"X": [_f(3, 4)], "Y": [_f(3, 4)]}, {}, ["X", "Y"],
              ["X", "Y"]),
    "lgamma": ("lgamma", {"X": [_f(4, 5, lo=0.3, hi=6.0)]}, {}, ["X"],
               ["X"]),
    "digamma": ("digamma", {"X": [_f(4, 5, lo=0.3, hi=6.0)]}, {}, ["X"],
                ["X"]),
    "erfinv": ("erfinv", {"X": [_f(4, 5, lo=-0.9, hi=0.9)]}, {}, ["X"],
               ["X"]),
    "lerp": ("lerp", {"X": [_f(3, 4)], "Y": [_f(3, 4)]}, {"weight": 0.3},
             ["X", "Y"], ["X", "Y"]),
    "lerp_tensor": ("lerp", {"X": [_f(3, 4)], "Y": [_f(3, 4)],
                             "Weight": [_f(3, 4, lo=0.0, hi=1.0)]}, {},
                    ["X", "Y", "Weight"], ["X", "Y", "Weight"]),
    "frac": ("frac", {"X": [_away(3, 4)]}, {}, ["X"], ["X"]),
    "trunc": ("trunc", {"X": [_away(3, 4)]}, {}, [], ["X"]),
    "take": ("take", {"X": [_f(3, 4)],
                      "Index": [_ints([[0, 11, -1], [5, 12, -13]])]},
             {}, ["X"], []),
    "put_along_axis": ("put_along_axis",
                       {"Input": [_f(4, 3)], "Index": [_ints([[0, 2, 1],
                                                              [3, 0, 2]])],
                        "Value": [_f(2, 3)]},
                       {"Axis": 0, "Reduce": "assign"},
                       ["Input", "Value"], []),
    "put_along_axis_add": ("put_along_axis",
                           {"Input": [_f(4, 3)],
                            "Index": [_ints([[1], [0], [2]])],
                            "Value": [_const(2.5)]},
                           {"axis": 1, "reduce": "add"}, ["Input"], []),
    "masked_fill": ("masked_fill", {"X": [_f(3, 4)], "Mask": [_mask(4)]},
                    {"value": -7.0}, ["X"], ["X"]),
    "searchsorted": ("searchsorted", {"SortedSequence": [_sorted(9)],
                                      "Values": [_f(3, 4)]},
                     {"right": False}, [], []),
    "searchsorted_right": ("searchsorted",
                           {"SortedSequence": [_const([0., 1., 1., 2.])],
                            "Values": [_const([1.0, -1.0, 2.0, 3.0])]},
                           {"right": True}, [], []),
    "isfinite": ("isfinite", {"X": [_const([1.0, np.inf, 2.0])]}, {}, [],
                 []),
    "isfinite_v2": ("isfinite_v2",
                    {"X": [_const([[1.0, np.inf], [np.nan, -2.0]])]}, {},
                    [], ["X"]),
    "isnan_v2": ("isnan_v2", {"X": [_const([[1.0, np.inf],
                                            [np.nan, -2.0]])]}, {}, [],
                 ["X"]),
    "isinf_v2": ("isinf_v2", {"X": [_const([[1.0, -np.inf],
                                            [np.nan, -2.0]])]}, {}, [],
                 ["X"]),
    "amp_check_finite_and_scale": (
        "amp_check_finite_and_scale",
        {"X": [_f(3, 4), _const([1.0, np.inf])], "Scale": [_const([8.0])]},
        {}, [], []),
    "check_finite_and_unscale": (
        "check_finite_and_unscale",
        {"X": [_f(3, 4), _f(5)], "Scale": [_const([1024.0])]}, {}, ["X"],
        []),
    "update_loss_scaling_inf": (
        "update_loss_scaling",
        {"X": [_f(3, 4)], "FoundInfinite": [_const([True], "bool")],
         "PrevLossScaling": [_const([1024.0])],
         "InGoodSteps": [_const([5], "int32")],
         "InBadSteps": [_const([1], "int32")]},
        {"incr_every_n_steps": 10, "decr_every_n_nan_or_inf": 2,
         "incr_ratio": 2.0, "decr_ratio": 0.5}, [], []),
    "update_loss_scaling_grow": (
        "update_loss_scaling",
        {"X": [_f(3, 4)], "FoundInfinite": [_const([False], "bool")],
         "PrevLossScaling": [_const([1024.0])],
         "InGoodSteps": [_const([9], "int32")],
         "InBadSteps": [_const([1], "int32")]},
        {"incr_every_n_steps": 10, "decr_every_n_nan_or_inf": 2,
         "incr_ratio": 2.0, "decr_ratio": 0.5}, [], []),
    "update_loss_scaling_floor": (
        "update_loss_scaling",
        {"X": [_f(2)], "FoundInfinite": [_const([True], "bool")],
         "PrevLossScaling": [_const([1.5])],
         "InGoodSteps": [_const([0], "int32")],
         "InBadSteps": [_const([0], "int32")]},
        {"decr_every_n_nan_or_inf": 1, "decr_ratio": 0.5}, [], []),
}

#: the 44 unary elementwise types of `nn_ops.py`: name -> (attrs, input
#: maker); every one differentiated
_UNARY = {
    "abs": ({}, _away(4, 5)),
    "acos": ({}, _f(4, 5, lo=-0.9, hi=0.9)),
    "acosh": ({}, _f(4, 5, lo=1.2, hi=4.0)),
    "asin": ({}, _f(4, 5, lo=-0.9, hi=0.9)),
    "asinh": ({}, _f(4, 5)),
    "atan": ({}, _f(4, 5)),
    "atanh": ({}, _f(4, 5, lo=-0.9, hi=0.9)),
    "brelu": ({"t_min": -0.5, "t_max": 1.0}, _away(4, 5)),
    "ceil": ({}, _away(4, 5)),
    "celu": ({"alpha": 1.5}, _away(4, 5)),
    "cosh": ({}, _f(4, 5)),
    "elu": ({"alpha": 0.7}, _away(4, 5)),
    "erf": ({}, _f(4, 5)),
    "expm1": ({}, _f(4, 5)),
    "hard_shrink": ({"threshold": 0.5}, _away(4, 5)),
    "hard_sigmoid": ({"slope": 0.25, "offset": 0.5}, _away(4, 5)),
    "hard_swish": ({}, _away(4, 5)),
    "leaky_relu": ({"alpha": 0.1}, _away(4, 5)),
    "log": ({}, _f(4, 5, lo=0.1, hi=4.0)),
    "log10": ({}, _f(4, 5, lo=0.1, hi=4.0)),
    "log1p": ({}, _f(4, 5, lo=-0.5, hi=4.0)),
    "log2": ({}, _f(4, 5, lo=0.1, hi=4.0)),
    "logit": ({"eps": 1e-6}, _f(4, 5, lo=0.05, hi=0.95)),
    "logsigmoid": ({}, _f(4, 5)),
    "mish": ({}, _f(4, 5)),
    "reciprocal": ({}, _f(4, 5, lo=0.5, hi=3.0)),
    "relu6": ({"threshold": 1.0}, _away(4, 5)),
    "round": ({}, _away(4, 5)),
    "rsqrt": ({}, _f(4, 5, lo=0.2, hi=4.0)),
    "selu": ({}, _away(4, 5)),
    "silu": ({}, _f(4, 5)),
    "sin": ({}, _f(4, 5)),
    "sinh": ({}, _f(4, 5)),
    "soft_relu": ({"threshold": 2.0}, _away(4, 5)),
    "softplus": ({}, _f(4, 5)),
    "softshrink": ({"lambda": 0.5}, _away(4, 5)),
    "softsign": ({}, _away(4, 5)),
    "sqrt": ({}, _f(4, 5, lo=0.2, hi=4.0)),
    "square": ({}, _f(4, 5)),
    "stanh": ({"scale_a": 0.5, "scale_b": 1.5}, _f(4, 5)),
    "swish": ({"beta": 1.5}, _f(4, 5)),
    "tan": ({}, _f(4, 5, lo=-1.2, hi=1.2)),
    "tanh_shrink": ({}, _f(4, 5)),
    "thresholded_relu": ({"threshold": 0.5}, _away(4, 5)),
}
NN_CASES = {t: (t, {"X": [mk]}, attrs, ["X"], ["X"])
            for t, (attrs, mk) in _UNARY.items()}


def _opt_state(*shape, lo=0.1, hi=1.0):
    return _f(*shape, lo=lo, hi=hi)


_LR = {"LearningRate": [_const([0.05])]}
_PG = {"Param": [_f(4, 3)], "Grad": [_f(4, 3)]}
OPT_CASES = {
    "lars_momentum": ("lars_momentum", dict(_PG, Velocity=[_f(4, 3)], **_LR),
                      {"mu": 0.9, "lars_coeff": 0.01,
                       "lars_weight_decay": 0.001}, [], []),
    "adamw": ("adamw", dict(_PG, Moment1=[_f(4, 3)],
                            Moment2=[_opt_state(4, 3)],
                            Beta1Pow=[_const([0.81])],
                            Beta2Pow=[_const([0.998])], **_LR),
              {"coeff": 0.02}, [], []),
    "adamax": ("adamax", dict(_PG, Moment=[_f(4, 3)],
                              InfNorm=[_opt_state(4, 3)],
                              Beta1Pow=[_const([0.9])], **_LR),
               {"beta1": 0.9, "beta2": 0.99}, [], []),
    "adagrad": ("adagrad", dict(_PG, Moment=[_opt_state(4, 3)], **_LR),
                {"epsilon": 1e-6}, [], []),
    "decayed_adagrad": ("decayed_adagrad",
                        dict(_PG, Moment=[_opt_state(4, 3)], **_LR),
                        {"decay": 0.9}, [], []),
    "adadelta": ("adadelta", dict(_PG, AvgSquaredGrad=[_opt_state(4, 3)],
                                  AvgSquaredUpdate=[_opt_state(4, 3)]),
                 {"rho": 0.9, "epsilon": 1e-6}, [], []),
    "rmsprop": ("rmsprop", dict(_PG, MeanSquare=[_opt_state(4, 3)],
                                Moment=[_f(4, 3)], **_LR),
                {"decay": 0.9, "momentum": 0.5}, [], []),
    "rmsprop_centered": ("rmsprop", dict(_PG, MeanSquare=[_opt_state(4, 3,
                                                                      lo=1.0,
                                                                      hi=2.)],
                                         Moment=[_f(4, 3)],
                                         MeanGrad=[_f(4, 3, lo=-.3, hi=.3)],
                                         **_LR),
                         {"decay": 0.9, "centered": True}, [], []),
    "ftrl": ("ftrl", dict(_PG, SquaredAccumulator=[_opt_state(4, 3)],
                          LinearAccumulator=[_f(4, 3)], **_LR),
             {"l1": 0.01, "l2": 0.02, "lr_power": -0.5}, [], []),
    "lamb": ("lamb", dict(_PG, Moment1=[_f(4, 3)], Moment2=[_opt_state(4, 3)],
                          Beta1Pow=[_const([0.81])],
                          Beta2Pow=[_const([0.998])], **_LR),
             {"weight_decay": 0.01}, [], []),
    "lamb_zero_param": ("lamb", dict(_PG, Param=[_const(np.zeros((2, 2)))],
                                     Grad=[_f(2, 2)], Moment1=[_f(2, 2)],
                                     Moment2=[_opt_state(2, 2)],
                                     Beta1Pow=[_const([0.9])],
                                     Beta2Pow=[_const([0.999])], **_LR),
                        {"weight_decay": 0.0}, [], []),
    "dpsgd": ("dpsgd", dict(_PG, **_LR),
              {"clip": 0.5, "batch_size": 4.0, "sigma": 0.0}, [], []),
    "proximal_gd": ("proximal_gd", dict(_PG, **_LR),
                    {"l1": 0.5, "l2": 0.1}, [], []),
    "proximal_adagrad": ("proximal_adagrad",
                         dict(_PG, Moment=[_opt_state(4, 3)], **_LR),
                         {"l1": 0.5, "l2": 0.1}, [], []),
    "lookahead_step": ("lookahead_step",
                       {"Param": [_f(4, 3)], "SlowParam": [_f(4, 3)],
                        "Step": [_const([10], "int32")]},
                       {"alpha": 0.3, "k": 5}, [], []),
    "lookahead_off": ("lookahead_step",
                      {"Param": [_f(4, 3)], "SlowParam": [_f(4, 3)],
                       "Step": [_const([7], "int32")]},
                      {"alpha": 0.3, "k": 5}, [], []),
    "average_accumulates": (
        "average_accumulates",
        {"Param": [_f(4, 3)], "in_sum_1": [_f(4, 3)], "in_sum_2": [_f(4, 3)],
         "in_sum_3": [_f(4, 3)], "in_num_accumulates": [_const([3], "int32")],
         "in_old_num_accumulates": [_const([1], "int32")],
         "in_num_updates": [_const([9], "int32")]},
        {"average_window": 0.5, "min_average_window": 2,
         "max_average_window": 100}, [], []),
    "average_accumulates_hold": (
        "average_accumulates",
        {"Param": [_f(4, 3)], "in_sum_1": [_f(4, 3)], "in_sum_2": [_f(4, 3)],
         "in_sum_3": [_f(4, 3)], "in_num_accumulates": [_const([3], "int32")],
         "in_old_num_accumulates": [_const([1], "int32")],
         "in_num_updates": [_const([9], "int32")]},
        {"average_window": 1.0, "min_average_window": 20}, [], []),
    "dgc_momentum_warm": ("dgc_momentum",
                          dict(_PG, Velocity=[_f(4, 3)],
                               CurrentStep=[_const([2.0])], **_LR),
                          {"mu": 0.9, "rampup_begin_step": 5.0}, [], []),
    "dgc_momentum_after": ("dgc_momentum",
                           dict(_PG, Velocity=[_f(4, 3)],
                                CurrentStep=[_const([6.0])], **_LR),
                           {"mu": 0.9, "rampup_begin_step": 5.0,
                            "use_nesterov": True}, [], []),
    "dgc_clip_by_norm": ("dgc_clip_by_norm",
                         {"X": [_f(4, 3)],
                          "current_step": [_const([6], "int32")]},
                         {"max_norm": 0.5, "rampup_begin_step": 5.0}, [], []),
    "dgc_clip_by_norm_before": ("dgc_clip_by_norm",
                                {"X": [_f(4, 3)],
                                 "current_step": [_const([2], "int32")]},
                                {"max_norm": 0.5, "rampup_begin_step": 5.0},
                                [], []),
}

CASES = dict(MATH_CASES, **NN_CASES, **OPT_CASES)
#: the op types this slice ports, by reference file
MATH_TYPES = {
    "amp_check_finite_and_scale", "check_finite_and_unscale",
    "update_loss_scaling", "isfinite", "isfinite_v2", "isnan_v2",
    "isinf_v2", "sum", "squared_l2_norm", "clip", "clip_by_norm", "p_norm",
    "l1_norm", "frobenius_norm", "dist", "reduce_all", "reduce_any",
    "reduce_max", "reduce_mean", "reduce_min", "reduce_prod", "matmul_v2",
    "maximum", "minimum", "pow", "minus", "lgamma", "digamma", "erfinv",
    "lerp", "frac", "trunc", "take", "put_along_axis", "masked_fill",
    "searchsorted"}
NN_TYPES = set(_UNARY)
OPT_TYPES = {
    "lamb", "lars_momentum", "adamw", "adamax", "adagrad",
    "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "dpsgd",
    "proximal_gd", "proximal_adagrad", "lookahead_step",
    "average_accumulates", "dgc_momentum", "dgc_clip_by_norm"}
SLICE_TYPES = MATH_TYPES | NN_TYPES | OPT_TYPES


def test_cases_cover_the_slice():
    assert (len(MATH_TYPES), len(NN_TYPES), len(OPT_TYPES)) == (36, 44, 16)
    assert {c[0] for c in CASES.values()} == SLICE_TYPES
    assert SLICE_TYPES <= set(treg.registered_ops())


def test_port_types_are_a_subset_of_the_reference():
    """The port registers 472 of the reference's types and none of its
    own (`tools/port_op_coverage.py`)."""
    port, ref = set(treg.registered_ops()), set(rreg.registered_ops())
    assert port <= ref
    assert len(port) == 472


def test_coverage_tool_prints_the_totals(capsys):
    sys.path.insert(0, os.path.join(_REPO, "tools"))
    try:
        import port_op_coverage
    finally:
        sys.path.pop(0)
    assert port_op_coverage.main([]) == 0
    out = capsys.readouterr().out
    assert "ported 472 of 524 reference op types; extra: none" in out
    math_line = next(ln for ln in out.splitlines()
                     if ln.startswith("paddle_tpu/ops/math_ops.py"))
    assert "missing   0" in math_line


@pytest.mark.parametrize("op_type", sorted(SLICE_TYPES))
def test_flags_match_the_reference(op_type):
    r, t = rreg.get_op(op_type), treg.get_op(op_type)
    assert (t.no_jit, t.dynamic_shape) == (r.no_jit, r.dynamic_shape)
    assert (t.rng == "device") == bool(r.needs_rng)


def _inputs(name):
    r = np.random.RandomState(sorted(CASES).index(name))
    return {slot: [make(r) for make in makers]
            for slot, makers in CASES[name][1].items()}


def _to_torch(a, grad=False):
    a = np.asarray(a)
    t = torch.as_tensor(a, dtype=to_torch_dtype(a.dtype))
    return t.requires_grad_(True) if grad else t


def _port(op_type, ins, attrs):
    attrs = dict(attrs, _device=torch.device("cpu"),
                 _rng_seed=seed_tensor(7, "cpu"))
    return treg.normalize_outs(treg.get_op(op_type).compute(ins, attrs))


def _reference(op_type, attrs):
    attrs = dict(attrs, _rng_key=make_key(0))

    def compute(full):
        return rreg.normalize_outs(rreg.get_op(op_type).compute(
            full, dict(attrs)))

    return compute


def _same_kind(t_dtype, r_dtype):
    """Equal dtypes, where an integer width may differ (no x64 in JAX)."""
    if np.issubdtype(r_dtype, np.integer):
        return np.issubdtype(t_dtype, np.integer)
    return t_dtype == r_dtype


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_reference(name):
    op_type, _, attrs, diff_slots, _ = CASES[name]
    rtol = SPECIAL_RTOL.get(op_type, RTOL)
    ins = _inputs(name)
    compute = _reference(op_type, attrs)
    r_out = compute({s: [jnp.asarray(a) for a in v]
                     for s, v in ins.items()})
    t_ins = {s: [_to_torch(a, s in diff_slots) for a in v]
             for s, v in ins.items()}
    t_out = _port(op_type, t_ins, attrs)
    assert sorted(r_out) == sorted(t_out)
    for slot in r_out:
        assert len(r_out[slot]) == len(t_out[slot]), slot
        for rv, tv in zip(r_out[slot], t_out[slot]):
            rv, tv = np.asarray(rv), tv.detach().numpy()
            assert tv.shape == rv.shape, slot
            assert _same_kind(tv.dtype, rv.dtype), (slot, tv.dtype, rv.dtype)
            if np.issubdtype(rv.dtype, np.floating):
                np.testing.assert_allclose(tv, rv, rtol=rtol, atol=ATOL,
                                           err_msg=slot)
            else:
                np.testing.assert_array_equal(tv, rv, err_msg=slot)
    if not diff_slots:
        return

    float_outs = sorted(s for s in r_out
                        if np.issubdtype(np.asarray(r_out[s][0]).dtype,
                                         np.floating))
    cr = np.random.RandomState(99)
    cts = {s: [np.asarray(cr.randn(*np.asarray(o).shape), dtype="float32")
               for o in r_out[s]] for s in float_outs}

    def fwd(diff):
        full = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
        full.update(diff)
        outs = compute(full)
        return {s: outs[s] for s in float_outs}

    diff_in = {s: [jnp.asarray(a) for a in ins[s]] for s in diff_slots}
    _, vjp = jax.vjp(fwd, diff_in)
    r_grads = vjp({s: [jnp.asarray(c) for c in cs]
                   for s, cs in cts.items()})[0]
    leaves = [t for s in diff_slots for t in t_ins[s]]
    outs = [o for s in float_outs for o in t_out[s]]
    t_grads = torch.autograd.grad(
        outs, leaves, grad_outputs=[torch.as_tensor(c) for s in float_outs
                                    for c in cts[s]], allow_unused=True)
    want = [np.asarray(g) for s in diff_slots for g in r_grads[s]]
    for i, (tg, rg) in enumerate(zip(t_grads, want)):
        tg = np.zeros_like(rg) if tg is None else tg.numpy()
        np.testing.assert_allclose(tg, rg, rtol=rtol, atol=ATOL,
                                   err_msg="grad %d" % i)


def _specs(name):
    _, _, _, _, batch_slots = CASES[name]
    return {s: [((-1,) + np.asarray(a).shape[1:] if s in batch_slots
                 else np.asarray(a).shape, str(np.asarray(a).dtype))
                for a in v]
            for s, v in _inputs(name).items()}


@pytest.mark.parametrize("name", sorted(MATH_CASES) + sorted(NN_CASES))
def test_infer_outputs_matches_reference(name):
    op_type, _, attrs, _, _ = CASES[name]
    specs = _specs(name)
    t = treg.infer_outputs(op_type, specs, dict(attrs))
    r = rreg.infer_outputs(op_type, specs, dict(attrs))
    assert sorted(t) == sorted(r)
    for slot in r:
        for (ts, td), (rs, rd) in zip(t[slot], r[slot]):
            assert ts == rs, slot
            assert _same_kind(np.dtype(td) if td != "bfloat16" else td,
                              np.dtype(rd) if rd != "bfloat16" else rd), slot


def test_dpsgd_noise_is_normal_of_its_std():
    """dpsgd's noise, from the op's device seed: mean 0 and std sigma *
    clip over many elements, a new draw for another seed, the same for
    the same seed."""
    g = torch.zeros(200, 200)
    ins = {"Param": [torch.zeros(200, 200)], "Grad": [g],
           "LearningRate": [torch.tensor([4.0])]}
    attrs = {"clip": 0.5, "batch_size": 4.0, "sigma": 2.0}
    out = _port("dpsgd", ins, attrs)["ParamOut"][0]
    noise = -out.double()  # lr / batch = 1
    assert abs(float(noise.mean())) < 0.02
    assert abs(float(noise.std()) - 1.0) < 0.02
    again = _port("dpsgd", ins, attrs)["ParamOut"][0]
    assert torch.equal(out, again)
    other = treg.get_op("dpsgd").compute(ins, dict(
        attrs, _device=torch.device("cpu"), _rng_seed=seed_tensor(8, "cpu")))
    assert not torch.equal(out, other["ParamOut"])


@pytest.mark.parametrize("causal,dropout", [(False, 0.1), (True, 0.0)])
def test_flash_float16_plain_matches_reference(causal, dropout):
    """The flash kernels' plain versions in float16 (what the card's
    float16 kernels are held against) against the reference's Pallas
    kernels in interpret mode, in float16: forward and the three
    gradients within 2e-3 of the output's scale."""
    from paddle_tpu.ops.pallas import flash_attention as jax_flash
    from paddle_tpu_torch.ops.kernels import flash_attention

    r = np.random.RandomState(3)
    B, H, S, D = 1, 2, 128, 64
    q, k, v, do = (r.randn(B, H, S, D).astype("float16") for _ in range(4))
    bias = (r.randn(B, S) * 0.5).astype("float32")
    seed = 11
    kw = dict(dropout_p=dropout, dropout_seed=seed) if dropout else {}

    def ref(q, k, v):
        return jax_flash(q, k, v, key_bias=jnp.asarray(bias), causal=causal,
                         **dict(kw, dropout_seed=jnp.int32(seed)) if kw
                         else {})

    r_o, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    r_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    t_o = flash_attention(tq, tk, tv, key_bias=torch.tensor(bias),
                          causal=causal, **kw)
    assert t_o.dtype == torch.float16
    t_grads = torch.autograd.grad(t_o, (tq, tk, tv),
                                  grad_outputs=torch.tensor(do))
    for name, t, rv in zip(("o", "dq", "dk", "dv"), (t_o,) + t_grads,
                           (r_o,) + tuple(r_grads)):
        rv = np.asarray(rv).astype(np.float32)
        tv_ = t.detach().float().numpy()
        scale = max(float(np.abs(rv).max()), 1e-3)
        assert float(np.abs(tv_ - rv).max()) <= 2e-3 * scale, name
