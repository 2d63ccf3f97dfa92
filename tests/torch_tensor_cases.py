"""The op cases of the large-batch slice's tensor, random and padding
types (`tests/test_torch_tensor_ops.py` holds each against the JAX
package on the CPU; `chip_smoke.py` phase 18 leg d, the card against the
CPU). Plain numpy and no JAX, so the card's machine imports it too.

`CASES`: name -> (op type, {slot: [numpy maker]}, attrs, float input
slots to differentiate, batch-carrying slots for a -1 inference check);
`RNG_CASES`: random type -> ({slot: [maker]}, attrs). A maker takes a
`numpy.random.RandomState`; `inputs(name)` draws a case's inputs from
the state seeded by its position among the names."""
import numpy as np


def _f(*shape):
    return lambda r: r.randn(*shape).astype("float32")


def _i(high, *shape, low=0, dtype="int64"):
    return lambda r: r.randint(low, high, size=shape).astype(dtype)


def _b(*shape):
    return lambda r: r.rand(*shape) < 0.5


def _c(v, dtype="float32"):
    return lambda r: np.asarray(v, dtype)


def _ties(*shape):
    return lambda r: r.randint(0, 4, size=shape).astype("float32")


#: name -> (op type, {slot: [numpy maker]}, attrs, float input slots to
#: differentiate, batch-carrying slots for the -1 inference check)
CASES = {
    "allclose": ("allclose", {"Input": [_f(3, 4)], "Other": [_f(3, 4)]},
                 {"rtol": 1e-5, "atol": 2.0}, [], []),
    "arg_max": ("arg_max", {"X": [_f(3, 4, 5)]},
                {"axis": 1, "keepdims": True}, [], ["X"]),
    "arg_min": ("arg_min", {"X": [_ties(3, 6)]}, {"axis": 1}, [], ["X"]),
    "argsort": ("argsort", {"X": [_f(3, 5)]}, {"axis": -1}, ["X"], ["X"]),
    "argsort_desc_ties": ("argsort", {"X": [_ties(4, 6)]},
                          {"axis": 0, "descending": True}, [], []),
    "broadcast_to": ("broadcast_to", {"X": [_f(1, 3)]}, {"shape": [4, 3]},
                     ["X"], []),
    "concat": ("concat", {"X": [_f(2, 3), _f(4, 3)]}, {"axis": 0}, ["X"],
               []),
    "crop": ("crop", {"X": [_f(4, 5)]}, {"offsets": [1, 2], "shape": [2, 2]},
             ["X"], []),
    "crop_tensor": ("crop_tensor", {"X": [_f(4, 5)],
                                    "Offsets": [_c([2, 1], "int32")]},
                    {"shape": [2, 3]}, ["X"], []),
    "diag": ("diag", {"X": [_f(4)]}, {}, ["X"], []),
    "diag_embed": ("diag_embed", {"Input": [_f(2, 3)]}, {"offset": 1},
                   ["Input"], ["Input"]),
    "diag_embed_dims": ("diag_embed", {"Input": [_f(2, 3)]},
                        {"offset": -1, "dim1": 0, "dim2": 2}, ["Input"],
                        []),
    "diag_v2": ("diag_v2", {"X": [_f(3, 4)]}, {"offset": 1}, ["X"], []),
    "diag_v2_build": ("diag_v2", {"X": [_f(3)]}, {"offset": -1}, ["X"], []),
    "diagonal": ("diagonal", {"Input": [_f(3, 4, 5)]},
                 {"offset": 1, "axis1": 0, "axis2": 2}, ["Input"], []),
    "expand_as": ("expand_as", {"X": [_f(1, 3)], "Y": [_f(4, 3)]}, {},
                  ["X"], []),
    "expand_as_v2": ("expand_as_v2", {"X": [_f(3, 1)]},
                     {"target_shape": [3, 4]}, ["X"], []),
    "expand_v2": ("expand_v2", {"X": [_f(3, 1)]}, {"shape": [2, -1, 4]},
                  ["X"], []),
    "eye": ("eye", {}, {"num_rows": 3, "num_columns": 4,
                        "dtype": "float32"}, [], []),
    "fill": ("fill", {}, {"shape": [2, 3], "dtype": "float32",
                          "value": [0.5, -1.0, 2.0, 3.25, 0.0, 7.0]}, [], []),
    "fill_int": ("fill", {}, {"shape": [3], "dtype": "int32",
                              "value": [1, -2, 5]}, [], []),
    "fill_any_like": ("fill_any_like", {"X": [_f(2, 3)]},
                      {"value": 2.5, "dtype": -1}, [], ["X"]),
    "fill_any_like_int": ("fill_any_like", {"X": [_f(2, 3)]},
                          {"value": 3.0, "dtype": "int32"}, [], ["X"]),
    "fill_zeros_like": ("fill_zeros_like", {"X": [_f(2, 3)]}, {}, [], ["X"]),
    "fill_zeros_like2": ("fill_zeros_like2", {"X": [_f(2, 3)]},
                         {"dtype": "int32"}, [], ["X"]),
    "flatten": ("flatten", {"X": [_f(2, 3, 4)]}, {"axis": 2}, ["X"], []),
    "flatten2": ("flatten2", {"X": [_f(2, 3, 4)]}, {"axis": 1}, ["X"],
                 ["X"]),
    "flatten_contiguous_range": ("flatten_contiguous_range",
                                 {"X": [_f(2, 3, 4, 5)]},
                                 {"start_axis": 1, "stop_axis": 2}, ["X"],
                                 ["X"]),
    "flip": ("flip", {"X": [_f(2, 3, 4)]}, {"axis": [0, 2]}, ["X"], ["X"]),
    "gather_nd": ("gather_nd", {"X": [_f(4, 5, 6)],
                                "Index": [_i(4, 3, 2)]}, {}, ["X"], []),
    "index_sample": ("index_sample", {"X": [_f(3, 6)],
                                      "Index": [_i(6, 3, 4)]}, {}, ["X"],
                     []),
    "index_select": ("index_select", {"X": [_f(5, 4)],
                                      "Index": [_i(5, 3)]}, {"dim": 0},
                     ["X"], []),
    "index_select_dim1": ("index_select", {"X": [_f(5, 4)],
                                           "Index": [_i(4, 6)]},
                          {"dim": 1}, ["X"], ["X"]),
    "is_empty": ("is_empty", {"X": [_f(2, 3)]}, {}, [], ["X"]),
    "is_empty_zero": ("is_empty", {"X": [_f(2, 0)]}, {}, [], []),
    "isclose": ("isclose", {"Input": [_ties(3, 4)], "Other": [_ties(3, 4)]},
                {"rtol": 1e-5, "atol": 1e-8}, [], ["Input", "Other"]),
    "linspace": ("linspace", {"Start": [_c([0.5])], "Stop": [_c([2.0])],
                              "Num": [_c([7], "int32")]},
                 {"dtype": "float32"}, [], []),
    "logspace": ("logspace", {"Start": [_c([-1.0])], "Stop": [_c([2.0])],
                              "Num": [_c(5, "int32")]}, {"base": 2.0},
                 [], []),
    "masked_select": ("masked_select", {"X": [_f(3, 4)], "Mask": [_b(3, 4)]},
                      {}, [], []),
    "merge_ids": ("merge_ids", {"Ids": [_c([5, 0, 3], "int64"),
                                        _c([4, 1, 2], "int64")],
                                "X": [_f(3, 4), _f(3, 4)]}, {}, ["X"], []),
    "meshgrid": ("meshgrid", {"X": [_f(3), _f(4)]}, {}, ["X"], []),
    "numel": ("numel", {"Input": [_f(2, 3)]}, {}, [], []),
    "pad3d": ("pad3d", {"X": [_f(1, 2, 3, 4, 5)]},
              {"paddings": [1, 0, 2, 1, 0, 1], "mode": "constant",
               "value": 0.5}, ["X"], ["X"]),
    "pad3d_reflect": ("pad3d", {"X": [_f(1, 2, 3, 4, 5)]},
                      {"paddings": [1, 2, 0, 1, 1, 0], "mode": "reflect"},
                      ["X"], []),
    "pad3d_replicate": ("pad3d", {"X": [_f(1, 2, 3, 4, 5)]},
                        {"paddings": [1, 2, 0, 1, 1, 0],
                         "mode": "replicate"}, ["X"], []),
    "pad3d_circular": ("pad3d", {"X": [_f(1, 2, 3, 4, 5)]},
                       {"paddings": [1, 2, 0, 1, 1, 0], "mode": "circular"},
                       ["X"], []),
    "pad_constant_like": ("pad_constant_like", {"X": [_f(3, 5)],
                                                "Y": [_f(2, 3)]},
                          {"pad_value": 1.5}, ["Y"], []),
    "partial_concat": ("partial_concat", {"X": [_f(3, 6), _f(3, 6)]},
                       {"start_index": 1, "length": 2}, ["X"], ["X"]),
    "partial_sum": ("partial_sum", {"X": [_f(3, 6), _f(3, 6)]},
                    {"start_index": 2, "length": -1}, ["X"], ["X"]),
    "range": ("range", {"Start": [_c([0.0])], "End": [_c([5.0])],
                        "Step": [_c([0.5])]}, {}, [], []),
    "range_attrs": ("range", {}, {"start": 2, "end": 11, "step": 3,
                                  "dtype": "int64"}, [], []),
    "rank": ("rank", {"X": [_f(2, 3, 4)]}, {}, [], []),
    "reshape": ("reshape", {"X": [_f(2, 6)]}, {"shape": [0, 3, 2]}, ["X"],
                ["X"]),
    "reverse": ("reverse", {"X": [_f(3, 4)]}, {"axis": [1]}, ["X"], ["X"]),
    "reverse_int_axis": ("reverse", {"X": [_f(3, 4)]}, {"axis": 0}, ["X"],
                         []),
    "roll": ("roll", {"X": [_f(3, 4)]}, {"shifts": [1, -2], "axis": [0, 1]},
             ["X"], []),
    "roll_flat": ("roll", {"X": [_f(3, 4)]}, {"shifts": [5]}, ["X"], []),
    "scatter_nd": ("scatter_nd", {"Index": [_c([[1], [3], [1]], "int64")],
                                  "Updates": [_f(3, 4)]}, {"shape": [5, 4]},
                   ["Updates"], []),
    "scatter_nd_add": ("scatter_nd_add",
                       {"X": [_f(5, 4)], "Index": [_c([[4], [0], [4]],
                                                      "int64")],
                        "Updates": [_f(3, 4)]}, {}, ["X", "Updates"], []),
    "shape": ("shape", {"Input": [_f(2, 3, 4)]}, {}, [], []),
    "shard_index": ("shard_index", {"X": [_i(20, 6, 1)]},
                    {"index_num": 20, "nshards": 4, "shard_id": 1,
                     "ignore_value": -1}, [], ["X"]),
    "size": ("size", {"Input": [_f(2, 3)]}, {}, [], []),
    "split_ids": ("split_ids", {"Ids": [_i(30, 8)]}, {"num_shards": 3}, [],
                  []),
    "squeeze": ("squeeze", {"X": [_f(2, 1, 3, 1)]}, {"axes": [1]}, ["X"],
                ["X"]),
    "strided_slice": ("strided_slice", {"Input": [_f(6, 7)]},
                      {"axes": [0, 1], "starts": [1, -1], "ends": [5, -7],
                       "strides": [2, -2]}, ["Input"], []),
    "tile": ("tile", {"X": [_f(2, 3)]}, {"repeat_times": [2, 1, 2]}, ["X"],
             []),
    "top_k_v2": ("top_k_v2", {"X": [_f(3, 6)]}, {"k": 2, "axis": 1},
                 ["X"], ["X"]),
    "top_k_v2_smallest_ties": ("top_k_v2", {"X": [_ties(5, 3)]},
                               {"k": 3, "axis": 0, "largest": False}, [],
                               []),
    "transpose": ("transpose", {"X": [_f(2, 3, 4)]}, {"axis": [2, 0, 1]},
                  ["X"], ["X"]),
    "tril_triu": ("tril_triu", {"X": [_f(4, 5)]},
                  {"diagonal": 1, "lower": True}, ["X"], []),
    "tril_triu_upper": ("tril_triu", {"X": [_f(4, 5)]},
                        {"diagonal": -1, "lower": False}, ["X"], []),
    "unbind": ("unbind", {"X": [_f(3, 4)]}, {"axis": 1}, ["X"], ["X"]),
    "unique": ("unique", {"X": [_i(6, 10)]}, {}, [], []),
    "unique_with_counts": ("unique_with_counts", {"X": [_i(6, 3, 4)]}, {},
                           [], []),
    "unsqueeze": ("unsqueeze", {"X": [_f(2, 3)]}, {"axes": [0, 2]}, ["X"],
                  ["X"]),
    "unstack": ("unstack", {"X": [_f(2, 3, 4)]}, {"axis": 1}, ["X"],
                ["X"]),
    "where_index": ("where_index", {"Condition": [_b(3, 4)]}, {}, [], []),
    "pad": ("pad", {"X": [_f(2, 3)]},
            {"paddings": [1, 0, 2, 1], "pad_value": 0.5}, ["X"], ["X"]),
    "pad2d": ("pad2d", {"X": [_f(1, 2, 3, 4)]},
              {"paddings": [1, 0, 2, 1], "mode": "constant",
               "pad_value": -1.0}, ["X"], ["X"]),
    "pad2d_reflect": ("pad2d", {"X": [_f(1, 2, 3, 4)]},
                      {"paddings": [1, 2, 2, 1], "mode": "reflect"}, ["X"],
                      []),
    "pad2d_edge": ("pad2d", {"X": [_f(1, 2, 3, 4)]},
                   {"paddings": [0, 2, 1, 3], "mode": "edge"}, ["X"], []),
}

#: the random types: attrs, inputs, and the moments checked
RNG_CASES = {
    "uniform_random_batch_size_like": (
        {"Input": [_f(5, 3)]}, {"shape": [-1, 4], "min": -2.0, "max": 3.0,
                                "input_dim_idx": 0, "output_dim_idx": 0}),
    "gaussian_random_batch_size_like": (
        {"Input": [_f(5, 3)]}, {"shape": [-1, 4], "mean": 1.0, "std": 2.0,
                                "input_dim_idx": 0}),
    "bernoulli": ({"X": [lambda r: r.rand(4, 5).astype("float32")]}, {}),
    "exponential": ({"X": [_f(4, 5)]}, {"lambda": 2.0}),
    "gumbel_softmax": ({"X": [_f(4, 5)]}, {"temperature": 0.5}),
    # one row: the reference's categorical draw of num_samples from a
    # batch of rows fails (ROADMAP Queue 3, reference-side)
    "multinomial": ({"X": [lambda r: r.rand(5).astype("float32")]},
                    {"num_samples": 4}),
    "poisson": ({"X": [lambda r: (r.rand(4, 5) * 30).astype("float32")]},
                {}),
    "randint": ({}, {"shape": [4, 5], "low": -3, "high": 7,
                     "dtype": "int64"}),
    "randperm": ({}, {"n": 9, "dtype": "int64"}),
    "sampling_id": ({"X": [lambda r: r.rand(6, 4).astype("float32")]}, {}),
    "seed": ({}, {"seed": 123}),
}


def inputs(name, cases=None):
    """{slot: [numpy array]} of case `name` (of `cases`, default
    `CASES`, or `RNG_CASES` for a random type)."""
    if cases is None:
        cases = CASES if name in CASES else RNG_CASES
    makers = cases[name][1] if cases is CASES else cases[name][0]
    r = np.random.RandomState(sorted(cases).index(name))
    return {slot: [make(r) for make in ms] for slot, ms in makers.items()}
