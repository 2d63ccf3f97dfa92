"""The op cases of the sequence slice: the reference's `sequence_ops`
(18 types), `array_ops` (13, with the aliases `write_to_array` and
`read_from_array`), `metric_ops` (6 besides `accuracy`) and
`framework_ops` (21 but `run_program`, whose Program is built per
package: `run_program_case`). `tests/test_torch_sequence_ops.py` and
`tests/test_torch_framework_ops.py` hold each against the JAX package on
the CPU; `tests/test_torch_sequence_cuda.py` and `chip_smoke.py` phase
20 leg c, the card against the CPU. Plain numpy and no JAX, so the
card's machine imports it too.

`CASES`: name -> (op type, {slot: [numpy maker]}, attrs, float input
slots to differentiate, batch-carrying slots for a -1 inference check),
as in `tests/torch_nn_cases.py`. A maker takes a
`numpy.random.RandomState`; `inputs(name)` draws a case's inputs from
the state seeded by its position among the names. The file cases
(`save`, `load`, ...) use paths under `SCRATCH`, and `py_func` the
callable `PY_FUNC` under id `PY_FUNC_ID`: `prepare(*modules)` writes the
files the `load` cases read (with this file's own `PTPU0001` writer)
and registers `PY_FUNC` in each given `framework_ops` module.
`MODULE`: op type -> the reference file that registers it."""
import atexit
import os
import shutil
import struct
import tempfile

import numpy as np

#: where the file cases write and read (one directory a process)
SCRATCH = os.path.join(tempfile.gettempdir(),
                       "torch_seq_cases_%d" % os.getpid())
PY_FUNC_ID = 9001


def PY_FUNC(x, y):
    return [x * 2.0 + 1.0, (x.sum(-1) > y.sum(-1)).astype("int64")]


def _f(*shape, scale=1.0):
    return lambda r: (r.randn(*shape) * scale).astype("float32")


def _i(high, *shape, low=0, dtype="int64"):
    return lambda r: r.randint(low, high, size=shape).astype(dtype)


def _c(v, dtype="float32"):
    return lambda r: np.asarray(v, dtype)


def _probs(*shape):
    def make(r):
        e = np.exp(r.randn(*shape))
        return (e / e.sum(-1, keepdims=True)).astype("float32")
    return make


def _mask(*vals):
    return _c(np.asarray(vals, bool).reshape(-1, 1), "bool")


def _path(name):
    return os.path.join(SCRATCH, name)


#: (B, T, D) of the padded cases; the ragged lengths of their rows
B, T, D = 3, 5, 4
LENGTH = (5, 2, 4)
_LEN = _c(LENGTH, "int64")
_X = _f(B, T, D)
_PERM = _c([2, 0, 3, 1], "int64")
#: the arrays the `load` cases read (written by `prepare`)
LOAD_FILES = {
    "load.ptpu": {"w": np.arange(12, dtype="float32").reshape(3, 4)},
    "load_int.ptpu": {"ids": np.arange(6, dtype="int64").reshape(2, 3)},
    "load_combine.ptpu": {"a": np.linspace(-1, 1, 6, dtype="float32")
                          .reshape(2, 3),
                          "b": np.arange(4, dtype="int32")},
}


def _pool(ptype, length=True):
    ins = {"X": [_X]}
    if length:
        ins["Length"] = [_LEN]
    return ("sequence_pool", ins, {"pooltype": ptype}, ["X"],
            ["X", "Length"] if length else ["X"])


CASES = {
    # -- sequence_ops ---------------------------------------------------------
    "sequence_mask": ("sequence_mask", {"X": [_c([3, 1, 5, 2], "int64")]},
                      {"maxlen": 6}, [], ["X"]),
    "sequence_mask_float": ("sequence_mask", {"X": [_c([3, 0, 2], "int64")]},
                            {"maxlen": 4, "out_dtype": "float32"}, [], []),
    "sequence_mask_negative_maxlen": (
        "sequence_mask", {"X": [_c([3, 1, 5, 2], "int64")]}, {}, [], []),
    "sequence_pool_sum": _pool("SUM"),
    "sequence_pool_average": _pool("AVERAGE"),
    "sequence_pool_sqrt": _pool("SQRT"),
    "sequence_pool_max": _pool("MAX"),
    "sequence_pool_last": _pool("LAST"),
    "sequence_pool_first": _pool("FIRST"),
    "sequence_pool_sqrt_full": _pool("SQRT", length=False),
    "sequence_pool_max_full": _pool("MAX", length=False),
    "sequence_pool_last_full": _pool("LAST", length=False),
    "sequence_softmax": ("sequence_softmax", {"X": [_f(B, T)],
                                              "Length": [_LEN]},
                         {}, ["X"], ["X", "Length"]),
    "sequence_softmax_full": ("sequence_softmax", {"X": [_f(B, T)]}, {},
                              ["X"], ["X"]),
    "sequence_expand": ("sequence_expand", {"X": [_f(3, 4)],
                                            "Y": [_f(3, 2)]},
                        {}, ["X"], []),
    "sequence_reshape": ("sequence_reshape", {"X": [_f(3, 4, 6)]},
                         {"new_dim": 12}, ["X"], []),
    "sequence_concat": ("sequence_concat", {"X": [_f(B, 2, D), _f(B, 3, D)]},
                        {}, ["X"], []),
    "sequence_reverse": ("sequence_reverse", {"X": [_X], "Length": [_LEN]},
                         {}, ["X"], ["X", "Length"]),
    "sequence_reverse_full": ("sequence_reverse", {"X": [_X]}, {}, ["X"],
                              ["X"]),
    "sequence_pad": ("sequence_pad", {"X": [_X], "Length": [_LEN],
                                      "PadValue": [_c([-1.5])]},
                     {}, ["X"], ["X", "Length"]),
    "sequence_pad_full": ("sequence_pad", {"X": [_X]}, {}, ["X"], ["X"]),
    "sequence_unpad": ("sequence_unpad", {"X": [_X], "Length": [_LEN]}, {},
                       ["X"], ["X", "Length"]),
    "sequence_slice": ("sequence_slice",
                       {"X": [_X], "Offset": [_c([[1], [0], [2]], "int64")],
                        "Length": [_c([[2], [3], [1]], "int64")]},
                       {}, ["X"], []),
    "sequence_erase": ("sequence_erase", {"X": [_i(6, B, 6)]},
                       {"tokens": [2, 3]}, [], ["X"]),
    "sequence_expand_as": ("sequence_expand_as", {"X": [_f(2, 4)],
                                                  "Y": [_f(6, 3)]},
                           {}, ["X"], []),
    "sequence_enumerate": ("sequence_enumerate", {"X": [_i(9, B, T)]},
                           {"win_size": 3, "pad_value": -1}, [], ["X"]),
    "sequence_conv": ("sequence_conv", {"X": [_X],
                                        "Filter": [_f(3 * D, 6, scale=0.5)]},
                      {"contextLength": 3, "contextStart": -1},
                      ["X", "Filter"], ["X"]),
    "sequence_conv_4": ("sequence_conv",
                        {"X": [_X], "Filter": [_f(4 * D, 6, scale=0.5)]},
                        {"contextLength": 4, "contextStart": -2},
                        ["X", "Filter"], ["X"]),
    "sequence_scatter": ("sequence_scatter",
                         {"X": [_f(6, 3)], "Ids": [_c([1, 3, 1, 5, 1],
                                                      "int64")],
                          "Updates": [_f(5, 3)]},
                         {}, ["X", "Updates"], []),
    "lod_reset": ("lod_reset", {"X": [_f(3, 4)]}, {}, ["X"], ["X"]),
    "sequence_number_count": ("sequence_number_count", {"X": [_f(3, 4)]},
                              {}, [], []),
    "ctc_align": ("ctc_align", {"Input": [_c([[0, 1, 1, 0, 2, 2, 0, 3],
                                              [4, 4, 0, 0, 4, 1, 1, 2]],
                                             "int32")],
                                "InputLength": [_c([[8], [6]], "int64")]},
                  {"blank": 0, "merge_repeated": True, "padding_value": -1},
                  [], []),
    "ctc_align_unmerged": ("ctc_align", {"Input": [_i(4, 2, 7,
                                                      dtype="int32")]},
                           {"blank": 3, "merge_repeated": False}, [], []),
    # -- array_ops ------------------------------------------------------------
    "array_write": ("array_write", {"Array": [_f(4, 3, 2)],
                                    "X": [_f(3, 2)], "I": [_c([2], "int64")],
                                    "Len": [_c([1], "int64")]},
                    {}, ["Array", "X"], []),
    "array_write_new": ("array_write", {"X": [_f(3, 2)],
                                        "I": [_c([1], "int64")]},
                        {"max_len": 5}, ["X"], []),
    "write_to_array": ("write_to_array", {"Array": [_f(4, 3)],
                                          "X": [_f(3)],
                                          "I": [_c([3], "int64")]},
                       {}, ["Array", "X"], []),
    "array_read": ("array_read", {"Array": [_f(4, 3, 2)],
                                  "I": [_c([1], "int64")]},
                   {}, ["Array"], []),
    "read_from_array": ("read_from_array", {"X": [_f(4, 3)],
                                            "I": [_c([3], "int64")]},
                        {}, ["X"], []),
    "lod_array_length": ("lod_array_length", {"X": [_f(4, 3)],
                                              "Len": [_c([3], "int64")]},
                         {}, [], []),
    "lod_array_length_capacity": ("lod_array_length", {"X": [_f(4, 3)]},
                                  {}, [], []),
    "array_to_lod_tensor": ("array_to_lod_tensor", {"X": [_f(4, 3, 2)]},
                            {}, ["X"], []),
    "lod_tensor_to_array": ("lod_tensor_to_array", {"X": [_f(6, 2)]},
                            {"max_len": 3}, ["X"], []),
    "tensor_array_to_tensor": ("tensor_array_to_tensor",
                               {"X": [_f(4, 3, 2)]}, {"axis": 1},
                               ["X"], []),
    "tensor_array_to_tensor_stack": ("tensor_array_to_tensor",
                                     {"X": [_f(4, 3, 2)]},
                                     {"axis": 1, "use_stack": True},
                                     ["X"], []),
    "reorder_lod_tensor_by_rank": ("reorder_lod_tensor_by_rank",
                                   {"X": [_f(4, 3)], "RankTable": [_PERM]},
                                   {}, ["X"], []),
    "reorder_lod_tensor_by_rank_grad": (
        "reorder_lod_tensor_by_rank_grad",
        {"X": [_f(4, 3)], "RankTable": [_PERM]}, {}, ["X"], []),
    "lod_rank_table": ("lod_rank_table",
                       {"X": [_f(4, 5, 2)],
                        "Length": [_c([3, 5, 1, 5], "int64")]},
                       {}, [], []),
    "lod_rank_table_full": ("lod_rank_table", {"X": [_f(4, 5, 2)]}, {},
                            [], ["X"]),
    "max_sequence_len": ("max_sequence_len",
                         {"Length": [_c([3, 5, 1, 4], "int64")]}, {}, [],
                         []),
    "max_sequence_len_lengths": ("max_sequence_len",
                                 {"Lengths": [_c([6, 2], "int64")]}, {},
                                 [], []),
    "shrink_rnn_memory": ("shrink_rnn_memory",
                          {"X": [_f(4, 3)], "I": [_c([2], "int64")],
                           "Length": [_c([3, 1, 2, 5], "int64")]},
                          {}, ["X"], []),
    # -- metric_ops -----------------------------------------------------------
    "auc": ("auc", {"Predict": [_probs(16, 2)],
                    "Label": [_i(2, 16, 1)],
                    "StatPos": [_i(4, 64)], "StatNeg": [_i(4, 64)]},
            {"num_thresholds": 63}, [], []),
    "auc_1d": ("auc", {"Predict": [_c(np.linspace(0, 1, 9))],
                       "Label": [_c([0, 0, 1, 0, 1, 1, 0, 1, 1], "int64")],
                       "StatPos": [_c(np.zeros(11), "int64")],
                       "StatNeg": [_c(np.zeros(11), "int64")]},
               {"num_thresholds": 10}, [], []),
    "mean_iou": ("mean_iou", {"Predictions": [_i(3, 2, 4, 4, dtype="int32")],
                              "Labels": [_i(3, 2, 4, 4, dtype="int32")]},
                 {"num_classes": 4}, [], []),
    "precision_recall": ("precision_recall",
                         {"MaxProbs": [_f(10, 1)], "Indices": [_i(3, 10, 1)],
                          "Labels": [_i(3, 10, 1)],
                          "StatesInfo": [_i(5, 3, 4, dtype="float32")]},
                         {"class_number": 3}, [], []),
    "precision_recall_batch": ("precision_recall",
                               {"MaxProbs": [_f(10, 1)],
                                "Indices": [_i(4, 10, 1)],
                                "Labels": [_i(4, 10, 1)]},
                               {"class_number": 4}, [], []),
    "edit_distance": ("edit_distance",
                      {"Hyps": [_c([[1, 2, 3, 0]], "int64")],
                       "Refs": [_c([[1, 3, 3, 4]], "int64")],
                       "HypsLength": [_c([3], "int64")],
                       "RefsLength": [_c([4], "int64")]}, {}, [], []),
    "edit_distance_normalized": ("edit_distance",
                                 {"Hyps": [_i(4, 3, 5)],
                                  "Refs": [_i(4, 3, 6)],
                                  "HypsLength": [_c([5, 2, 0], "int64")],
                                  "RefsLength": [_c([6, 3, 4], "int64")]},
                                 {"normalized": True}, [], []),
    "chunk_eval": ("chunk_eval",
                   {"Inference": [_c([0, 1, 4, 2, 4, 4], "int64")],
                    "Label": [_c([0, 1, 4, 2, 3, 4], "int64")]},
                   {"num_chunk_types": 2}, [], []),
    "chunk_eval_seqlength": ("chunk_eval",
                             {"Inference": [_c([[0, 1, 0, 0], [1, 4, 0, 0]],
                                               "int64")],
                              "Label": [_c([[0, 1, 4, 4], [0, 4, 0, 0]],
                                           "int64")],
                              "SeqLength": [_c([2, 2], "int64")]},
                             {"num_chunk_types": 2}, [], []),
    "chunk_eval_iobes": ("chunk_eval", {"Inference": [_i(9, 3, 8)],
                                        "Label": [_i(9, 3, 8)]},
                         {"num_chunk_types": 2, "chunk_scheme": "IOBES",
                          "excluded_chunk_types": [1]}, [], []),
    "chunk_eval_plain": ("chunk_eval", {"Inference": [_i(4, 2, 7)],
                                        "Label": [_i(4, 2, 7)]},
                         {"num_chunk_types": 3, "chunk_scheme": "plain"},
                         [], []),
    "positive_negative_pair": ("positive_negative_pair",
                               {"Score": [_i(4, 10, 1, dtype="float32")],
                                "Label": [_i(3, 10, 1, dtype="float32")],
                                "QueryID": [_i(3, 10, 1)],
                                "Weight": [_f(10, 1)]},
                               {"column": -1}, [], []),
    "positive_negative_pair_accum": (
        "positive_negative_pair",
        {"Score": [_f(8, 2)], "Label": [_i(2, 8, 1, dtype="float32")],
         "QueryID": [_i(2, 8, 1)],
         "AccumulatePositivePair": [_c([1.5])],
         "AccumulateNegativePair": [_c([2.0])],
         "AccumulateNeutralPair": [_c([0.5])]}, {"column": 1}, [], []),
    # -- framework_ops --------------------------------------------------------
    "save": ("save", {"X": [_f(3, 4)]},
             {"file_path": _path("save.ptpu"), "var_name": "x"}, [], []),
    "save_fp16": ("save", {"X": [_f(2, 3)]},
                  {"file_path": _path("save_fp16.ptpu"),
                   "save_as_fp16": True}, [], []),
    "load": ("load", {}, {"file_path": _path("load.ptpu")}, [], []),
    "load_int": ("load", {}, {"file_path": _path("load_int.ptpu")}, [], []),
    "load_fp16": ("load", {}, {"file_path": _path("load.ptpu"),
                               "load_as_fp16": True}, [], []),
    "save_combine": ("save_combine", {"X": [_f(2, 3), _i(5, 4)]},
                     {"file_path": _path("save_combine.ptpu"),
                      "var_names": ["p", "q"]}, [], []),
    "load_combine": ("load_combine", {},
                     {"file_path": _path("load_combine.ptpu")}, [], []),
    "print": ("print", {"In": [_f(3, 4)]},
              {"message": "sequence slice", "summarize": 5}, [], []),
    "assert": ("assert", {"Cond": [_c([True, True], "bool")],
                          "Data": [_f(2)]}, {"summarize": 2}, [], []),
    "py_func": ("py_func", {"X": [_f(3, 4), _f(3, 4)]},
                {"func_id": PY_FUNC_ID}, [], []),
    "multiplex": ("multiplex", {"X": [_f(4, 3), _f(4, 3), _f(4, 3)],
                                "Ids": [_c([[2], [0], [1], [2]], "int32")]},
                  {}, ["X"], []),
    "select_input": ("select_input", {"X": [_f(2, 3), _f(2, 3)],
                                      "Mask": [_c([1], "int32")]},
                     {}, [], []),
    "select_output": ("select_output", {"X": [_f(2, 3)],
                                        "Mask": [_c([1], "int32")]},
                      {"n_outputs": 2}, [], []),
    "split_lod_tensor": ("split_lod_tensor",
                         {"X": [_f(4, 3)], "Mask": [_mask(1, 0, 0, 1)]},
                         {}, [], []),
    "merge_lod_tensor": ("merge_lod_tensor",
                         {"InTrue": [_f(2, 3)], "InFalse": [_f(2, 3)],
                          "Mask": [_mask(0, 1, 1, 0)]}, {}, [], []),
    "coalesce_tensor": ("coalesce_tensor", {"Input": [_f(2, 3), _f(4)]},
                        {}, ["Input"], []),
    "shuffle_batch": ("shuffle_batch", {"X": [_f(7, 3)]}, {}, [], []),
    "get_tensor_from_selected_rows": ("get_tensor_from_selected_rows",
                                      {"X": [_f(4, 3)]}, {}, [], []),
    "merge_selected_rows": ("merge_selected_rows", {"X": [_f(4, 3)]}, {},
                            [], []),
    "split_selected_rows": ("split_selected_rows", {"X": [_f(6, 3)]},
                            {"height_sections": [2, 4]}, [], []),
    "quantize": ("quantize", {"Input": [_f(3, 4, scale=4.0)]},
                 {"Scale": 20.0}, [], ["Input"]),
    "quantize_unsigned": ("quantize", {"Input": [_f(3, 4)]},
                          {"Scale": 100.0, "is_negative_input": False},
                          [], []),
    "dequantize": ("dequantize", {"Input": [_i(127, 3, 4, low=-128,
                                               dtype="int8")]},
                   {"Scale": 20.0}, [], []),
    "requantize": ("requantize", {"Input": [_i(127, 3, 4, low=-128,
                                               dtype="int8")]},
                   {"Scale_in": 20.0, "Scale_out": 35.0}, [], []),
}

#: the random types: held as a permutation, not against the reference's
#: draws (tests/test_torch_framework_ops.py)
RNG = {"shuffle_batch"}
_MODULES = {
    "sequence_ops": {
        "sequence_mask", "sequence_pool", "sequence_softmax",
        "sequence_expand", "sequence_reshape", "sequence_concat",
        "sequence_reverse", "sequence_pad", "sequence_unpad",
        "sequence_slice", "sequence_erase", "sequence_expand_as",
        "sequence_enumerate", "sequence_conv", "sequence_scatter",
        "lod_reset", "sequence_number_count", "ctc_align"},
    "array_ops": {
        "array_write", "array_read", "write_to_array", "read_from_array",
        "lod_array_length", "array_to_lod_tensor", "lod_tensor_to_array",
        "tensor_array_to_tensor", "reorder_lod_tensor_by_rank",
        "reorder_lod_tensor_by_rank_grad", "lod_rank_table",
        "max_sequence_len", "shrink_rnn_memory"},
    "metric_ops": {"auc", "mean_iou", "precision_recall", "edit_distance",
                   "chunk_eval", "positive_negative_pair"},
}


def _module(op_type):
    return next((m for m, ts in _MODULES.items() if op_type in ts),
                "framework_ops")


#: op type -> the reference file that registers it
MODULE = {c[0]: _module(c[0]) for c in CASES.values()}
MODULE["run_program"] = "framework_ops"


def cases_of(*modules):
    """The case names whose op type the reference registers in one of
    `modules` ("sequence_ops", "array_ops", "metric_ops",
    "framework_ops")."""
    return sorted(n for n, c in CASES.items() if MODULE[c[0]] in modules)


def inputs(name):
    """{slot: [numpy array]} of case `name`."""
    r = np.random.RandomState(sorted(CASES).index(name))
    return {slot: [make(r) for make in ms]
            for slot, ms in CASES[name][1].items()}


def write_ptpu(path, named):
    """`named` (name -> array) in the `PTPU0001` format, written here
    from its description (not by either package's writer)."""
    with open(path, "wb") as f:
        f.write(b"PTPU0001" + struct.pack("<I", len(named)))
        for name, arr in named.items():
            hdr = ("%s|%s" % (arr.dtype.str, ",".join(map(str, arr.shape))))
            for part in (name.encode(), hdr.encode()):
                f.write(struct.pack("<I", len(part)) + part)
            data = np.ascontiguousarray(arr).tobytes()
            f.write(struct.pack("<Q", len(data)) + data)


def prepare(*framework_ops_modules):
    """Write the files the `load` cases read and register `PY_FUNC` as
    `PY_FUNC_ID` in each given module's py_func registry (`_PY_FUNCS`)."""
    if not os.path.isdir(SCRATCH):
        os.makedirs(SCRATCH)
        atexit.register(shutil.rmtree, SCRATCH, True)
    for fname, named in LOAD_FILES.items():
        write_ptpu(_path(fname), named)
    for mod in framework_ops_modules:
        mod._PY_FUNCS[PY_FUNC_ID] = PY_FUNC


def run_program_case(fluid, device_place):
    """`run_program` of the slice: a Program (fc 4 -> 3 with relu, then
    a sum) built in `fluid`'s fresh programs, its startup run, and the
    op's (ins, attrs) to run it on two feeds [2, 4]: (the startup
    scope's params, {slot: [numpy]}, attrs)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        h = fluid.layers.fc(input=x, size=3, act="relu")
        s = fluid.layers.reduce_sum(h)
    scope = fluid.Scope()
    fluid.Executor(device_place).run(startup, scope=scope)
    r = np.random.RandomState(3)
    return scope, {"X": [r.randn(2, 4).astype("float32")]}, {
        "program": main, "feed_names": ["x"],
        "fetch_names": [h.name, s.name]}


def ragged_net(fluid, seq, vocab=1000, emb=64, classes=2, seed=37):
    """A small classifier over ragged rows that reads a Length feed in
    every sequence layer: an embedding and a tanh fc over padded [B, seq]
    ids, `sequence_pool(length=...)` in each of its six types, attention
    weights (an fc without bias) from `sequence_softmax(length=...)`
    over the rows reversed by `sequence_reverse(length=...)`, all
    concatenated into fc(classes,
    softmax), cross_entropy, Adagrad. Returns (main, startup, loss, feed)
    where `feed(batch, rng)` draws ragged id sequences and pads them
    through `fluid.create_lod_tensor(...).to_padded()`."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        words = L.data(name="words", shape=[seq], dtype="int64")
        length = L.data(name="length", shape=[], dtype="int64")
        label = L.data(name="label", shape=[1], dtype="int64")
        h = L.fc(input=L.embedding(words, size=[vocab, emb]), size=emb,
                 num_flatten_dims=2, act="tanh")
        feats = [L.sequence_pool(h, t, length=length)
                 for t in ("sum", "average", "sqrt", "max", "last", "first")]
        # no bias: softmax is blind to a shift, so a bias's exact
        # gradient is 0 and its computed one rounding noise
        scores = L.reshape(L.fc(input=h, size=1, num_flatten_dims=2,
                                bias_attr=False), [-1, seq])
        att = L.sequence_softmax(scores, length=length)
        rev = L.sequence_reverse(h, length=length)
        feats.append(L.reshape(L.matmul(L.unsqueeze(att, [1]), rev),
                               [-1, emb]))
        pred = L.fc(input=L.concat(feats, axis=1), size=classes,
                    act="softmax")
        loss = L.mean(L.cross_entropy(input=pred, label=label))
        fluid.optimizer.Adagrad(learning_rate=0.01).minimize(loss)

    def feed(batch, rng):
        lens = rng.randint(1, seq + 1, batch)
        lens[0] = seq
        ids = rng.randint(1, vocab, (int(lens.sum()), 1)).astype("int64")
        padded, lengths = fluid.create_lod_tensor(
            ids, [lens.tolist()], fluid.CPUPlace()).to_padded()
        return {"words": padded[..., 0], "length": lengths,
                "label": rng.randint(0, classes, (batch, 1)).astype("int64")}

    return main, startup, loss, feed
