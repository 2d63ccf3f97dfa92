"""The reference's `framework_ops` (21 types, with the tensor-array
aliases) and `core/selected_rows.py` in the port (paddle_tpu_torch, on
the CPU) against the JAX package; the `fluid.layers` functions that emit
them (`Print`, `Assert`, `multiplex`, `py_func`,
`tensor_array_to_tensor`, `reorder_lod_tensor_by_rank`) and the eleven
builders of earlier types that `layers/nn_extra.py` now exports.

Table-driven like `tests/test_torch_sequence_ops.py` (the cases of
`tests/torch_seq_cases.py`, checked by `tests/torch_case_parity.py`:
fp32 rtol 1e-5, integers exactly). `save` and `load` files cross between
the packages byte for byte; `shuffle_batch` is held as a permutation
that repeats under its seed (its draws differ from JAX's by design);
`run_program` runs a Program built in each package. A block holding a
host-side op runs eagerly with the reason, and one holding only device
ops takes the graph path."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as rfluid
import paddle_tpu.ops.framework_ops as rfo
from paddle_tpu.core.scope import Scope as RScope
from paddle_tpu.core.selected_rows import SelectedRows as RSelectedRows
from paddle_tpu.ops import registry as rreg

import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.ops.framework_ops as tfo
from paddle_tpu_torch.core.selected_rows import SelectedRows, sr_add

import torch_case_parity as parity
import torch_seq_cases as sc

NAMES = [n for n in sc.cases_of("framework_ops")
         if sc.CASES[n][0] not in sc.RNG]
TYPES = sorted({sc.CASES[n][0] for n in sc.cases_of("framework_ops")}
               | {"run_program"})
#: cases whose shape probe (zero-filled inputs) raises in both packages:
#: an all-false mask cannot place InTrue's rows
INFER_RAISES = {"merge_lod_tensor"}


@pytest.fixture(scope="module")
def reference():
    sc.prepare(rfo, tfo)
    return parity.reference_results(NAMES, cases=sc)


def test_cases_cover_framework_ops():
    ref = {t for t in rreg.registered_ops()
           if rreg.get_op(t).compute.__module__
           == "paddle_tpu.ops.framework_ops"}
    assert set(TYPES) == ref and len(TYPES) == 21
    assert ref | {"write_to_array", "read_from_array"} <= set(
        parity.treg.registered_ops())


@pytest.mark.parametrize("name", NAMES)
def test_op_matches_reference(name, reference):
    parity.check_case(name, reference[name], cases=sc)


@pytest.mark.parametrize("name", sorted(set(NAMES) - INFER_RAISES))
def test_infer_outputs_matches_reference(name, reference):
    parity.check_infer(name, cases=sc)


@pytest.mark.parametrize("name", sorted(INFER_RAISES))
def test_infer_outputs_raises_in_both(name):
    for reg in (parity.treg, rreg):
        with pytest.raises((RuntimeError, ValueError)):
            reg.infer_outputs(sc.CASES[name][0],
                              parity._specs(name, sc), {})


@pytest.mark.parametrize("op_type", TYPES)
def test_flags_match_the_reference(op_type):
    parity.check_flags(op_type)


# -- files ------------------------------------------------------------------

def test_save_and_load_cross_byte_for_byte(tmp_path, reference):
    """The `save` and `save_combine` ops of both packages write the same
    bytes (and the case table's own writer too); each package's `load`
    and `load_combine` read the other's file."""
    r = np.random.RandomState(0)
    a = r.randn(3, 4).astype("float32")
    b = r.randint(0, 9, (5,)).astype("int32")
    files = {}
    for tag, reg, conv in (("ref", rreg, jnp.asarray),
                           ("port", parity.treg, torch.tensor)):
        one, comb = str(tmp_path / (tag + "1")), str(tmp_path / (tag + "2"))
        for op, ins, path in (("save", {"X": [conv(a)]}, one),
                              ("save_combine", {"X": [conv(a), conv(b)]},
                               comb)):
            reg.get_op(op).compute(ins, {"file_path": path, "var_name": "a",
                                         "var_names": ["a", "b"],
                                         "_device": torch.device("cpu")})
        files[tag] = (open(one, "rb").read(), open(comb, "rb").read())
    assert files["ref"] == files["port"]
    sc.write_ptpu(str(tmp_path / "table"), {"a": a, "b": b})
    assert open(tmp_path / "table", "rb").read() == files["ref"][1]
    got = parity.port("load_combine", {}, {"file_path": str(tmp_path
                                                            / "ref2")})
    np.testing.assert_array_equal(got["Out"][0].numpy(), a)
    np.testing.assert_array_equal(got["Out"][1].numpy(), b)
    want = rreg.get_op("load").compute({}, {"file_path": str(tmp_path
                                                             / "port1")})
    np.testing.assert_array_equal(np.asarray(want["Out"]), a)


# -- selected rows ------------------------------------------------------------

def test_merge_dedups_rows():
    """As tests/test_selected_rows.py holds the reference's."""
    sr = SelectedRows(torch.tensor([3, 1, 3]),
                      torch.tensor([[1.0], [2.0], [10.0]]), height=6)
    m = sr.merge()
    assert m.rows.tolist() == [1, 3, -1]
    np.testing.assert_allclose(m.to_dense().numpy().reshape(-1),
                               [0, 2, 0, 11, 0, 0])


def test_selected_rows_match_reference():
    """merge (the distinct rows sorted, -1 padding with zero values,
    each row's sum in its input order), to_dense, + and sr_add against
    the reference's, bit for bit."""
    r = np.random.RandomState(1)
    rows = r.randint(0, 7, 12).astype("int32")
    vals = r.randn(12, 3).astype("float32")
    other = r.randn(9, 3).astype("float32")
    t = SelectedRows(torch.tensor(rows), torch.tensor(vals), 9)
    ref = RSelectedRows(jnp.asarray(rows), jnp.asarray(vals), 9)
    tm, rm = t.merge(), ref.merge()
    np.testing.assert_array_equal(tm.rows.numpy(), np.asarray(rm.rows))
    np.testing.assert_array_equal(tm.values.numpy(), np.asarray(rm.values))
    np.testing.assert_array_equal(t.to_dense().numpy(),
                                  np.asarray(ref.to_dense()))
    both = t + t
    assert isinstance(both, SelectedRows) and both.rows.shape == (24,)
    np.testing.assert_allclose(
        sr_add(t, torch.tensor(other)).numpy(),
        np.asarray(ref.to_dense() + other), rtol=1e-6)
    assert t + 0 is t and sr_add(1.0, 2.0) == 3.0


def test_selected_rows_ops_match_reference():
    """The three selected-rows ops given a SelectedRows."""
    r = np.random.RandomState(2)
    rows = np.asarray([4, 0, 4, 2, 5], "int32")
    vals = r.randn(5, 3).astype("float32")
    t = SelectedRows(torch.tensor(rows), torch.tensor(vals), 6)
    ref = RSelectedRows(jnp.asarray(rows), jnp.asarray(vals), 6)
    got = parity.port("get_tensor_from_selected_rows", {"X": [t]}, {})
    np.testing.assert_array_equal(got["Out"][0].numpy(), vals)
    got = parity.port("merge_selected_rows", {"X": [t]}, {})["Out"][0]
    want = rreg.get_op("merge_selected_rows").compute({"X": [ref]},
                                                      {})["Out"]
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  np.asarray(want.to_dense()))
    got = parity.port("split_selected_rows", {"X": [t]},
                      {"height_sections": [3, 3]})["Out"]
    want = rreg.get_op("split_selected_rows").compute(
        {"X": [ref]}, {"height_sections": [3, 3]})["Out"]
    for g, w in zip(got, want):
        assert g.height == w.height
        np.testing.assert_array_equal(g.rows.numpy(), np.asarray(w.rows))
        np.testing.assert_array_equal(g.values.numpy(),
                                      np.asarray(w.values))


# -- shuffle_batch, py_func, run_program, print, assert ----------------------

def _shuffle(seed):
    from paddle_tpu_torch.core.rng import seed_tensor

    x = torch.arange(21, dtype=torch.float32).reshape(7, 3)
    out = parity.port("shuffle_batch", {"X": [x]},
                      {"_rng_seed": seed_tensor(seed, "cpu")})
    return x, out


def test_shuffle_batch_is_a_seeded_permutation():
    """Out is X in the order ShuffleIdx, a permutation; the same seed
    repeats it and another seed gives another."""
    x, out = _shuffle(5)
    idx = out["ShuffleIdx"][0]
    assert idx.dtype == torch.int32 and sorted(idx.tolist()) == list(range(7))
    assert torch.equal(out["Out"][0], x[idx.long()])
    assert torch.equal(_shuffle(5)[1]["ShuffleIdx"][0], idx)
    assert not torch.equal(_shuffle(6)[1]["ShuffleIdx"][0], idx)
    assert out["SeedOut"][0].shape == (1,)


def test_run_program_matches_reference():
    """`run_program` of a Program built in each package, from the same
    parameters: the same fetches."""
    r_scope, ins, r_attrs = sc.run_program_case(rfluid, rfluid.CPUPlace())
    t_scope, _, t_attrs = sc.run_program_case(tfluid, tfluid.CPUPlace())
    for n in ("fc_0.w_0", "fc_0.b_0"):
        t_scope.set_var(n, torch.tensor(np.asarray(r_scope.find_var(n))))
    with rfluid.scope_guard(r_scope):
        want = rreg.get_op("run_program").compute(
            {"X": [jnp.asarray(ins["X"][0])]}, r_attrs)["Out"]
    with tfluid.scope_guard(t_scope):
        got = parity.port("run_program", {"X": [torch.tensor(ins["X"][0])]},
                          t_attrs)["Out"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_print_writes_the_reference_line(capsys):
    x = np.arange(6, dtype="float32").reshape(2, 3)
    attrs = {"message": "m", "summarize": 4}
    rreg.get_op("print").compute({"In": [jnp.asarray(x)]}, attrs)
    want = capsys.readouterr().out
    out = parity.port("print", {"In": [torch.tensor(x)]}, attrs)
    assert capsys.readouterr().out == want
    assert want.startswith("m dtype=float32 shape=(2, 3) data=[0. 1. 2. 3.]")
    assert torch.equal(out["Out"][0], torch.tensor(x))


def test_assert_raises_with_the_reference_message():
    ins = {"Cond": [np.asarray([True, False])],
           "Data": [np.asarray([1.5, 2.5, 3.5], "float32")]}
    msgs = []
    for reg, conv in ((rreg, jnp.asarray), (parity.treg, torch.tensor)):
        with pytest.raises(AssertionError) as e:
            reg.get_op("assert").compute(
                {k: [conv(v[0])] for k, v in ins.items()},
                {"summarize": 2, "_device": torch.device("cpu")})
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "Assert failed: [1.5 2.5]"


# -- the layers ---------------------------------------------------------------

def _double(x):
    return x * 2.0


def _framework_layers(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        x = L.data("x", shape=[4], dtype="float32")
        y = L.data("y", shape=[4], dtype="float32")
        ids = L.data("ids", shape=[1], dtype="int32")
        arr = L.data("arr", shape=[3, 2, 5], dtype="float32",
                     append_batch_size=False)
        rank = L.data("rank", shape=[3], dtype="int64",
                      append_batch_size=False)
        printed = L.Print(x, message="x is")
        L.Assert(L.reduce_all(L.greater_equal(
            L.abs(x), L.fill_constant([1], "float32", 0.0))))
        outs = [printed, L.multiplex([x, y], ids),
                L.py_func(_double, x, L.create_tensor("float32")),
                L.reorder_lod_tensor_by_rank(L.reshape(arr, [3, 10]), rank)]
        outs += list(L.tensor_array_to_tensor(arr, axis=1))
        outs += list(L.tensor_array_to_tensor(arr, axis=0, use_stack=True))
        outs += [L.selu(x), L.softshrink(x, 0.3), L.hard_shrink(x, 0.4),
                 L.tanh_shrink(x), L.brelu(x, 0.0, 0.5),
                 L.soft_relu(x, 10.0), L.thresholded_relu(x, 0.2),
                 L.pad_constant_like(L.concat([x, y], axis=1), x, 1.5),
                 L.shard_index(L.cast(ids, "int64"), 20, 2, 1)]
        shapes = [L.uniform_random_batch_size_like(x, [-1, 3]),
                  L.sampling_id(L.softmax(x))]
    return main, startup, outs, shapes


def test_framework_layers_match_reference():
    """The layers in both packages: the same programs op by op, the same
    fetches from the same feed (the random builders by shape and
    dtype)."""
    r = np.random.RandomState(4)
    feed = {"x": r.randn(3, 4).astype("float32"),
            "y": r.randn(3, 4).astype("float32"),
            "ids": np.asarray([[1], [0], [1]], "int32"),
            "arr": r.randn(3, 2, 5).astype("float32"),
            "rank": np.asarray([2, 0, 1], "int64")}
    ref, port = _framework_layers(rfluid), _framework_layers(tfluid)
    parity.run_both(rfluid, tfluid, ref[:3], port[:3], feed)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        port[0], feed=feed, fetch_list=port[3], scope=tfluid.Scope())
    assert got[0].shape == (3, 3) and got[0].dtype == np.float32
    assert got[1].shape == (3,) and got[1].dtype == np.int32


def _mixed_program(host_op):
    main, startup = tfluid.Program(), tfluid.Program()
    L = tfluid.layers
    with tfluid.program_guard(main, startup), tfluid.unique_name_guard():
        x = L.data("x", shape=[4], dtype="float32")
        y = L.data("y", shape=[4], dtype="float32")
        ids = L.data("ids", shape=[1], dtype="int32")
        out = L.multiplex([x, y], ids)
        if host_op:
            out = L.Print(out)
    return main, out


@pytest.mark.parametrize("host_op", [False, True])
def test_host_ops_keep_their_block_eager(host_op, capsys):
    """Through the executor's graph path (the CPU's stand-in for
    capture), a block of device ops takes it and one holding `print`
    runs eagerly, the reason naming the op."""
    main, out = _mixed_program(host_op)
    exe = tfluid.Executor(tfluid.CPUPlace(), graph_runner=lambda b: b())
    feed = {"x": np.ones((2, 4), "float32"), "y": np.zeros((2, 4), "float32"),
            "ids": np.asarray([[1], [0]], "int32")}
    for _ in range(2):
        got = exe.run(main, feed=feed, fetch_list=[out], scope=tfluid.Scope())
    np.testing.assert_array_equal(got[0][:, 0], [0.0, 1.0])
    entry = exe.last_entry
    if host_op:
        assert entry.mode == "eager" and "'print'" in entry.reason \
            and "no_jit" in entry.reason
        assert "dtype=float32 shape=(2, 4)" in capsys.readouterr().out
    else:
        assert entry.mode == "graph"
