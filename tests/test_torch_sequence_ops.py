"""The reference's `sequence_ops` (18 types), `array_ops` (13) and the
rest of `metric_ops` (6) in the port (paddle_tpu_torch, on the CPU)
against the JAX package; `core/lod.py`'s LoDTensor; the sequence
layers of `fluid.layers` and `fluid.nets`.

Table-driven (`tests/torch_seq_cases.py`, checked by
`tests/torch_case_parity.py`): each case's reference runs once in a
module fixture (forward and `jax.vjp` under one seeded cotangent); the
port's outputs within fp32 rtol 1e-5 (integer outputs exactly, in the
device dtype), its gradients likewise, `infer_outputs` with a -1 batch
equal to the reference's, and the registry flags equal. Ragged rows
come as padding plus a Length vector. Where the reference departs from
Paddle (a negative `sequence_mask` maxlen, the `sequence_mask` layer's
slot) the port follows the reference's op and Paddle's layer, and the
test pins the reference's behaviour (ROADMAP Queue 3, reference-side)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as rfluid
from paddle_tpu.core.scope import Scope as RScope
from paddle_tpu.ops import registry as rreg

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import array_ops

import torch_case_parity as parity
import torch_seq_cases as sc

NAMES = sc.cases_of("sequence_ops", "array_ops", "metric_ops")
TYPES = sorted({sc.CASES[n][0] for n in NAMES})
MODULES = {"paddle_tpu.ops." + m
           for m in ("sequence_ops", "array_ops", "metric_ops")}


@pytest.fixture(scope="module")
def reference():
    return parity.reference_results(NAMES, cases=sc)


def test_cases_cover_the_three_modules():
    """Every type the reference's sequence_ops and array_ops register,
    and metric_ops but `accuracy`, has a case; the port registers
    them all."""
    ref = {t for t in rreg.registered_ops()
           if rreg.get_op(t).compute.__module__ in MODULES} - {"accuracy"}
    assert set(TYPES) == ref and len(TYPES) == 18 + 13 + 6
    assert ref <= set(parity.treg.registered_ops())


@pytest.mark.parametrize("name", NAMES)
def test_op_matches_reference(name, reference):
    parity.check_case(name, reference[name], cases=sc)


@pytest.mark.parametrize("name", NAMES)
def test_infer_outputs_matches_reference(name):
    parity.check_infer(name, cases=sc)


@pytest.mark.parametrize("op_type", TYPES)
def test_flags_match_the_reference(op_type):
    parity.check_flags(op_type)


def test_sequence_mask_negative_maxlen_is_batch_by_batch():
    """Paddle's maxlen -1 means max(X); the reference takes X.shape[0]
    for any device array, so lengths [3, 1, 5, 2] give a [4, 4] mask.
    The port follows the reference and reads nothing on the host."""
    x = np.asarray([3, 1, 5, 2], "int64")
    want = rreg.get_op("sequence_mask").compute({"X": [jnp.asarray(x)]}, {})
    got = parity.port("sequence_mask", {"X": [torch.tensor(x)]}, {})["Y"][0]
    assert want["Y"].shape == got.shape == (4, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want["Y"]))


def _write(i, n=4):
    ins = {"Array": [torch.zeros(n, 2)], "X": [torch.ones(2)],
           "I": [torch.tensor([i])]}
    return parity.port("array_write", ins, {})


def test_array_write_raises_past_the_end():
    """An index past the end that can be read (a CPU tensor) raises
    IndexError, as the reference raises for a concrete one."""
    with pytest.raises(IndexError):
        _write(4)
    with pytest.raises(IndexError):
        rreg.get_op("array_write").compute(
            {"Array": [jnp.zeros((4, 2))], "X": [jnp.ones(2)],
             "I": [np.asarray([4])]}, {})
    assert _write(3)["OutLen"][0].item() == 4


def test_array_write_clamps_where_it_cannot_read(monkeypatch):
    """Where the index cannot be read (inside a CUDA graph capture) the
    write clamps it into the buffer, as the reference does under jit:
    slot 3 written for index 6, OutLen 7."""
    monkeypatch.setattr(array_ops, "_readable", lambda t: False)
    got = _write(6)
    ref = jax.jit(lambda i: rreg.get_op("array_write").compute(
        {"Array": [jnp.zeros((4, 2))], "X": [jnp.ones(2)], "I": [i]}, {}))(
        jnp.asarray([6]))
    np.testing.assert_array_equal(got["Out"][0].numpy(),
                                  np.asarray(ref["Out"]))
    assert got["OutLen"][0].item() == int(ref["OutLen"]) == 7
    assert got["Out"][0][3].tolist() == [1.0, 1.0]


def test_auc_streams_over_three_steps():
    """The histograms carried over three batches: each step's AUC and
    both stats equal the reference's."""
    r = np.random.RandomState(8)
    stats_t = [torch.zeros(4096, dtype=torch.int32) for _ in range(2)]
    stats_r = [jnp.zeros(4096, jnp.int32) for _ in range(2)]
    for _ in range(3):
        p = r.rand(32, 1).astype("float32")
        pred = np.concatenate([1 - p, p], 1)
        lab = (r.rand(32, 1) < p).astype("int64")
        want = rreg.get_op("auc").compute(
            {"Predict": [jnp.asarray(pred)], "Label": [jnp.asarray(lab)],
             "StatPos": [stats_r[0]], "StatNeg": [stats_r[1]]}, {})
        got = parity.port("auc", {
            "Predict": [torch.tensor(pred)], "Label": [torch.tensor(lab)],
            "StatPos": [stats_t[0]], "StatNeg": [stats_t[1]]}, {})
        stats_r = [want["StatPosOut"], want["StatNegOut"]]
        stats_t = [got["StatPosOut"][0], got["StatNegOut"][0]]
        for g, w in zip(stats_t, stats_r):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_allclose(got["AUC"][0].numpy(),
                                   np.asarray(want["AUC"]), rtol=1e-5)
    assert 0.5 < float(got["AUC"][0]) < 1.0


def _port_np(op, ins, attrs):
    out = parity.port(op, {k: [torch.tensor(np.asarray(v))]
                           for k, v in ins.items()}, attrs)
    return {k: v[0].numpy() for k, v in out.items()}


def test_reference_cases_of_the_host_metrics():
    """`edit_distance`, `chunk_eval` and `ctc_align` on the reference's
    own cases (tests/test_ops_extended.py TestEditDistanceChunkEvalCtc)."""
    out = _port_np("edit_distance", {
        "Hyps": np.array([[1, 2, 3, 0]], "int64"),
        "Refs": np.array([[1, 3, 3, 4]], "int64"),
        "HypsLength": np.array([3], "int64"),
        "RefsLength": np.array([4], "int64")}, {})
    assert float(out["Out"][0, 0]) == 2.0
    out = _port_np("chunk_eval", {
        "Inference": np.array([0, 1, 4, 2, 4, 4], "int64"),
        "Label": np.array([0, 1, 4, 2, 3, 4], "int64")},
        {"num_chunk_types": 2})
    np.testing.assert_allclose(out["Precision"], [0.5])
    np.testing.assert_allclose(out["Recall"], [0.5])
    out = _port_np("chunk_eval", {
        "Inference": np.array([[0, 1, 0, 0], [1, 4, 0, 0]], "int64"),
        "Label": np.array([[0, 1, 4, 4], [0, 4, 0, 0]], "int64"),
        "SeqLength": np.array([2, 2], "int64")}, {"num_chunk_types": 2})
    np.testing.assert_allclose(out["Precision"], [1.0])
    assert int(out["NumInferChunks"][0]) == 2
    x = np.array([[0, 1, 1, 0, 2, 2, 0, 3]], "int32")
    out = _port_np("ctc_align", {"Input": x},
                   {"blank": 0, "merge_repeated": True})
    np.testing.assert_array_equal(out["Output"][0, :3], [1, 2, 3])
    assert int(out["OutputLength"][0, 0]) == 3
    out = _port_np("ctc_align", {"Input": x,
                                 "InputLength": np.array([4], "int64")},
                   {"blank": 0, "merge_repeated": True,
                    "padding_value": -1})
    assert int(out["OutputLength"][0, 0]) == 1
    np.testing.assert_array_equal(out["Output"][0, :2], [1, -1])


# -- LoDTensor (as tests/test_lod_tensor.py holds the reference's) ------------

def test_lod_tensor_levels_and_checks():
    t = tfluid.create_lod_tensor(np.arange(5).reshape(5, 1), [[2, 3]],
                                 tfluid.CPUPlace())
    assert t.lod() == [[0, 2, 5]] and t.recursive_sequence_lengths() == [
        [2, 3]]
    assert t.has_valid_recursive_sequence_lengths() and t.shape() == [5, 1]
    data = np.arange(12, dtype="float32").reshape(6, 2)
    t = tfluid.create_lod_tensor(data, [[2, 1], [3, 1, 2]],
                                 tfluid.CPUPlace())
    r = rfluid.create_lod_tensor(data, [[2, 1], [3, 1, 2]],
                                 rfluid.CPUPlace())
    assert t.lod() == r.lod() == [[0, 2, 3], [0, 3, 4, 6]]
    assert t.lod_level() == 2 and t.has_valid_recursive_sequence_lengths()
    with pytest.raises(AssertionError):
        tfluid.create_lod_tensor(np.zeros((5, 1)), [[2, 2]],
                                 tfluid.CPUPlace())
    assert not tfluid.LoDTensor(np.zeros((4, 1)), [[0, 2, 5]]) \
        .has_valid_recursive_sequence_lengths()
    assert not tfluid.LoDTensor(np.zeros((5, 1)), [[0, 3, 2]]) \
        .has_valid_recursive_sequence_lengths()
    t = tfluid.create_lod_tensor([[1, 2], [3, 4, 5]], [[2, 3]],
                                 tfluid.CPUPlace())
    np.testing.assert_array_equal(np.asarray(t).ravel(), [1, 2, 3, 4, 5])
    t = tfluid.create_random_int_lodtensor([[2, 3]], [1], tfluid.CPUPlace(),
                                           0, 9, seed=0)
    r = rfluid.create_random_int_lodtensor([[2, 3]], [1], rfluid.CPUPlace(),
                                           0, 9, seed=0)
    np.testing.assert_array_equal(np.asarray(t), np.asarray(r))


def test_lod_tensor_padded_bridge_feeds_the_sequence_ops():
    """to_padded / from_padded round trip; the padded layout and its
    lengths feed `sequence_pool(length=...)` through the Executor (the
    LoDTensor itself feeds through `__array__`)."""
    data = np.arange(12, dtype="float32").reshape(6, 2)
    t = tfluid.create_lod_tensor(data, [[2, 1], [3, 1, 2]],
                                 tfluid.CPUPlace())
    padded, lens = t.to_padded(pad_value=-1.0)
    assert padded.shape == (3, 3, 2) and padded[1, 1, 0] == -1.0
    np.testing.assert_array_equal(lens, [3, 1, 2])
    back = tfluid.LoDTensor.from_padded(padded, lens, outer_lens=[2, 1])
    np.testing.assert_array_equal(back.numpy(), data)
    assert back.lod() == t.lod()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name_guard():
        x = tfluid.layers.data("x", shape=[3, 2], dtype="float32")
        length = tfluid.layers.data("len", shape=[1], dtype="int64")
        flat = tfluid.layers.data("flat", shape=[2], dtype="float32")
        pooled = tfluid.layers.sequence_pool(x, "sum", length=length)
        total = tfluid.layers.reduce_sum(flat)
    out = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"x": padded, "len": lens.reshape(-1, 1), "flat": t},
        fetch_list=[pooled, total], scope=tfluid.Scope())
    np.testing.assert_allclose(out[0], np.stack(
        [data[0:3].sum(0), data[3:4].sum(0), data[4:6].sum(0)]), rtol=1e-6)
    assert float(out[1]) == data.sum()


# -- the layers ---------------------------------------------------------------

def _seq_layers(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        x = L.data("x", shape=[6, 4], dtype="float32")
        s = L.data("s", shape=[6], dtype="float32")
        y = L.data("y", shape=[2, 3], dtype="float32")
        length = L.data("length", shape=[], dtype="int64")
        outs = [L.sequence_pool(x, t, length=length)
                for t in ("sum", "average", "sqrt", "max", "last", "first")]
        outs += [L.sequence_pool(x, "max"),
                 L.sequence_softmax(s, length=length),
                 L.sequence_softmax(s), L.sequence_reverse(x, length=length),
                 L.sequence_reverse(x),
                 L.sequence_expand(L.reduce_sum(x, dim=1), y),
                 L.sequence_reshape(x, 8),
                 fluid.nets.sequence_conv_pool(x, 5, 3, act="tanh",
                                               pool_type="sqrt"),
                 fluid.nets.sequence_conv_pool(x, 3, 4),
                 fluid.nets.glu(x, dim=-1),
                 fluid.nets.scaled_dot_product_attention(x, x, x,
                                                         num_heads=2)]
    return main, startup, outs


def test_sequence_layers_match_reference():
    """The sequence layers and `fluid.nets`' sequence builders over
    ragged rows in both packages: the same programs op by op and, from
    the reference's startup state, the same fetches."""
    r = np.random.RandomState(6)
    feed = {"x": r.randn(3, 6, 4).astype("float32"),
            "s": r.randn(3, 6).astype("float32"),
            "y": r.randn(3, 2, 3).astype("float32"),
            "length": np.asarray([6, 2, 4], "int64")}
    parity.run_both(rfluid, tfluid, _seq_layers(rfluid), _seq_layers(tfluid),
                    feed)


def _img_nets(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 9
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        img = fluid.layers.data("img", shape=[3, 8, 8], dtype="float32")
        outs = [fluid.nets.simple_img_conv_pool(img, 4, 3, 2, 2, act="relu"),
                fluid.nets.img_conv_group(img, [4, 4], 2, conv_act="relu",
                                          conv_with_batchnorm=[False, True],
                                          pool_stride=2)]
    return main, startup, outs


def test_image_nets_match_reference():
    feed = {"img": np.random.RandomState(2).randn(2, 3, 8, 8).astype(
        "float32")}
    parity.run_both(rfluid, tfluid, _img_nets(rfluid), _img_nets(tfluid),
                    feed, atol=1e-5)


def test_sequence_pool_checks_its_type_when_built():
    for fluid in (rfluid, tfluid):
        with fluid.program_guard(fluid.Program(), fluid.Program()):
            x = fluid.layers.data("x", shape=[4, 3], dtype="float32")
            with pytest.raises(ValueError):
                fluid.layers.sequence_pool(x, "median")


def _mask_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        lens = fluid.layers.data("lens", shape=[], dtype="int64")
        mask = fluid.layers.sequence_mask(lens, maxlen=5, dtype="float32")
    return main, mask


def test_reference_sequence_mask_layer_names_the_wrong_slot():
    """The reference's `sequence_mask` layer binds its result to an
    "Out" slot that the op (which writes "Y", as Paddle's does) never
    fills, so its program cannot fetch it; the port's layer binds "Y"."""
    rmain, rmask = _mask_program(rfluid)
    tmain, tmask = _mask_program(tfluid)
    assert list(rmain.global_block().ops[-1].output_names) == ["Out"]
    assert list(tmain.global_block().ops[-1].output_names) == ["Y"]
    feed = {"lens": np.asarray([2, 5, 0], "int64")}
    with pytest.raises(Exception):
        rfluid.Executor(rfluid.CPUPlace()).run(
            rmain, feed=feed, fetch_list=[rmask], scope=RScope())
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=feed, fetch_list=[tmask], scope=tfluid.Scope())[0]
    np.testing.assert_array_equal(got, np.arange(5)[None, :]
                                  < feed["lens"][:, None])
    assert got.dtype == np.float32


def test_ragged_net_trains_as_the_reference():
    """The ragged classifier of tests/torch_seq_cases.py (every
    `sequence_pool` type, `sequence_softmax` and `sequence_reverse` over
    a Length feed padded by `create_lod_tensor(...).to_padded()`) in
    both packages from the reference's startup state: 3 Adagrad steps'
    losses within 1e-5."""
    from paddle_tpu_torch.core.scope import load_numpy_state

    ref, port = sc.ragged_net(rfluid, 12, vocab=50, emb=8), \
        sc.ragged_net(tfluid, 12, vocab=50, emb=8)
    parity.assert_same_program(ref[0], port[0])
    rexe, rscope = rfluid.Executor(rfluid.CPUPlace()), RScope()
    rexe.run(ref[1], scope=rscope)
    names = sorted(v.name for v in ref[0].list_vars() if v.persistable)
    tscope = tfluid.Scope()
    load_numpy_state(tscope, {n: np.asarray(rscope.find_var(n))
                              for n in names}, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(0)
    for _ in range(3):
        feed = port[3](6, rng)
        want = rexe.run(ref[0], feed=feed, fetch_list=[ref[2]],
                        scope=rscope)[0]
        got = texe.run(port[0], feed=feed, fetch_list=[port[2]],
                       scope=tscope)[0]
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)
    assert feed["length"].min() < 12
