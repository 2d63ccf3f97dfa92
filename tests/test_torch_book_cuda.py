"""The book slice on the card: every op case of `tests/torch_nn_cases.py`
(the rest of `nn_ops`, `linalg_ops`, `loss_ops`, `rnn_unit_ops`) against
its run on the CPU, forward and gradients, and captured in a CUDA graph
against its eager run (through `tests/torch_case_runner.py`), as are
the cases of `tests/torch_tensor_cases.py`; a fluid
block of the factorizations and `interp_nearest`, and the stacked LSTM
of understand_sentiment, captured against eager; conv3d,
conv3d_transpose, conv2d_transpose and pool3d repeating bit for bit
under `FLAGS_cudnn_deterministic`. Every test here needs an NVIDIA GPU
(marker ``cuda``) and skips without one. The file imports neither JAX
nor the JAX package, so on a GPU machine without JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_book_cuda.py

Tolerances: 1e-4 x (1 + max |value|) card against CPU (cuBLAS, cuDNN and
cuSOLVER sum in other orders than the CPU's kernels); captured against
eager and the deterministic repeats bit for bit."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.core.scope import dump_numpy_state, load_numpy_state

import torch_book_programs as bp
import torch_case_runner as cr
import torch_tensor_cases as tc
from torch_nn_cases import CASES, inputs

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = fluid.get_flags(["FLAGS_cudnn_deterministic",
                              "FLAGS_cuda_graphs"])
    fluid.set_flags({"FLAGS_cudnn_deterministic": True})
    yield resolve_device(None)
    fluid.set_flags(before)


def _run(name, device):
    op, _, attrs, diff, _ = CASES[name]
    return cr.run_case(op, inputs(name), attrs, device, diff)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_card_against_cpu(dev, name):
    bad = cr.compare(_run(name, dev), _run(name, "cpu"), TOL)[2]
    assert not bad, (name, bad)


@pytest.mark.parametrize("name", sorted(
    n for n in CASES if cr.capturable(CASES[n][0])))
def test_op_captured_equals_eager(dev, name):
    """One replay of a CUDA graph captured around the op and its
    gradients gives the eager run's values bit for bit (capture fails
    where an op reads a value on the host or waits for it)."""
    op, _, attrs, diff, _ = CASES[name]
    graph = cr.capture_case(op, inputs(name), attrs, dev, diff)
    bad = cr.compare(graph, _run(name, dev), 0.0)[2]
    assert not bad, (name, bad)


@pytest.mark.parametrize("name", sorted(
    n for n in tc.CASES if cr.capturable(tc.CASES[n][0])))
def test_tensor_case_captured_equals_eager(dev, name):
    """The same for the cases of `tests/torch_tensor_cases.py` (the
    tensor ops, `pad2d`'s and `pad3d`'s gradients among them)."""
    op, _, attrs, diff, _ = tc.CASES[name]
    args = (op, tc.inputs(name), attrs, dev, diff)
    bad = cr.compare(cr.capture_case(*args, seed=7),
                     cr.run_case(*args, seed=7), 0.0)[2]
    assert not bad, (name, bad)


@pytest.mark.parametrize("name", ["conv3d", "conv3d_transpose",
                                  "conv2d_transpose",
                                  "conv2d_transpose_groups", "pool3d",
                                  "pool3d_avg"])
def test_cudnn_types_repeat_bit_for_bit(dev, name):
    a, b = _run(name, dev), _run(name, dev)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _sentiment(graphs, state, feeds):
    book = bp.understand_sentiment(fluid, 16, vocab=500, emb=32, hid=128,
                                   ragged=True)
    fluid.set_flags({"FLAGS_cuda_graphs": graphs})
    exe, scope = fluid.Executor(), fluid.Scope()
    names = sorted(v.name for v in book.main.list_vars() if v.persistable)
    if state is None:
        exe.run(book.startup, scope=scope)
        state = dump_numpy_state(scope, names)
    else:
        load_numpy_state(scope, state)
    losses = [exe.run(book.main, feed=f, fetch_list=[book.loss],
                      scope=scope)[0] for f in feeds]
    info = exe.last_entry.info()
    final = dump_numpy_state(scope, names)
    exe.close()
    return losses, final, state, info


def test_lstm_captured_equals_eager(dev):
    """The ragged stacked LSTM, 5 steps captured (the first eager, the
    second captured, then replays) and 5 eager from one state: losses
    and every persistable bit-equal."""
    book = bp.understand_sentiment(fluid, 16, vocab=500, emb=32, hid=128,
                                   ragged=True)
    rng = np.random.RandomState(0)
    feeds = [book.feed(16, rng) for _ in range(5)]
    graph, g_final, state, info = _sentiment(True, None, feeds)
    eager, e_final, _, e_info = _sentiment(False, state, feeds)
    assert info["phase"] == "captured" and e_info["mode"] == "eager"
    np.testing.assert_array_equal(np.concatenate(graph),
                                  np.concatenate(eager))
    for n in g_final:
        np.testing.assert_array_equal(g_final[n], e_final[n], err_msg=n)


def _linalg_block(graphs, feed):
    """Three runs of a block of cholesky, inverse, matrix_power with n <
    0 and interp_nearest: (the last run's fetches, its entry's info)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        a = fluid.data("a", [3, 3], "float32")
        img = fluid.data("img", [1, 2, 5, 7], "float32")
    block = main.global_block()
    fetch = []
    for op, ins, slot, attrs, shape in (
            ("cholesky", {"X": [a]}, "Out", {}, [3, 3]),
            ("inverse", {"Input": [a]}, "Output", {}, [3, 3]),
            ("matrix_power", {"X": [a]}, "Out", {"n": -2}, [3, 3]),
            ("interp_nearest", {"X": [img]}, "Out",
             {"out_h": 3, "out_w": 11}, [1, 2, 3, 11])):
        out = block.create_var(name=op + "_out", shape=shape,
                               dtype="float32")
        block.append_op(type=op, inputs=ins, outputs={slot: [out]},
                        attrs=attrs)
        fetch.append(out.name)
    fluid.set_flags({"FLAGS_cuda_graphs": graphs})
    exe, scope = fluid.Executor(), fluid.Scope()
    for _ in range(3):
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    info = exe.last_entry.info()
    exe.close()
    return got, info


def test_linalg_block_captured_equals_eager(dev):
    """The factorizations read no error flag on the host and
    interp_nearest makes its indices on the card, so their block is
    captured; its fetches equal eager runs' bit for bit."""
    r = np.random.RandomState(3)
    m = r.randn(3, 3).astype("float32")
    feed = {"a": m @ m.T + 3 * np.eye(3, dtype="float32"),
            "img": r.randn(1, 2, 5, 7).astype("float32")}
    graph, info = _linalg_block(True, feed)
    eager, e_info = _linalg_block(False, feed)
    assert info["phase"] == "captured" and e_info["mode"] == "eager"
    for g, e in zip(graph, eager):
        np.testing.assert_array_equal(g, e)


def test_cumprod_through_zeros_captured(dev):
    """cumprod's gradient with zeros in X reads nothing on the host: it
    is captured, bit-equal to eager, and within TOL of the CPU's."""
    r = np.random.RandomState(5)
    x = r.uniform(0.5, 1.5, (4, 33)).astype("float32")
    x[r.rand(4, 33) < 0.25] = 0.0
    args = ("cumprod", {"X": [x]}, {"dim": 1})
    eager = cr.run_case(*args, dev, ["X"])
    assert not cr.compare(cr.capture_case(*args, dev, ["X"]), eager,
                          0.0)[2]
    assert not cr.compare(eager, cr.run_case(*args, "cpu", ["X"]), TOL)[2]
