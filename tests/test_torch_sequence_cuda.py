"""The sequence slice on the card: every op case of
`tests/torch_seq_cases.py` (`sequence_ops`, `array_ops`, `metric_ops`,
`framework_ops`) against its run on the CPU, forward and gradients, and
captured in a CUDA graph against its eager run (through
`tests/torch_case_runner.py`); `run_program` card against CPU;
`sequence_scatter` and `SelectedRows.merge` repeating bit for bit; the
book's convolution_net with its streaming AUC captured against eager.
Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports neither JAX nor the JAX package, so on a GPU
machine without JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_sequence_cuda.py

Tolerances: 1e-4 x (1 + max |value|) card against CPU (cuBLAS sums in
other orders than the CPU's kernels); captured against eager and the
repeats bit for bit."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
import paddle_tpu_torch.ops.framework_ops as tfo
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.core.scope import dump_numpy_state, load_numpy_state
from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.ops import registry

import torch_book_programs as bp
import torch_case_runner as cr
import torch_seq_cases as sc

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sc.prepare(tfo)
    before = fluid.get_flags(["FLAGS_cudnn_deterministic",
                              "FLAGS_cuda_graphs"])
    fluid.set_flags({"FLAGS_cudnn_deterministic": True})
    yield resolve_device(None)
    fluid.set_flags(before)


def _run(name, device):
    op, _, attrs, diff, _ = sc.CASES[name]
    return cr.run_case(op, sc.inputs(name), attrs, device, diff, seed=7)


@pytest.mark.parametrize("name", sorted(sc.CASES))
def test_op_card_against_cpu(dev, name):
    bad = cr.compare(_run(name, dev), _run(name, "cpu"), TOL)[2]
    assert not bad, (name, bad)


@pytest.mark.parametrize("name", sorted(
    n for n in sc.CASES if cr.capturable(sc.CASES[n][0])))
def test_op_captured_equals_eager(dev, name):
    """One replay of a CUDA graph captured around the op and its
    gradients gives the eager run's values bit for bit (capture fails
    where an op reads a value on the host or waits for it)."""
    op, _, attrs, diff, _ = sc.CASES[name]
    graph = cr.capture_case(op, sc.inputs(name), attrs, dev, diff, seed=7)
    bad = cr.compare(graph, _run(name, dev), 0.0)[2]
    assert not bad, (name, bad)


def test_run_program_card_against_cpu(dev):
    outs, params = [], None
    for place in (fluid.CUDAPlace(dev.index or 0), fluid.CPUPlace()):
        scope, ins, attrs = sc.run_program_case(fluid, place)
        if params:
            for n, v in params.items():
                scope.set_var(n, v.cpu().clone())
        params = {n: scope.find_var(n) for n in ("fc_0.w_0", "fc_0.b_0")}
        d = params["fc_0.w_0"].device
        with fluid.scope_guard(scope):
            outs.append(registry.get_op("run_program").compute(
                {"X": [torch.tensor(ins["X"][0]).to(d)]},
                dict(attrs, _device=d))["Out"])
    assert not cr.compare(outs[0], outs[1], TOL)[2]


def test_ordered_sums_repeat_bit_for_bit(dev):
    """`sequence_scatter` and `SelectedRows.merge` over 65,536 updates
    into 512 rows, twice: bit-equal (their sums run in a fixed order)."""
    r = np.random.RandomState(9)
    ids = torch.tensor(r.randint(0, 512, 65536), device=dev)
    upd = torch.tensor(r.randn(65536, 64).astype("float32"), device=dev)
    x = torch.zeros(512, 64, device=dev)
    a, b = (registry.get_op("sequence_scatter").compute(
        {"X": [x], "Ids": [ids], "Updates": [upd]}, {"_device": dev})["Out"]
        for _ in range(2))
    assert torch.equal(a, b)
    m1, m2 = (SelectedRows(ids, upd, 512).merge() for _ in range(2))
    assert torch.equal(m1.rows, m2.rows) and torch.equal(m1.values,
                                                         m2.values)
    np.testing.assert_allclose(m1.to_dense().cpu().numpy(),
                               a.cpu().numpy(), rtol=1e-4, atol=1e-4)


def _conv_net(graphs, state, feeds):
    book = bp.convolution_net(fluid, 32, vocab=500, emb=32, filters=64)
    fluid.set_flags({"FLAGS_cuda_graphs": graphs})
    exe, scope = fluid.Executor(), fluid.Scope()
    names = sorted(v.name for v in book.main.list_vars() if v.persistable)
    if state is None:
        exe.run(book.startup, scope=scope)
        state = dump_numpy_state(scope, names)
    else:
        load_numpy_state(scope, state)
    fetches = [exe.run(book.main, feed=f, fetch_list=[book.loss] + book.fetch,
                       scope=scope) for f in feeds]
    info = exe.last_entry.info()
    final = dump_numpy_state(scope, names)
    exe.close()
    return fetches, final, state, info


def test_convolution_net_captured_equals_eager(dev):
    """convolution_net with its streaming AUC, 5 steps captured (the
    first eager, the second captured, then replays) and 5 eager from one
    state: losses, accuracies, AUCs and every persistable (the AUC's
    histograms among them) bit-equal."""
    book = bp.convolution_net(fluid, 32, vocab=500, emb=32, filters=64)
    rng = np.random.RandomState(0)
    feeds = [book.feed(16, rng) for _ in range(5)]
    graph, g_final, state, info = _conv_net(True, None, feeds)
    eager, e_final, _, e_info = _conv_net(False, state, feeds)
    assert info["phase"] == "captured" and e_info["mode"] == "eager"
    flat = [np.concatenate([np.ravel(v) for f in run for v in f])
            for run in (graph, eager)]
    np.testing.assert_array_equal(*flat)
    for n in g_final:
        np.testing.assert_array_equal(g_final[n], e_final[n], err_msg=n)
    assert g_final["auc_stat_pos"].sum() + g_final["auc_stat_neg"].sum() \
        == 5 * 16
