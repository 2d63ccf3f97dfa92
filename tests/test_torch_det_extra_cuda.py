"""The detection pipeline slice on the card: every op case of
`tests/torch_det_extra_cases.py` (`detection_extra_ops`,
`vision_extra_ops`, `sample_logits`; the random cases at one seed)
against its run on the CPU, forward and gradients, and captured in a
CUDA graph against its eager run (through `tests/torch_case_runner.py`);
the deformable ops' and the other gathering types' gradients repeating
bit for bit under `FLAGS_cudnn_deterministic`; the host types' outputs
the reference's recorded ones (`HOST_DIGESTS`), in a one-op program
whose block runs eagerly, named; and a deformable-convolution program's
`LazyFetch` handles from replays of its captured step, materialized to
what `return_numpy=True` gives. Every test here needs an NVIDIA GPU
(marker ``cuda``) and skips without one. The file imports neither JAX
nor the JAX package, so on a GPU machine without JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_det_extra_cuda.py

Tolerances: 1e-4 x (1 + max |value|) card against CPU (cuDNN and cuBLAS
sum in other orders than the CPU's kernels); captured against eager, the
repeats and the host outputs bit for bit."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.core.scope import dump_numpy_state, load_numpy_state
from paddle_tpu_torch.core.types import from_numpy, to_numpy
from paddle_tpu_torch.ops import registry

import torch_case_runner as cr
import torch_det_extra_cases as dx

pytestmark = pytest.mark.cuda

TOL = 1e-4
TABLE = dict(dx.CASES, **{n: c + ([],) for n, c in dx.RANDOM_CASES.items()})
#: the deformable types, whose bilinear taps gather
DEFORMABLE = ("deformable_conv", "deformable_conv_v1",
              "deformable_psroi_pooling", "roi_perspective_transform")
#: the other types whose gradients gather (summed in a fixed order)
GATHERING = ("bilateral_slice", "conv_shift", "hsigmoid", "target_assign",
             "box_decoder_and_assign", "prroi_pool", "psroi_pool",
             "unpool", "max_pool3d_with_index", "sample_logits",
             "sampled_softmax_with_cross_entropy", "random_crop")


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
    op, _, attrs, diff, _ = TABLE[name]
    return cr.run_case(op, dx.inputs(name), attrs, device, diff, seed=7)


@pytest.mark.parametrize("name", sorted(TABLE))
def test_op_card_against_cpu(dev, name):
    bad = cr.compare(_run(name, dev), _run(name, "cpu"), TOL)[2]
    assert not bad, (name, bad)


@pytest.mark.parametrize("name", sorted(
    n for n in TABLE if cr.capturable(TABLE[n][0])))
def test_op_captured_equals_eager(dev, name):
    op, _, attrs, diff, _ = TABLE[name]
    ins = dx.inputs(name)
    graph = cr.capture_case(op, ins, attrs, dev, diff, seed=7)
    bad = cr.compare(graph, cr.run_case(op, ins, attrs, dev, diff, seed=7),
                     0.0)[2]
    assert not bad, (name, bad)


@pytest.mark.parametrize("name", sorted(
    n for n in TABLE if TABLE[n][0] in DEFORMABLE + GATHERING))
def test_gathering_gradients_repeat(dev, name):
    """Two runs bit-equal: every gather's gradient is summed in a fixed
    order (no atomics)."""
    bad = cr.compare(_run(name, dev), _run(name, dev), 0.0)[2]
    assert not bad, (name, bad)


@pytest.mark.parametrize("name", dx.host_cases())
def test_host_case_is_the_recorded_reference(dev, name):
    """A host type on the card gives the reference's recorded outputs,
    and as a one-op program its block runs eagerly, the op named."""
    op, _, attrs, _, _ = dx.CASES[name]
    ins = dx.inputs(name)
    outs = registry.normalize_outs(registry.get_op(op).compute(
        {s: [from_numpy(a, dev) for a in v] for s, v in ins.items()},
        dict(attrs, _device=dev)))
    assert all(t.device == dev for v in outs.values() for t in v)
    assert {s: [dx.digest(dx.canon(to_numpy(t))) for t in v]
            for s, v in outs.items()} == dx.HOST_DIGESTS[name]
    main = fluid.Program()
    block = main.global_block()
    feed, inputs = {}, {}
    for slot, arrs in ins.items():
        inputs[slot] = []
        for i, a in enumerate(arrs):
            n = "%s_%d" % (slot, i)
            inputs[slot].append(block.create_var(
                name=n, shape=list(a.shape), dtype=str(a.dtype)))
            feed[n] = a
    outputs = {s: [block.create_var(name="out_%s_%d" % (s, i))
                   for i in range(len(v))] for s, v in outs.items()}
    block.append_op(type=op, inputs=inputs, outputs=outputs,
                    attrs=dict(attrs))
    exe = fluid.Executor()
    got = exe.run(main, feed=feed, fetch_list=[
        v for s in sorted(outputs) for v in outputs[s]],
        scope=fluid.Scope())
    entry = exe.last_entry
    exe.close()
    assert entry.mode == "eager" and repr(op) in entry.reason
    want = [to_numpy(t) for s in sorted(outs) for t in outs[s]]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _deformable_program():
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = L.data(name="x", shape=[4, 8, 8], dtype="float32")
        offset = L.data(name="offset", shape=[18, 8, 8], dtype="float32")
        mask = L.data(name="mask", shape=[9, 8, 8], dtype="float32")
        y = L.deformable_conv(x, offset, mask, num_filters=6,
                              filter_size=3, padding=1)
        loss = L.mean(L.square(y))
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    return main, startup, loss


def test_lazy_fetches_after_a_replay(dev):
    """A deformable-convolution step, captured and replayed, fetched with
    `return_numpy=False`: each `LazyFetch` holds a CUDA tensor, and
    `.numpy()`, `np.asarray` and `float` give what the same steps give
    eagerly with `return_numpy=True`, bit for bit."""
    main, startup, loss = _deformable_program()
    r = np.random.RandomState(0)
    feed = {"x": r.randn(2, 4, 8, 8).astype("float32"),
            "offset": r.randn(2, 18, 8, 8).astype("float32"),
            "mask": r.rand(2, 9, 8, 8).astype("float32")}
    fetch = [loss, "deformable_conv_0.w_0"]
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    state = dump_numpy_state(scope, names)
    fluid.set_flags({"FLAGS_cuda_graphs": True})
    lazy = [exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                    return_numpy=False) for _ in range(4)]
    assert exe.last_entry.info()["phase"] == "captured"
    load_numpy_state(scope, state)
    fluid.set_flags({"FLAGS_cuda_graphs": False})
    plain = [exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
             for _ in range(4)]
    exe.close()
    for step, want in zip(lazy, plain):
        for f, w in zip(step, want):
            assert isinstance(f, fluid.LazyFetch) and f.value.is_cuda
            assert f.block_until_ready() is f and f.shape == w.shape
            np.testing.assert_array_equal(f.numpy(), w)
            np.testing.assert_array_equal(np.asarray(f), w)
        assert float(step[0]) == float(want[0].reshape(-1)[0])
    assert float(lazy[0][0]) != float(lazy[3][0])
