"""The detection and quantization slice on the card: every op case of
`tests/torch_det_quant_cases.py` (`interp_ops`, `quant_ops`,
`detection_ops`, `yolov3_loss`) against its run on the CPU, forward and
gradients, and captured in a CUDA graph against its eager run (through
`tests/torch_case_runner.py`); the NMS cases' outputs the reference's
recorded ones; the gathering types' gradients repeating bit for bit under
`FLAGS_cudnn_deterministic`; a QAT step's scale state surviving replay.
Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports neither JAX nor the JAX package, so on a GPU
machine without JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_detection_cuda.py

Tolerances: 1e-4 x (1 + max |value|) card against CPU (cuDNN and cuBLAS
sum in other orders than the CPU's kernels); captured against eager, the
repeats and the NMS outputs bit for bit."""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.core.scope import dump_numpy_state, load_numpy_state
from paddle_tpu_torch.core.types import to_numpy
from paddle_tpu_torch.ops import registry

import torch_case_runner as cr
import torch_det_quant_cases as dq
import torch_detection_programs as dp

pytestmark = pytest.mark.cuda

TOL = 1e-4
#: the types whose gradients gather (summed in a fixed order)
GATHERING = ("yolov3_loss", "roi_align", "linear_interp", "bilinear_interp",
             "trilinear_interp", "bicubic_interp", "nearest_interp")


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
    op, _, attrs, diff, _ = dq.CASES[name]
    return cr.run_case(op, dq.inputs(name), attrs, device, diff, seed=7)


@pytest.mark.parametrize("name", sorted(dq.CASES))
def test_op_card_against_cpu(dev, name):
    bad = cr.compare(_run(name, dev), _run(name, "cpu"), TOL)[2]
    assert not bad, (name, bad)


@pytest.mark.parametrize("name", sorted(
    n for n in dq.CASES if cr.capturable(dq.CASES[n][0])))
def test_op_captured_equals_eager(dev, name):
    """One replay of a CUDA graph captured around the op and its
    gradients gives the eager run's values bit for bit."""
    op, _, attrs, diff, _ = dq.CASES[name]
    graph = cr.capture_case(op, dq.inputs(name), attrs, dev, diff, seed=7)
    bad = cr.compare(graph, _run(name, dev), 0.0)[2]
    assert not bad, (name, bad)


@pytest.mark.parametrize("name", sorted(dq.NMS_DIGESTS))
def test_nms_card_gives_the_recorded_outputs(dev, name):
    """The NMS cases from tensors on the card: outputs equal to the
    reference's recorded ones."""
    op, _, attrs, _, _ = dq.CASES[name]
    outs = registry.normalize_outs(registry.get_op(op).compute(
        {s: [torch.tensor(a).to(dev) for a in v]
         for s, v in dq.inputs(name).items()}, dict(attrs, _device=dev)))
    assert {s: dq.digest(to_numpy(v[0])) for s, v in outs.items()} \
        == dq.NMS_DIGESTS[name]


@pytest.mark.parametrize("name", sorted(
    n for n in dq.CASES if dq.CASES[n][0] in GATHERING))
def test_gathering_gradients_repeat_bit_for_bit(dev, name):
    """Twice on the card, no nondeterminism warning: bit-equal outputs
    and gradients."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        a, b = _run(name, dev), _run(name, dev)
    assert not cr.compare(a, b, 0.0)[2]
    assert not [w for w in seen if "determinis" in str(w.message)]


def test_large_nearest_and_yolo_gradients_repeat(dev):
    """At YOLOv3's deepest upsampling (19 x 19 to 38 x 38, 256 channels,
    batch 8) and a loss head with 50 boxes on a 76 x 76 grid, where many
    cells repeat: the gradients twice, bit-equal."""
    r = np.random.RandomState(0)
    x = torch.tensor(r.randn(8, 256, 19, 19).astype("float32"), device=dev,
                     requires_grad=True)
    ct = torch.tensor(r.randn(8, 256, 38, 38).astype("float32"), device=dev)
    grads = [torch.autograd.grad(registry.get_op("nearest_interp").compute(
        {"X": [x]}, {"scale": 2.0, "_device": dev})["Out"], [x], ct)[0]
        for _ in range(2)]
    assert torch.equal(*grads)
    feed = dp.yolo_feed(8, 608, 80, 50, r)
    head = torch.tensor(r.randn(8, 255, 76, 76).astype("float32") * 0.5,
                        device=dev, requires_grad=True)
    attrs = {"anchors": dp.YOLO_ANCHORS, "anchor_mask": [0, 1, 2],
             "class_num": 80, "ignore_thresh": 0.7, "downsample_ratio": 8,
             "_device": dev}
    ins = {"GTBox": [torch.tensor(feed["gt_box"], device=dev)],
           "GTLabel": [torch.tensor(feed["gt_label"], device=dev)],
           "GTScore": [torch.tensor(feed["gt_score"], device=dev)]}
    grads = [torch.autograd.grad(registry.get_op("yolov3_loss").compute(
        dict(ins, X=[head]), attrs)["Loss"].sum(), [head])[0]
        for _ in range(2)]
    assert torch.equal(*grads)


def _qat_run(graphs, state, feeds):
    qat = dp.resnet_qat(fluid, **dp.SMALL_QAT)
    states = dp.quant_state_names(qat.main)
    fluid.set_flags({"FLAGS_cuda_graphs": graphs})
    exe, scope = fluid.Executor(), fluid.Scope()
    names = sorted(v.name for v in qat.main.list_vars() if v.persistable)
    if state is None:
        exe.run(qat.startup, scope=scope)
        state = dump_numpy_state(scope, names)
    else:
        load_numpy_state(scope, state)
    fetches = [exe.run(qat.main, feed=f, fetch_list=[qat.loss] + states,
                       scope=scope) for f in feeds]
    info = exe.last_entry.info()
    final = dump_numpy_state(scope, names)
    exe.close()
    return fetches, final, state, info


def test_qat_scale_state_survives_replay(dev):
    """The small QAT ResNet, 5 steps captured (the first eager, the
    second captured, then replays) and 5 eager from one state: the
    scales move at every step, and every fetch and persistable (the
    scale states among them) is bit-equal between the two."""
    qat = dp.resnet_qat(fluid, **dp.SMALL_QAT)
    rng = np.random.RandomState(0)
    feeds = [qat.feed(dp.SMALL_QAT_BATCH, rng) for _ in range(5)]
    graph, g_final, state, info = _qat_run(True, None, feeds)
    eager, e_final, _, e_info = _qat_run(False, state, feeds)
    assert info["phase"] == "captured" and e_info["mode"] == "eager"
    for g, e in zip(graph, eager):
        for a, b in zip(g, e):
            np.testing.assert_array_equal(a, b)
    scales = np.asarray([[float(v.reshape(-1)[0]) for v in f[1:]]
                         for f in graph])
    assert (np.diff(scales, axis=0) != 0).any(axis=1).all()
    for n in g_final:
        np.testing.assert_array_equal(g_final[n], e_final[n], err_msg=n)
