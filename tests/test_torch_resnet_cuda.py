"""The ResNet ops and a small ResNet50 step on the card against the port's
own CPU result. Every test here needs an NVIDIA GPU (marker ``cuda``)
and skips without one. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_resnet_cuda.py

Tolerances: float32 1e-4 relative (cuDNN's and oneDNN's convolutions
sum in other orders; TF32 is off), bf16 2e-2; integer outputs exact."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import fluid
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.core.scope import dump_numpy_state, load_numpy_state
from paddle_tpu_torch.fluid.contrib import mixed_precision
from paddle_tpu_torch.models import resnet
from paddle_tpu_torch.ops import registry

pytestmark = pytest.mark.cuda

F32_TOL, BF16_TOL = 1e-4, 2e-2


@pytest.fixture
def dev():
    """cuda:0 as the port resolves it (TF32 off, cuDNN autotuning on)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device("cuda:0")


def _f(*shape):
    return lambda g: torch.randn(*shape, generator=g)


def _pos(*shape):
    return lambda g: torch.rand(*shape, generator=g) + 0.5


def _bn(x, **attrs):
    c = x[1] if attrs.get("data_layout", "NCHW") == "NCHW" else x[-1]
    return ("batch_norm", {"X": _f(*x), "Scale": _f(c), "Bias": _f(c),
                           "Mean": _f(c), "Variance": _pos(c)},
            dict({"momentum": 0.9, "epsilon": 1e-5}, **attrs),
            ["X", "Scale", "Bias"])


#: name -> (op type, {slot: maker}, attrs, slots to differentiate), at
#: ResNet50's shapes where they are cheap
CASES = {
    "conv_stem": ("conv2d", {"Input": _f(8, 3, 224, 224),
                             "Filter": _f(64, 3, 7, 7)},
                  {"strides": [2, 2], "paddings": [3, 3]},
                  ["Input", "Filter"]),
    "conv_3x3_s2": ("conv2d", {"Input": _f(8, 128, 56, 56),
                               "Filter": _f(128, 128, 3, 3)},
                    {"strides": [2, 2], "paddings": [1, 1]},
                    ["Input", "Filter"]),
    "conv_pad4_groups": ("conv2d", {"Input": _f(2, 4, 9, 8),
                                    "Filter": _f(6, 2, 3, 3)},
                         {"paddings": [1, 0, 2, 1], "groups": 2,
                          "dilations": [2, 1]}, ["Input", "Filter"]),
    "pool_max_stem": ("pool2d", {"X": _f(8, 64, 112, 112)},
                      {"pooling_type": "max", "ksize": [3, 3],
                       "strides": [2, 2], "paddings": [1, 1]}, ["X"]),
    "pool_avg_ceil_exclusive": ("pool2d", {"X": _f(2, 3, 7, 7)},
                                {"pooling_type": "avg", "ksize": [3, 3],
                                 "strides": [2, 2], "paddings": [1, 1],
                                 "ceil_mode": True, "exclusive": True},
                                ["X"]),
    "pool_avg_global": ("pool2d", {"X": _f(8, 2048, 7, 7)},
                        {"pooling_type": "avg", "global_pooling": True},
                        ["X"]),
    "bn_train": _bn((8, 256, 28, 28)),
    "bn_train_relu_nhwc": _bn((4, 5, 5, 16), data_layout="NHWC",
                              fused_act="relu"),
    "bn_is_test": _bn((8, 64, 14, 14), is_test=True),
    "sign": ("sign", {"X": _f(4, 5)}, {}, []),
    "gather": ("gather", {"X": _f(5, 64),
                          "Index": lambda g: torch.tensor([3],
                                                          dtype=torch.int32)},
               {}, ["X"]),
    "scatter": ("scatter", {"X": _f(5, 64),
                            "Ids": lambda g: torch.tensor([3],
                                                          dtype=torch.int32),
                            "Updates": _f(1, 64)}, {}, ["X", "Updates"]),
    "momentum_nesterov": ("momentum", {"Param": _f(64, 3), "Grad": _f(64, 3),
                                       "Velocity": _f(64, 3),
                                       "LearningRate": _pos(1)},
                          {"mu": 0.9, "use_nesterov": True}, []),
}


def _run(op_type, ins, attrs, device, diff):
    t_ins = {s: [v.to(device).requires_grad_(s in diff)] for s, v in
             ins.items()}
    outs = registry.run_op(op_type, t_ins, dict(attrs, _device=device))
    grads = {}
    if diff:
        y = outs["Y" if op_type == "batch_norm" else (
            "Output" if op_type == "conv2d" else "Out")][0]
        ct = torch.linspace(-1, 1, y.numel()).reshape(y.shape).to(device)
        gs = torch.autograd.grad(y, [t_ins[s][0] for s in diff],
                                 grad_outputs=ct.to(y.dtype))
        grads = {"d" + s: g for s, g in zip(diff, gs)}
    return {k: [v.detach().cpu() for v in vs] for k, vs in outs.items()}, \
        {k: v.cpu() for k, v in grads.items()}


def _close(got, want, tol, what):
    if not want.is_floating_point():
        assert torch.equal(got, want), what
        return
    got, want = got.double(), want.double()
    err = (got - want).norm() / want.norm().clamp_min(1e-30)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert err <= tol, (what, float(err))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_op_on_card_matches_cpu(dev, name, dtype):
    """Forward results and input gradients, card against CPU, relative in
    norm."""
    op_type, makers, attrs, diff = CASES[name]
    g = torch.Generator().manual_seed(sorted(CASES).index(name))
    ins = {s: m(g) for s, m in makers.items()}
    if dtype == "bfloat16":
        if op_type not in ("conv2d", "pool2d", "batch_norm"):
            pytest.skip("bf16 only where the AMP path feeds bf16")
        key = "Input" if op_type == "conv2d" else "X"
        ins[key] = ins[key].bfloat16()
        if op_type == "conv2d":
            ins["Filter"] = ins["Filter"].bfloat16()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    card = _run(op_type, ins, attrs, dev, diff)
    cpu = _run(op_type, ins, attrs, torch.device("cpu"), diff)
    for part_card, part_cpu in zip(card, cpu):
        assert sorted(part_card) == sorted(part_cpu)
        for k in part_cpu:
            vs_card = part_card[k] if isinstance(part_card[k], list) \
                else [part_card[k]]
            vs_cpu = part_cpu[k] if isinstance(part_cpu[k], list) \
                else [part_cpu[k]]
            for a, b in zip(vs_card, vs_cpu):
                _close(a, b, tol, k)


def _program(img, classes, amp):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        image = fluid.layers.data("image", shape=[3, img, img],
                                  dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        logits = resnet.resnet(image, class_dim=classes, depth=50,
                               scan_stages=True)
        loss = fluid.layers.mean(
            fluid.layers.loss.softmax_with_cross_entropy(logits, label))
        opt = fluid.optimizer.MomentumOptimizer(3e-3, momentum=0.9)
        if amp:
            opt = mixed_precision.decorate(opt,
                                           use_dynamic_loss_scaling=False)
        opt.minimize(loss)
        fluid.fuse_optimizer_ops(main)
    return main, startup, loss


@pytest.mark.parametrize("amp", [False, True])
def test_resnet50_steps_on_card_match_cpu(dev, amp):
    """Two steps of the scanned ResNet50 (32 x 32, batch 4, 10 classes,
    fused Momentum) on the card and on the CPU from one startup state
    (each residual branch's last BN scale 0, its master too): losses
    within 1e-4 in float32, 2e-2 under bf16 AMP O2, and the running
    statistics moved alike."""
    main, startup, loss = _program(32, 10, amp)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    assert all(scope.find_var(n).device == dev for n in names)
    state = dump_numpy_state(scope, names)
    # the live scale and, under AMP, its fp32 master
    state.update((n, np.zeros_like(v)) for n, v in state.items()
                 if n.split("@")[0].endswith("2c_bn_scale"))
    r = np.random.RandomState(0)
    feed = {"image": r.randn(4, 3, 32, 32).astype("float32"),
            "label": r.randint(0, 10, (4, 1)).astype("int64")}
    stats = [n for n in names if n.endswith("_bn_mean")]
    out = {}
    for place in (None, fluid.CPUPlace()):
        exe = fluid.Executor(place)
        s = fluid.Scope()
        load_numpy_state(s, state, exe.device)
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=s)[0][0]) for _ in range(2)]
        out[exe.device.type] = (losses, dump_numpy_state(s, stats))
    tol = BF16_TOL if amp else F32_TOL
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=tol)
    for n in stats:
        _close(torch.tensor(out["cuda"][1][n]),
               torch.tensor(out["cpu"][1][n]), tol, n)
