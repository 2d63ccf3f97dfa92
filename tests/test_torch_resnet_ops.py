"""The op types that ResNet training adds to the port's registry
(paddle_tpu_torch.ops, on the CPU), each against the JAX package's
(`paddle_tpu.ops`): conv2d, depthwise_conv2d, pool2d, batch_norm, sign,
gather, scatter, momentum, fused_sgd and fused_momentum.

As in `tests/test_torch_bert_ops.py`: seeded numpy inputs go through the
reference's `get_op(t).compute` and the port's; float32 outputs within
rtol 1e-5 and atol 1e-6, integer outputs exactly; for differentiable ops
the gradient of every float input under one seeded cotangent (`jax.vjp`
against `torch.autograd.grad`) within rtol 1e-4; `infer_outputs` with a
-1 batch equal in shape and dtype. Convolutions at 7 x 7 stride 2
padding 3 (ResNet's stem), with groups, dilation and 4-value padding;
pooling with ceil_mode x exclusive where the last window hangs over the
edge, global and adaptive; batch_norm in training, is_test and global
statistics, NCHW and NHWC, with all five outputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import registry as rreg

from paddle_tpu_torch.core.types import to_torch_dtype
from paddle_tpu_torch.ops import registry as treg

RTOL, ATOL, GRAD_RTOL = 1e-5, 1e-6, 1e-4


def _f(*shape):
    return lambda r: r.randn(*shape).astype("float32")


def _pos(*shape):
    return lambda r: (r.rand(*shape) + 0.5).astype("float32")


def _ids(*values):
    return lambda r: np.asarray(values, dtype="int32")


def _const(v):
    return lambda r: np.asarray(v)


def _conv(x, w, **attrs):
    return ("conv2d", {"Input": [_f(*x)], "Filter": [_f(*w)]},
            dict({"strides": [1, 1], "paddings": [0, 0],
                  "dilations": [1, 1], "groups": 1}, **attrs),
            ["Input", "Filter"], ["Input"])


def _pool(x, **attrs):
    return ("pool2d", {"X": [_f(*x)]}, attrs, ["X"], ["X"])


def _bn(x, **attrs):
    c = x[1] if attrs.get("data_layout", "NCHW") == "NCHW" else x[-1]
    return ("batch_norm",
            {"X": [_f(*x)], "Scale": [_f(c)], "Bias": [_f(c)],
             "Mean": [_f(c)], "Variance": [_pos(c)]},
            dict({"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
                  "data_layout": "NCHW"}, **attrs),
            ["X", "Scale", "Bias"], ["X"])


_LR = {"LearningRate": [_const(np.float32([0.1]))]}

#: name -> (op type, {slot: [numpy maker]}, attrs, float input slots to
#: differentiate, batch-carrying slots for the -1 inference check)
CASES = {
    "conv_stem_7x7_s2_p3": _conv((2, 3, 16, 16), (4, 3, 7, 7),
                                 strides=[2, 2], paddings=[3, 3]),
    "conv_1x1": _conv((2, 8, 5, 5), (6, 8, 1, 1)),
    "conv_groups": _conv((2, 4, 8, 8), (6, 2, 3, 3), paddings=[1, 1],
                         groups=2),
    "conv_dilation": _conv((1, 3, 9, 9), (2, 3, 3, 3), paddings=[2, 2],
                           dilations=[2, 2]),
    "conv_pad4_stride": _conv((2, 3, 8, 7), (4, 3, 3, 3), strides=[2, 1],
                              paddings=[1, 0, 2, 1]),
    "depthwise_conv2d": ("depthwise_conv2d",
                         {"Input": [_f(2, 4, 8, 8)],
                          "Filter": [_f(4, 1, 3, 3)]},
                         {"strides": [1, 1], "paddings": [1, 1],
                          "dilations": [1, 1], "groups": 4},
                         ["Input", "Filter"], ["Input"]),
    "pool_max_3x3_s2_p1": _pool((2, 3, 16, 16), pooling_type="max",
                                ksize=[3, 3], strides=[2, 2],
                                paddings=[1, 1]),
    "pool_max_ceil": _pool((2, 3, 8, 8), pooling_type="max", ksize=[3, 3],
                           strides=[2, 2], paddings=[0, 0], ceil_mode=True),
    "pool_avg_ceil_exclusive": _pool(
        (2, 3, 7, 7), pooling_type="avg", ksize=[3, 3], strides=[2, 2],
        paddings=[1, 1], ceil_mode=True, exclusive=True),
    "pool_avg_ceil_inclusive": _pool(
        (2, 3, 7, 7), pooling_type="avg", ksize=[3, 3], strides=[2, 2],
        paddings=[1, 1], ceil_mode=True, exclusive=False),
    "pool_avg_floor_exclusive": _pool(
        (2, 3, 8, 8), pooling_type="avg", ksize=[3, 3], strides=[2, 2],
        paddings=[1, 1], ceil_mode=False, exclusive=True),
    "pool_avg_floor_inclusive": _pool(
        (2, 3, 8, 8), pooling_type="avg", ksize=[3, 3], strides=[2, 2],
        paddings=[1, 1], ceil_mode=False, exclusive=False),
    "pool_avg_global": _pool((2, 5, 4, 4), pooling_type="avg",
                             ksize=[2, 2], global_pooling=True),
    "pool_max_global": _pool((2, 5, 4, 4), pooling_type="max",
                             ksize=[2, 2], global_pooling=True),
    "pool_avg_adaptive": _pool((2, 3, 8, 6), pooling_type="avg",
                               ksize=[2, 3], adaptive=True),
    "pool_max_adaptive": _pool((2, 3, 8, 6), pooling_type="max",
                               ksize=[4, 2], adaptive=True),
    "bn_train": _bn((4, 3, 5, 5)),
    "bn_train_relu": _bn((4, 3, 5, 5), fused_act="relu"),
    "bn_train_nhwc": _bn((4, 5, 5, 3), data_layout="NHWC"),
    "bn_train_2d": _bn((8, 6)),
    "bn_is_test": _bn((4, 3, 5, 5), is_test=True),
    "bn_global_stats": _bn((4, 3, 5, 5), use_global_stats=True),
    "sign": ("sign", {"X": [_f(4, 5)]}, {}, ["X"], ["X"]),
    "gather": ("gather", {"X": [_f(5, 3)], "Index": [_ids(4, 0, 4)]}, {},
               ["X"], []),
    "gather_scan_row": ("gather", {"X": [_f(3, 6)], "Index": [_ids(1)]},
                        {}, ["X"], []),
    "scatter_overwrite": ("scatter", {"X": [_f(5, 3)], "Ids": [_ids(3, 0)],
                                      "Updates": [_f(2, 3)]},
                          {"overwrite": True}, ["X", "Updates"], []),
    "scatter_add": ("scatter", {"X": [_f(5, 3)], "Ids": [_ids(1, 4, 1)],
                                "Updates": [_f(3, 3)]},
                    {"overwrite": False}, ["X", "Updates"], []),
    "momentum": ("momentum", dict({"Param": [_f(4, 3)], "Grad": [_f(4, 3)],
                                   "Velocity": [_f(4, 3)]}, **_LR),
                 {"mu": 0.9, "use_nesterov": False}, [], []),
    "momentum_nesterov": ("momentum",
                          dict({"Param": [_f(5)], "Grad": [_f(5)],
                                "Velocity": [_f(5)]}, **_LR),
                          {"mu": 0.8, "use_nesterov": True}, [], []),
    "fused_sgd": ("fused_sgd", dict({"Param": [_f(4, 3), _f(5)],
                                     "Grad": [_f(4, 3), _f(5)]}, **_LR),
                  {}, [], []),
    "fused_momentum": ("fused_momentum",
                       dict({"Param": [_f(4, 3), _f(5)],
                             "Grad": [_f(4, 3), _f(5)],
                             "Velocity": [_f(4, 3), _f(5)]}, **_LR),
                       {"mu": 0.9, "use_nesterov": False}, [], []),
    "fused_momentum_nesterov": ("fused_momentum",
                                dict({"Param": [_f(2, 2, 3), _f(7)],
                                      "Grad": [_f(2, 2, 3), _f(7)],
                                      "Velocity": [_f(2, 2, 3), _f(7)]},
                                     **_LR),
                                {"mu": 0.9, "use_nesterov": True}, [], []),
}
#: the op types this file holds (joined into the registry's cover in
#: tests/test_torch_bert_ops.py)
RESNET_SLICE_OPS = {"conv2d", "depthwise_conv2d", "pool2d", "batch_norm",
                    "sign", "gather", "scatter", "momentum", "fused_sgd",
                    "fused_momentum"}
#: float outputs that carry no gradient in the port: batch_norm's
#: statistics, as in Paddle's batch_norm_grad, which takes Y's gradient
#: only (the reference's values are held all the same)
NO_GRAD_OUTS = {"batch_norm": {"MeanOut", "VarianceOut", "SavedMean",
                               "SavedVariance"}}


def test_cases_cover_the_slice():
    assert {c[0] for c in CASES.values()} == RESNET_SLICE_OPS
    assert RESNET_SLICE_OPS <= set(treg.registered_ops())


def _inputs(name):
    r = np.random.RandomState(sorted(CASES).index(name))
    return {slot: [make(r) for make in makers]
            for slot, makers in CASES[name][1].items()}


def _to_torch(a, grad=False):
    t = torch.as_tensor(a, dtype=to_torch_dtype(a.dtype))
    return t.requires_grad_(True) if grad else t


def _port(op_type, ins, attrs):
    attrs = dict(attrs, _device=torch.device("cpu"))
    return treg.normalize_outs(treg.get_op(op_type).compute(ins, attrs))


def _reference(op_type, attrs):
    def compute(full):
        return rreg.normalize_outs(rreg.get_op(op_type).compute(
            full, dict(attrs)))

    return compute


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_reference(name):
    op_type, _, attrs, diff_slots, _ = CASES[name]
    ins = _inputs(name)
    compute = _reference(op_type, attrs)
    r_out = jax.jit(compute)({s: [jnp.asarray(a) for a in v]
                              for s, v in ins.items()})
    t_ins = {s: [_to_torch(a, s in diff_slots) for a in v]
             for s, v in ins.items()}
    t_out = _port(op_type, t_ins, attrs)
    assert sorted(r_out) == sorted(t_out)
    for slot in r_out:
        assert len(r_out[slot]) == len(t_out[slot]), slot
        for rv, tv in zip(r_out[slot], t_out[slot]):
            rv, tv = np.asarray(rv), tv.detach().numpy()
            assert (tv.dtype, tv.shape) == (rv.dtype, rv.shape), slot
            if np.issubdtype(rv.dtype, np.floating):
                np.testing.assert_allclose(tv, rv, rtol=RTOL, atol=ATOL,
                                           err_msg=slot)
            else:
                np.testing.assert_array_equal(tv, rv, err_msg=slot)
    if not diff_slots:
        return

    no_grad = NO_GRAD_OUTS.get(op_type, set())
    float_outs = sorted(s for s in r_out
                        if np.issubdtype(np.asarray(r_out[s][0]).dtype,
                                         np.floating) and s not in no_grad)
    cr = np.random.RandomState(99)
    cts = {s: cr.randn(*np.asarray(r_out[s][0]).shape).astype("float32")
           for s in float_outs}

    def fwd(diff):
        full = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
        full.update(diff)
        outs = compute(full)
        return {s: outs[s][0] for s in float_outs}

    diff_in = {s: [jnp.asarray(a) for a in ins[s]] for s in diff_slots}
    r_grads = jax.jit(lambda d, c: jax.vjp(fwd, d)[1](c)[0])(
        diff_in, {s: jnp.asarray(c) for s, c in cts.items()})
    t_grads = torch.autograd.grad(
        [t_out[s][0] for s in float_outs],
        [t_ins[s][0] for s in diff_slots],
        grad_outputs=[torch.as_tensor(cts[s]) for s in float_outs])
    for s, tg in zip(diff_slots, t_grads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(r_grads[s][0]),
                                   rtol=GRAD_RTOL, atol=ATOL,
                                   err_msg="d" + s)
    for s in no_grad:
        assert not t_out[s][0].requires_grad, s


def _specs(name):
    _, _, _, _, batch_slots = CASES[name]
    return {s: [((-1,) + a.shape[1:] if s in batch_slots else a.shape,
                 str(a.dtype)) for a in v]
            for s, v in _inputs(name).items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_infer_outputs_matches_reference(name):
    op_type, _, attrs, _, _ = CASES[name]
    specs = _specs(name)
    assert treg.infer_outputs(op_type, specs, dict(attrs)) == \
        rreg.infer_outputs(op_type, specs, dict(attrs))


def test_batch_norm_keeps_paddle_statistics():
    """Paddle's convention, not PyTorch's: the biased batch variance,
    mean_out = mean * momentum + batch_mean * (1 - momentum), SavedVariance
    = 1/sqrt(var + eps), and the running inputs left as they were."""
    r = np.random.RandomState(5)
    x = torch.tensor(r.randn(6, 2, 3, 3).astype("float32") * 2 + 1)
    mean, var = torch.zeros(2), torch.ones(2)
    out = _port("batch_norm", {"X": [x], "Scale": [torch.ones(2)],
                               "Bias": [torch.zeros(2)], "Mean": [mean],
                               "Variance": [var]},
                {"momentum": 0.9, "epsilon": 1e-5})
    xd = x.double().transpose(0, 1).reshape(2, -1)
    bvar = xd.var(dim=1, unbiased=False)
    torch.testing.assert_close(out["MeanOut"][0].double(),
                               0.1 * xd.mean(dim=1), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(out["VarianceOut"][0].double(),
                               0.9 + 0.1 * bvar, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(out["SavedVariance"][0].double(),
                               (bvar + 1e-5).rsqrt(), rtol=1e-6, atol=1e-6)
    assert torch.equal(mean, torch.zeros(2)) and torch.equal(
        var, torch.ones(2))


def test_pool_ceil_mode_counts_the_reference_windows():
    """The reference's ceil_mode takes one more window wherever a
    partial one remains, even one that lies wholly in the right padding,
    where PyTorch's ceil_mode drops it: 5 wide, 2 x 2 windows, stride 2,
    padding 1 gives the reference 4 windows, the last an exclusive
    average over no cell (NaN), and PyTorch 3. The port gives the
    reference's."""
    x = torch.arange(2 * 5, dtype=torch.float32).reshape(1, 1, 2, 5)
    attrs = {"pooling_type": "avg", "ksize": [2, 2], "strides": [2, 2],
             "paddings": [1, 1], "ceil_mode": True, "exclusive": True}
    got = _port("pool2d", {"X": [x]}, attrs)["Out"][0]
    want = np.asarray(rreg.get_op("pool2d").compute(
        {"X": [jnp.asarray(x.numpy())]}, dict(attrs))["Out"])
    torch_ceil = torch.nn.functional.avg_pool2d(
        x, 2, 2, padding=1, ceil_mode=True, count_include_pad=False)
    assert got.shape[-1] == want.shape[-1] == 4
    assert torch_ceil.shape[-1] == 3
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, equal_nan=True)
