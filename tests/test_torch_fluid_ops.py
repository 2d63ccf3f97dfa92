"""The port's op registry (paddle_tpu_torch.ops, on the CPU) against the
JAX package's (`paddle_tpu.ops`), op type by op type, for the 15 op types
of the fluid slice.

Seeded numpy inputs go through the reference's `get_op(t).compute` and
the port's: float outputs within rtol 1e-5 (float32 on both sides),
integer outputs exactly, and for differentiable ops the gradient of every
float input under one seeded cotangent (`jax.vjp` against
`torch.autograd.grad`) within rtol 1e-5. `infer_outputs` with a -1 batch
agrees in shape and dtype. The random ops are held by shape, dtype and
range only: the port's generator streams are not JAX's. Last, the MNIST
MLP's programs, built in both packages, agree op by op."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rfluid
from paddle_tpu.core.rng import make_key
from paddle_tpu.ops import registry as rreg

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.types import to_torch_dtype
from paddle_tpu_torch.ops import registry as treg

RTOL, ATOL = 1e-5, 1e-6


def _f(*shape):
    return lambda r: r.randn(*shape).astype("float32")


def _i(high, *shape):
    return lambda r: r.randint(0, high, size=shape).astype("int64")


def _labels_with_ignored(r):
    """Five classes; an ignored label, one counted from the last class
    and one beyond the classes (NaN loss, zero gradient)."""
    y = r.randint(0, 5, size=(6, 1)).astype("int64")
    y[2, 0], y[3, 0], y[4, 0] = -100, -1, 7
    return y


def _soft_labels(r):
    p = r.rand(6, 5).astype("float32")
    return p / p.sum(-1, keepdims=True)


def _ties(r):
    x = r.randint(0, 3, size=(4, 6)).astype("float32")
    x[0] = 1.0  # a whole row of ties
    return x


#: name -> (op type, {slot: [numpy maker]}, attrs, float input slots to
#: differentiate, batch-carrying slots for the -1 inference check)
CASES = {
    "mul": ("mul", {"X": [_f(2, 3, 4)], "Y": [_f(12, 5)]},
            {"x_num_col_dims": 1, "y_num_col_dims": 1}, ["X", "Y"], ["X"]),
    "mean": ("mean", {"X": [_f(4, 5)]}, {}, ["X"], ["X"]),
    "scale": ("scale", {"X": [_f(4, 5)]},
              {"scale": 2.5, "bias": 0.3, "bias_after_scale": False},
              ["X"], ["X"]),
    "elementwise_add": ("elementwise_add", {"X": [_f(2, 3, 4)],
                                            "Y": [_f(3)]},
                        {"axis": 1}, ["X", "Y"], ["X"]),
    "relu": ("relu", {"X": [_f(4, 5)]}, {}, ["X"], ["X"]),
    "softmax": ("softmax", {"X": [_f(4, 5)]}, {"axis": -1}, ["X"], ["X"]),
    "softmax_with_cross_entropy": (
        "softmax_with_cross_entropy",
        {"Logits": [_f(6, 5)], "Label": [_labels_with_ignored]},
        {"soft_label": False, "ignore_index": -100, "axis": -1},
        ["Logits"], ["Logits", "Label"]),
    "softmax_with_cross_entropy_soft": (
        "softmax_with_cross_entropy",
        {"Logits": [_f(6, 5)], "Label": [_soft_labels]},
        {"soft_label": True, "axis": -1}, ["Logits", "Label"],
        ["Logits", "Label"]),
    "top_k": ("top_k", {"X": [_ties]}, {"k": 2}, ["X"], ["X"]),
    "fill_constant": ("fill_constant", {},
                      {"shape": [2, 3], "dtype": "int64", "value": 7.0},
                      [], []),
    "accuracy": ("accuracy", {"Out": [_f(6, 2)], "Indices": [_i(4, 6, 2)],
                              "Label": [_i(4, 6, 1)]}, {}, [],
                 ["Out", "Indices", "Label"]),
    "sgd": ("sgd", {"Param": [_f(4, 3)], "Grad": [_f(4, 3)],
                    "LearningRate": [lambda r: np.float32([0.1])]},
            {}, [], []),
    "adam": ("adam", {"Param": [_f(4, 3)], "Grad": [_f(4, 3)],
                      "Moment1": [_f(4, 3)],
                      "Moment2": [lambda r: r.rand(4, 3).astype("float32")],
                      "Beta1Pow": [lambda r: np.float32([0.9 ** 3])],
                      "Beta2Pow": [lambda r: np.float32([0.999 ** 3])],
                      "LearningRate": [lambda r: np.float32([1e-3])]},
             {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}, [], []),
    "fc": ("fc", {"Input": [_f(2, 3, 4)], "W": [_f(4, 5)], "Bias": [_f(5)]},
           {"in_num_col_dims": 2, "activation_type": "relu"},
           ["Input", "W", "Bias"], ["Input"]),
}
RNG_OPS = {
    "uniform_random": {"shape": [64, 64], "dtype": "float32", "min": -0.5,
                       "max": 0.25, "seed": 0},
    "gaussian_random": {"shape": [64, 64], "dtype": "float32", "mean": 1.0,
                        "std": 2.0, "seed": 0},
}


def test_cases_cover_the_slice():
    """Every registered op type of the port has a case here."""
    types = {c[0] for c in CASES.values()} | set(RNG_OPS)
    assert types == set(treg.registered_ops()) and len(types) == 15


def _inputs(name):
    r = np.random.RandomState(sorted(CASES).index(name))
    return {slot: [make(r) for make in makers]
            for slot, makers in CASES[name][1].items()}


def _to_torch(a, grad=False):
    t = torch.as_tensor(a, dtype=to_torch_dtype(a.dtype))
    return t.requires_grad_(True) if grad else t


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_reference(name):
    op_type, _, attrs, diff_slots, _ = CASES[name]
    ins = _inputs(name)
    r_out = rreg.get_op(op_type).compute(
        {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
        dict(attrs))
    t_ins = {s: [_to_torch(a, s in diff_slots) for a in v]
             for s, v in ins.items()}
    t_out = treg.get_op(op_type).compute(
        t_ins, dict(attrs, _device=torch.device("cpu")))
    r_out, t_out = rreg.normalize_outs(r_out), treg.normalize_outs(t_out)
    assert sorted(r_out) == sorted(t_out)
    for slot in r_out:
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

    # gradients of every float output under one seeded cotangent
    float_outs = sorted(s for s in r_out
                        if np.issubdtype(np.asarray(r_out[s][0]).dtype,
                                         np.floating))
    cr = np.random.RandomState(99)
    cts = {s: cr.randn(*np.asarray(r_out[s][0]).shape).astype("float32")
           for s in float_outs}

    def fwd(diff):
        full = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
        full.update(diff)
        outs = rreg.normalize_outs(rreg.get_op(op_type).compute(
            full, dict(attrs)))
        return {s: outs[s][0] for s in float_outs}

    diff_in = {s: [jnp.asarray(a) for a in ins[s]] for s in diff_slots}
    _, vjp = jax.vjp(fwd, diff_in)
    r_grads = vjp({s: jnp.asarray(c) for s, c in cts.items()})[0]
    leaves = [t_ins[s][0] for s in diff_slots]
    t_grads = torch.autograd.grad(
        [t_out[s][0] for s in float_outs], leaves,
        grad_outputs=[torch.as_tensor(cts[s]) for s in float_outs])
    for s, tg in zip(diff_slots, t_grads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(r_grads[s][0]),
                                   rtol=RTOL, atol=ATOL, err_msg="d" + s)


def _specs(name):
    """Input specs with -1 in the batch dim of the batch-carrying
    slots."""
    _, _, _, _, batch_slots = CASES[name]
    return {s: [((-1,) + a.shape[1:] if s in batch_slots else a.shape,
                 str(a.dtype)) for a in v]
            for s, v in _inputs(name).items()}


#: the reference's fused `fc` cannot be traced: `_fc` (fused_ops.py:334)
#: takes int() of a traced jnp.prod, so jax.eval_shape (and jax.jit)
#: raise. The port is held against its eager output instead.
REF_INFER_FAULTS = {"fc"}


@pytest.mark.parametrize("name", sorted(CASES) + sorted(RNG_OPS))
def test_infer_outputs_matches_reference(name):
    if name in RNG_OPS:
        op_type, specs, attrs = name, {}, RNG_OPS[name]
    else:
        op_type, attrs, specs = CASES[name][0], CASES[name][2], _specs(name)
    got = treg.infer_outputs(op_type, specs, dict(attrs))
    if name not in REF_INFER_FAULTS:
        assert got == rreg.infer_outputs(op_type, specs, dict(attrs))
        return
    with pytest.raises(jax.errors.ConcretizationTypeError):
        rreg.infer_outputs(op_type, specs, dict(attrs))
    eager = rreg.get_op(op_type).compute(
        {s: [jnp.asarray(a) for a in v] for s, v in _inputs(name).items()},
        dict(attrs))
    assert got == {s: [((-1,) + tuple(v.shape[1:]), str(v.dtype))]
                   for s, v in eager.items()}


@pytest.mark.parametrize("op_type", sorted(RNG_OPS))
def test_random_ops_shape_dtype_range(op_type):
    attrs = RNG_OPS[op_type]
    ref = np.asarray(rreg.get_op(op_type).compute(
        {}, dict(attrs, _rng_key=make_key(0)))["Out"])
    g = torch.Generator().manual_seed(0)
    out = treg.get_op(op_type).compute(
        {}, dict(attrs, _device=torch.device("cpu"),
                 _rng_generator=g))["Out"].numpy()
    assert (out.dtype, out.shape) == (ref.dtype, ref.shape)
    if op_type == "uniform_random":
        assert attrs["min"] <= out.min() and out.max() < attrs["max"]
    else:  # 4096 draws: the mean within 5 standard errors, std within 5%
        assert abs(out.mean() - attrs["mean"]) < 5 * attrs["std"] / 64
        assert abs(out.std() / attrs["std"] - 1) < 0.05
    # the same generator seed draws the same values
    again = treg.get_op(op_type).compute(
        {}, dict(attrs, _device=torch.device("cpu"),
                 _rng_generator=torch.Generator().manual_seed(0)))["Out"]
    np.testing.assert_array_equal(again.numpy(), out)


def _build_mnist(fluid):
    img = fluid.layers.data(name="img", shape=[784], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    h = fluid.layers.fc(input=img, size=128, act="relu")
    h = fluid.layers.fc(input=h, size=64, act="relu",
                        param_attr=fluid.ParamAttr(learning_rate=0.5))
    logits = fluid.layers.fc(input=h, size=10, act=None)
    avg = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))
    fluid.layers.accuracy(input=fluid.layers.softmax(logits), label=label)
    fluid.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(avg)
    return fluid.default_main_program(), fluid.default_startup_program()


def _program_record(program):
    """Ops (type, slots, attrs) and vars (shape, dtype, persistable) of
    the global block, in order."""
    block = program.global_block()
    ops = []
    for op in block.ops:
        attrs = {k: v for k, v in op.attrs.items()
                 if k in ("loss_name", "diff_names")
                 or op.type != "backward"}
        ops.append((op.type, op.input_names, op.output_names, attrs))
    vars_ = [(n, tuple(v.shape), v.dtype, bool(v.persistable),
              type(v).__name__) for n, v in block.vars.items()]
    return ops, vars_


def test_mnist_program_matches_reference_op_by_op():
    """The MNIST MLP with Adam (and one param's own learning rate, so
    the `scale` op appears) built in both packages: main and startup
    programs equal in op types, slot names, var names, attrs, shapes,
    dtypes and persistable flags."""
    r_main, r_start = _build_mnist(rfluid)
    fw = tfluid.framework
    old = (fw.switch_main_program(fw.Program()),
           fw.switch_startup_program(fw.Program()))
    try:
        with fw.unique_name_guard():
            t_main, t_start = _build_mnist(tfluid)
    finally:
        fw.switch_main_program(old[0])
        fw.switch_startup_program(old[1])
    for r_prog, t_prog in ((r_main, t_main), (r_start, t_start)):
        r_ops, r_vars = _program_record(r_prog)
        t_ops, t_vars = _program_record(t_prog)
        assert [o[0] for o in t_ops] == [o[0] for o in r_ops]
        for r_op, t_op in zip(r_ops, t_ops):
            assert t_op == r_op
        assert t_vars == r_vars
    assert "scale" in [op.type for op in t_main.global_block().ops]


def test_run_op_supplies_device_and_generator():
    """`run_op` runs an op on its first input's device, gives a random
    op a generator there, and asks for a device when nothing says one."""
    x = torch.tensor([[-1.0, 2.0]])
    assert treg.run_op("relu", {"X": [x]}, {})["Out"][0].tolist() == \
        [[0.0, 2.0]]
    out = treg.run_op("uniform_random", {},
                      dict(RNG_OPS["uniform_random"],
                           _device=torch.device("cpu")))["Out"][0]
    assert out.shape == (64, 64) and out.device.type == "cpu"
    with pytest.raises(ValueError, match="_device"):
        treg.run_op("fill_constant", {}, CASES["fill_constant"][2])
