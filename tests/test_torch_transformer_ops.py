"""The op types, operator sugar and learning-rate schedules that the
Transformer slice adds to the port (paddle_tpu_torch, on the CPU), each
against the JAX package.

As in `tests/test_torch_bert_ops.py`: seeded numpy inputs go through the
reference's `get_op(t).compute` and the port's; float32 outputs within
1e-6, integer and bool outputs exactly; for differentiable ops the
gradient of every float input under one seeded cotangent (`jax.vjp`
against `torch.autograd.grad`) within 1e-5; `infer_outputs` with a -1
batch equal in shape and dtype; no new type is a host (`no_jit`) or
value-shaped (`dynamic_shape`) op in the reference, so none needs a host
path here. `Variable`'s operators build the reference's ops with scalars
on either side, and each of the eight learning-rate schedules gives the
reference's rate on each of 5 steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rfluid
from paddle_tpu.core.scope import Scope as RScope
from paddle_tpu.ops import registry as rreg

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.types import to_torch_dtype
from paddle_tpu_torch.ops import registry as treg

RTOL, ATOL, GRAD_RTOL = 1e-6, 1e-6, 1e-5


def _f(*shape):
    return lambda r: r.randn(*shape).astype("float32")


def _pos(*shape):
    return lambda r: (r.rand(*shape) + 0.5).astype("float32")


def _i(lo, hi, *shape):
    return lambda r: r.randint(lo, hi, size=shape).astype("int64")


def _b(*shape):
    return lambda r: r.rand(*shape) < 0.5


def _nonzero_i(*shape):
    return lambda r: (r.randint(1, 5, size=shape)
                      * r.choice([-1, 1], size=shape)).astype("int64")


def _ids_with_outside(r):
    """[2, 4, 1] ids over 6 classes, one negative and one past the end
    (rows of zeros)."""
    y = r.randint(0, 6, size=(2, 4, 1)).astype("int64")
    y[0, 0, 0], y[1, 1, 0] = -1, 6
    return y


def _pre_ids(r):
    """[2, 3] previous ids over 5 candidates, end id 0 in two beams."""
    y = r.randint(1, 5, size=(2, 3)).astype("int64")
    y[0, 1], y[1, 2] = 0, 0
    return y


def _log_probs(*shape):
    def make(r):
        x = r.randn(*shape).astype("float32")
        return x - np.log(np.exp(x).sum(-1, keepdims=True))
    return make


def _parents(r):
    return r.randint(0, 3, size=(4, 2, 3)).astype("int64")


def _ew(op, x, y, axis=-1, diff=("X", "Y")):
    return (op, {"X": [x], "Y": [y]}, {"axis": axis}, list(diff), ["X"])


#: name -> (op type, {slot: [numpy maker]}, attrs, float input slots to
#: differentiate, batch-carrying slots for the -1 inference check)
CASES = {
    "elementwise_sub": _ew("elementwise_sub", _f(2, 3, 4), _f(3), axis=1),
    "elementwise_max": _ew("elementwise_max", _f(2, 3, 4), _f(4)),
    "elementwise_min": _ew("elementwise_min", _f(2, 3, 4), _f(3, 4)),
    "elementwise_pow": _ew("elementwise_pow", _pos(2, 3), _f(3)),
    "elementwise_pow_scalar": _ew("elementwise_pow", _pos(4, 1),
                                  lambda r: np.float32([-0.5])),
    "elementwise_mod": _ew("elementwise_mod", _f(2, 5), _pos(5)),
    "elementwise_mod_int": _ew("elementwise_mod", _i(-9, 9, 3, 4),
                               _nonzero_i(4), diff=()),
    "elementwise_floordiv": _ew("elementwise_floordiv", _i(-9, 9, 3, 4),
                                _nonzero_i(4), diff=()),
    "equal": ("equal", {"X": [_i(0, 3, 4, 3)], "Y": [_i(0, 3, 3)]}, {}, [],
              ["X"]),
    "not_equal": ("not_equal", {"X": [_i(0, 3, 4, 3)], "Y": [_i(0, 3, 4, 3)]},
                  {}, [], ["X", "Y"]),
    "less_than": ("less_than", {"X": [_f(4, 3)], "Y": [_f(1)]}, {}, [],
                  ["X"]),
    "less_equal": ("less_equal", {"X": [_i(0, 3, 4, 3)],
                                  "Y": [_i(0, 3, 4, 3)]}, {}, [], ["X", "Y"]),
    "greater_than": ("greater_than", {"X": [_f(4, 3)], "Y": [_f(4, 3)]}, {},
                     [], ["X", "Y"]),
    "greater_equal": ("greater_equal", {"X": [_i(0, 3, 4, 3)],
                                        "Y": [_i(0, 3, 1)]}, {}, [], ["X"]),
    "logical_and": ("logical_and", {"X": [_b(4, 3)], "Y": [_b(4, 3)]}, {},
                    [], ["X", "Y"]),
    "logical_or": ("logical_or", {"X": [_b(4, 3)], "Y": [_b(4, 3)]}, {}, [],
                   ["X", "Y"]),
    "logical_xor": ("logical_xor", {"X": [_b(4, 3)], "Y": [_b(4, 3)]}, {},
                    [], ["X", "Y"]),
    "logical_not": ("logical_not", {"X": [_b(4, 3)]}, {}, [], ["X"]),
    "fill_constant_batch_size_like": (
        "fill_constant_batch_size_like", {"Input": [_f(5, 3)]},
        {"shape": [1, 7], "dtype": "int64", "value": 4.0,
         "input_dim_idx": 0, "output_dim_idx": 1}, [], ["Input"]),
    "assign_value_fp32": ("assign_value", {},
                          {"shape": [2, 3], "dtype": "float32",
                           "fp32_values": [0.5, -1.0, 2.25, 3.0, 0.0, 7.5]},
                          [], []),
    "assign_value_int64": ("assign_value", {},
                           {"shape": [3], "dtype": "int64",
                            "int64_values": [4, -2, 9]}, [], []),
    "squeeze2": ("squeeze2", {"X": [_f(3, 1, 4, 1)]}, {"axes": [1, -1]},
                 ["X"], ["X"]),
    "squeeze2_not_one": ("squeeze2", {"X": [_f(3, 1, 4)]}, {"axes": [2]},
                         ["X"], ["X"]),
    "unsqueeze2": ("unsqueeze2", {"X": [_f(3, 4)]}, {"axes": [2, 0]},
                   ["X"], ["X"]),
    "stack": ("stack", {"X": [_f(3, 4), _f(3, 4), _f(3, 4)]}, {"axis": 1},
              ["X"], ["X"]),
    "increment_int": ("increment", {"X": [_i(0, 9, 1)]}, {"step": 1.0}, [],
                      []),
    "increment_float": ("increment", {"X": [_f(1)]}, {"step": 2.5}, ["X"],
                        []),
    "one_hot": ("one_hot", {"X": [_ids_with_outside]}, {"depth": 6}, [],
                ["X"]),
    "label_smooth": ("label_smooth", {"X": [_f(2, 4, 6)]},
                     {"epsilon": 0.1}, ["X"], ["X"]),
    "label_smooth_prior": ("label_smooth", {"X": [_f(2, 4, 6)],
                                            "PriorDist": [_pos(6)]},
                           {"epsilon": 0.2}, ["X", "PriorDist"], ["X"]),
    "exp": ("exp", {"X": [_f(4, 5)]}, {}, ["X"], ["X"]),
    "floor": ("floor", {"X": [_f(4, 5)]}, {}, ["X"], ["X"]),
    "cos": ("cos", {"X": [_f(4, 5)]}, {}, ["X"], ["X"]),
    "where": ("where", {"Condition": [_b(4, 3)], "X": [_f(4, 3)],
                        "Y": [_f(4, 3)]}, {}, ["X", "Y"],
              ["Condition", "X", "Y"]),
    "sigmoid": ("sigmoid", {"X": [_f(4, 5)]}, {}, ["X"], ["X"]),
    "log_softmax": ("log_softmax", {"X": [_f(4, 3, 5)]}, {"axis": 1},
                    ["X"], ["X"]),
    "split_num": ("split", {"X": [_f(4, 6)]}, {"num": 3, "axis": -1},
                  ["X"], ["X"]),
    "split_sections": ("split", {"X": [_f(4, 6)]},
                       {"sections": [1, 2, 3], "axis": 1}, ["X"], ["X"]),
    "expand": ("expand", {"X": [_f(2, 1, 3)]}, {"expand_times": [1, 4, 2]},
               ["X"], ["X"]),
    "cumsum": ("cumsum", {"X": [_f(3, 4)]}, {"axis": 1}, ["X"], ["X"]),
    "cumsum_exclusive": ("cumsum", {"X": [_i(0, 3, 3, 4)]},
                         {"axis": 0, "exclusive": True}, [], ["X"]),
    "cumsum_reverse": ("cumsum", {"X": [_f(3, 4)]},
                       {"axis": -1, "reverse": True}, ["X"], ["X"]),
    "beam_search": ("beam_search", {"pre_ids": [_pre_ids],
                                    "pre_scores": [_f(2, 3)],
                                    "scores": [_log_probs(2, 3, 5)]},
                    {"beam_size": 3, "end_id": 0},
                    ["pre_scores", "scores"], []),
    "beam_search_ids": ("beam_search", {"pre_ids": [_pre_ids],
                                        "pre_scores": [_f(2, 3)],
                                        "ids": [_i(0, 50, 2, 3, 5)],
                                        "scores": [_log_probs(2, 3, 5)]},
                        {"beam_size": 3, "end_id": 0}, [], []),
    "gather_tree": ("gather_tree", {"Ids": [_i(0, 9, 4, 2, 3)],
                                    "Parents": [_parents]}, {}, [], []),
    "beam_search_decode": ("beam_search_decode",
                           {"Ids": [_i(0, 9, 4, 2, 3)],
                            "ParentIdx": [_parents],
                            "Scores": [_f(2, 3)]}, {}, [], []),
}
#: the op types this slice adds (tests/test_torch_bert_ops.py checks that
#: the registry is these and the other slices' types)
TRANSFORMER_SLICE_OPS = frozenset(c[0] for c in CASES.values())
NO_GRAD_OUTS = {"squeeze2": {"XShape"}, "unsqueeze2": {"XShape"}}


def test_new_types_are_plain_device_ops():
    """36 types, all registered in both packages; the reference marks
    none `no_jit` or `dynamic_shape`."""
    assert len(TRANSFORMER_SLICE_OPS) == 36
    assert TRANSFORMER_SLICE_OPS <= set(treg.registered_ops())
    for t in TRANSFORMER_SLICE_OPS:
        op = rreg.get_op(t)
        assert not op.no_jit and not op.dynamic_shape, t


def test_amp_lists_match_reference():
    """The AMP lists classify every op type as the reference's do (of
    the new types exp is black; elementwise_sub, sigmoid and split gray;
    the rest unlisted, following their inputs)."""
    from paddle_tpu.fluid.contrib.mixed_precision import fp16_lists as rl
    from paddle_tpu_torch.fluid.contrib.mixed_precision import \
        fp16_lists as tl

    for name in ("white_list", "black_list", "gray_list"):
        assert getattr(tl, name) == getattr(rl, name), name
    listed = tl.white_list | tl.black_list | tl.gray_list
    assert TRANSFORMER_SLICE_OPS & listed == {"elementwise_sub", "exp",
                                              "sigmoid", "split"}
    assert "exp" in tl.black_list


def _inputs(name):
    r = np.random.RandomState(sorted(CASES).index(name))
    return {slot: [make(r) for make in makers]
            for slot, makers in CASES[name][1].items()}


def _to_torch(a, grad=False):
    t = torch.as_tensor(a, dtype=to_torch_dtype(a.dtype))
    return t.requires_grad_(True) if grad else t


def _reference(op_type, ins, attrs):
    return rreg.normalize_outs(rreg.get_op(op_type).compute(
        {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
        dict(attrs)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_reference(name):
    op_type, _, attrs, diff_slots, _ = CASES[name]
    ins = _inputs(name)
    r_out = _reference(op_type, ins, attrs)
    t_ins = {s: [_to_torch(a, s in diff_slots) for a in v]
             for s, v in ins.items()}
    t_out = treg.normalize_outs(treg.get_op(op_type).compute(
        t_ins, dict(attrs, _device=torch.device("cpu"))))
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

    float_outs = sorted(s for s in r_out
                        if np.issubdtype(np.asarray(r_out[s][0]).dtype,
                                         np.floating)
                        and s not in NO_GRAD_OUTS.get(op_type, ()))
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
    leaves = [t for s in diff_slots for t in t_ins[s]]
    t_grads = torch.autograd.grad(
        [t_out[s][0] for s in float_outs], leaves,
        grad_outputs=[torch.as_tensor(cts[s]) for s in float_outs],
        allow_unused=True)
    want = [g for s in diff_slots for g in r_grads[s]]
    for k, (tg, rg) in enumerate(zip(t_grads, want)):
        tg = np.zeros(rg.shape, "float32") if tg is None else tg.numpy()
        np.testing.assert_allclose(tg, np.asarray(rg), rtol=GRAD_RTOL,
                                   atol=ATOL, err_msg="grad %d" % k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_infer_outputs_matches_reference(name):
    op_type, _, attrs, _, batch_slots = CASES[name]
    specs = {s: [((-1,) + a.shape[1:] if s in batch_slots else a.shape,
                  str(a.dtype)) for a in v]
             for s, v in _inputs(name).items()}
    assert treg.infer_outputs(op_type, specs, dict(attrs)) == \
        rreg.infer_outputs(op_type, specs, dict(attrs))


# -- Variable operator sugar -------------------------------------------------

def _sugar(fluid):
    """Every operator of Variable, with vars and scalars on either side."""
    L = fluid.layers
    x = L.data("x", shape=[3], dtype="float32")
    y = L.data("y", shape=[3], dtype="float32")
    k = L.data("k", shape=[3], dtype="int64")
    return [
        x + y, x + 2.0, 2.0 + x, x - y, x - 1.5, 1.5 - x, x * y, x * 3.0,
        3.0 * x, x / y, x / 4.0, 4.0 / x, x ** 2.0, x ** y, x % 1.5, k % 3,
        k // 2, -x, x < y, x <= 0.5, x > y, x >= 0.5,
        L.elementwise_add(x, y) * 0.5 + 1.0,
        L.reshape(x, [-1, 3]) @ L.reshape(y, [3, -1])]


def test_variable_operators_match_reference():
    """The same expressions build the same op types in both packages and
    compute the same values (floats within 1e-6, ints and bools
    exactly)."""
    r = np.random.RandomState(4)
    feed = {"x": (r.rand(2, 3) + 0.5).astype("float32"),
            "y": (r.rand(2, 3) + 0.5).astype("float32"),
            "k": r.randint(-7, 7, size=(2, 3)).astype("int64")}
    res = {}
    for fluid, place, scope in ((rfluid, rfluid.CPUPlace(), RScope()),
                                (tfluid, tfluid.CPUPlace(), tfluid.Scope())):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name_guard():
            outs = _sugar(fluid)
        types = [op.type for op in main.global_block().ops]
        vals = fluid.Executor(place).run(main, feed=feed, fetch_list=outs,
                                         scope=scope)
        res[fluid is tfluid] = (types, [np.asarray(v) for v in vals])
    (r_types, r_vals), (t_types, t_vals) = res[False], res[True]
    assert t_types == r_types
    assert r_types.count("scale") >= 8 and "elementwise_pow" in r_types
    for k, (g, w) in enumerate(zip(t_vals, r_vals)):
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=str(k))
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(k))


def test_variable_equality_is_identity():
    """`==` compares vars by identity (it builds no op), as in the
    reference; vars hash by identity."""
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        x = tfluid.layers.data("x", shape=[3])
        y = tfluid.layers.data("y", shape=[3])
    n_ops = len(main.global_block().ops)
    assert x == x and not x == y and not x == 1.0
    assert len({x, y, x}) == 2 and len(main.global_block().ops) == n_ops


# -- learning-rate schedules -------------------------------------------------

SCHEDULES = {
    "noam_decay": lambda L: L.noam_decay(64, 4, 2.0),
    "exponential_decay": lambda L: L.exponential_decay(0.1, 2, 0.5),
    "exponential_decay_staircase": lambda L: L.exponential_decay(
        0.1, 2, 0.5, staircase=True),
    "natural_exp_decay": lambda L: L.natural_exp_decay(0.1, 3, 0.7,
                                                       staircase=True),
    "inverse_time_decay": lambda L: L.inverse_time_decay(0.1, 2, 0.5),
    "polynomial_decay": lambda L: L.polynomial_decay(0.1, 3, 0.01,
                                                     power=2.0),
    "piecewise_decay": lambda L: L.piecewise_decay([1, 3], [1.0, 0.5, 0.1]),
    "cosine_decay": lambda L: L.cosine_decay(0.1, 2, 4),
    "linear_lr_warmup": lambda L: L.linear_lr_warmup(0.3, 3, 0.0, 0.2),
}


def _schedule_rates(fluid, place, scope, name, steps=5):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        lr = SCHEDULES[name](fluid.layers)
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    rates = [np.asarray(exe.run(main, fetch_list=[lr], scope=scope)[0])
             for _ in range(steps)]
    assert main.global_block().ops[0].type == "increment"
    return rates, np.asarray(scope.find_var("@LR_DECAY_COUNTER@"))


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    """Five runs of the schedule's program: the rate each step within
    1e-6 relative (noam's power and the exponentials round in their last
    bit differently), the step counter equal."""
    want, w_count = _schedule_rates(rfluid, rfluid.CPUPlace(), RScope(),
                                    name)
    got, g_count = _schedule_rates(tfluid, tfluid.CPUPlace(),
                                   tfluid.Scope(), name)
    np.testing.assert_array_equal(g_count, w_count)
    assert g_count.dtype == np.int32
    for step, (g, w) in enumerate(zip(got, want)):
        assert (g.dtype, g.shape) == (w.dtype, w.shape)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0,
                                   err_msg="step %d" % step)
