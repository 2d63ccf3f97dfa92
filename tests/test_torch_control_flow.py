"""Fluid control flow in the port (paddle_tpu_torch, on the CPU) against
the JAX package: `While`, `while_loop`, `cond`, `switch_case`, `case`
and `conditional_block`.

Each case builds the same program in both packages (the eight cases of
`tests/test_control_flow.py`, then a `cond` nested in a `while` that
reads two vars only inside a branch, a `cond` and a `switch_case` whose
outputs reach the loss, and a `conditional_block` on its run and skip
paths), runs the reference's startup and the port's from the same state,
and holds every fetch: integer and bool values exactly, float values
within 1e-6. The block analysis (which vars are scope state in and out)
must equal the reference's. A `while` whose output reaches the loss
raises the reference's error (`lax.while_loop` is not
reverse-differentiable), and each iteration of a loop draws its own
dropout mask."""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rfluid
from paddle_tpu.core.scope import Scope as RScope
from paddle_tpu.fluid import lowering as rlowering

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.scope import load_numpy_state
from paddle_tpu_torch.fluid import lowering as tlowering
from paddle_tpu_torch.ops import registry as treg

FLOAT_TOL = 1e-6


def _programs(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    return main, startup


def _while_accumulates(fluid):
    L = fluid.layers
    i = L.fill_constant([1], "int64", 0)
    ten = L.fill_constant([1], "int64", 10)
    acc = L.fill_constant([1], "float32", 0.0)
    cond_var = L.less_than(i, ten)
    w = L.While(cond_var)
    with w.block():
        acc2 = L.elementwise_add(acc, L.fill_constant([1], "float32", 2.0))
        L.assign(acc2, output=acc)
        L.increment(i, value=1)
        L.less_than(i, ten, cond=cond_var)
    return [{}], [acc, i]


def _while_loop_functional(fluid):
    L = fluid.layers
    i = L.fill_constant([1], "int64", 1)
    limit = L.fill_constant([1], "int64", 6)
    fact = L.fill_constant([1], "int64", 1)

    def body(i, fact):
        return (L.elementwise_add(i, L.fill_constant([1], "int64", 1)),
                L.elementwise_mul(fact, i))

    i, fact = L.while_loop(lambda i, fact: L.less_than(i, limit), body,
                           [i, fact])
    return [{}], [fact, i]


def _cond_both_branches(fluid):
    L = fluid.layers
    x = L.data("x", shape=[1], dtype="float32")
    pred = L.greater_than(x, L.fill_constant([1], "float32", 0.0))
    out = L.cond(pred, lambda: L.scale(x, scale=30.0),
                 lambda: L.scale(x, scale=8.0))
    return [{"x": np.full((1,), v, "float32")} for v in (1.0, -1.0)], [out]


def _cond_multiple_returns(fluid):
    L = fluid.layers
    x = L.data("x", shape=[2], dtype="float32")
    pred = L.greater_than(L.reduce_sum(x),
                          L.fill_constant([1], "float32", 0.0))
    a, b = L.cond(pred,
                  lambda: (L.scale(x, scale=2.0), L.scale(x, scale=3.0)),
                  lambda: (L.scale(x, scale=-2.0), L.scale(x, scale=-3.0)))
    return [{"x": np.array([1.0, 2.0], "float32")},
            {"x": np.array([-1.0, -2.0], "float32")}], [a, b]


def _switch_case_with_default(fluid):
    L = fluid.layers
    index = L.data("i", shape=[1], dtype="int64")
    out = L.switch_case(
        index,
        branch_fns=[lambda: L.fill_constant([1], "float32", 1.0),
                    lambda: L.fill_constant([1], "float32", 2.0)],
        default=lambda: L.fill_constant([1], "float32", 99.0))
    return [{"i": np.full((1,), v, "int64")} for v in (0, 1, 7)], [out]


def _case_chain(fluid):
    L = fluid.layers
    x = L.data("x", shape=[1], dtype="float32")
    one = L.fill_constant([1], "float32", 1.0)
    two = L.fill_constant([1], "float32", 2.0)
    out = L.case(
        [(L.less_than(x, one), lambda: L.fill_constant([1], "float32", 10.)),
         (L.less_than(x, two), lambda: L.fill_constant([1], "float32", 20.))],
        default=lambda: L.fill_constant([1], "float32", 30.0))
    return [{"x": np.full((1,), v, "float32")} for v in (0.5, 1.5, 2.5)], \
        [out]


def _cond_inside_while_updates_loop_var(fluid):
    L = fluid.layers
    i = L.fill_constant([1], "int64", 0)
    six = L.fill_constant([1], "int64", 6)
    acc = L.fill_constant([1], "float32", 0.0)
    two = L.fill_constant([1], "int64", 2)
    cond_var = L.less_than(i, six)
    w = L.While(cond_var)
    with w.block():
        is_odd = L.equal(L.elementwise_mod(i, two),
                         L.fill_constant([1], "int64", 1))

        def add(v):
            def branch():
                L.assign(L.elementwise_add(
                    acc, L.fill_constant([1], "float32", v)), output=acc)
                return L.fill_constant([1], "float32", 0.0)
            return branch

        L.cond(is_odd, add(3.0), add(1.0))
        L.increment(i, value=1)
        L.less_than(i, six, cond=cond_var)
    return [{}], [acc, i]


def _while_reads_param_state(fluid):
    L = fluid.layers
    w = L.create_parameter([1], "float32", name="wp",
                           default_initializer=fluid.initializer.Constant(
                               3.0))
    i = L.fill_constant([1], "int64", 0)
    three = L.fill_constant([1], "int64", 3)
    acc = L.fill_constant([1], "float32", 0.0)
    cond_var = L.less_than(i, three)
    wh = L.While(cond_var)
    with wh.block():
        L.assign(L.elementwise_add(acc, w), output=acc)
        L.increment(i, value=1)
        L.less_than(i, three, cond=cond_var)
    return [{}], [acc]


def _branch_reads_outer_vars_in_while(fluid):
    """A cond nested in a while whose odd branch alone reads a parameter
    and a var of the enclosing block: both are state of the block."""
    L = fluid.layers
    bonus = L.create_parameter(
        [2], "float32", name="bonus",
        default_initializer=fluid.initializer.Constant(0.25))
    x = L.data("x", shape=[2], dtype="float32", append_batch_size=False)
    shift = L.scale(x, scale=0.5, bias=1.0)
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 5)
    acc = L.fill_constant([2], "float32", 0.0)
    cond_var = L.less_than(i, n)
    w = L.While(cond_var)
    with w.block():
        is_odd = L.equal(L.elementwise_mod(i, L.fill_constant(
            [1], "int64", 2)), L.fill_constant([1], "int64", 1))

        def odd():
            L.assign(L.elementwise_add(
                acc, L.elementwise_mul(bonus, shift)), output=acc)
            return L.fill_constant([1], "float32", 1.0)

        def even():
            L.assign(L.scale(acc, scale=2.0), output=acc)
            return L.fill_constant([1], "float32", 0.0)

        L.cond(is_odd, odd, even)
        L.increment(i, value=1)
        L.less_than(i, n, cond=cond_var)
    return [{"x": np.array([1.0, -3.0], "float32")}], [acc, i]


def _with_sgd(fluid, branch_out):
    """x -> h = x @ w -> a branch op -> mean -> SGD(0.1): the loss, w's
    gradient and the updated w."""
    L = fluid.layers
    x = L.data("x", shape=[2, 3], dtype="float32", append_batch_size=False)
    w = L.create_parameter([3, 3], "float32", name="w",
                           default_initializer=fluid.initializer.Uniform(
                               -1.0, 1.0, seed=3))
    h = L.matmul(x, w)
    loss = L.mean(branch_out(L, x, h))
    fluid.optimizer.SGD(0.1).minimize(loss)
    feeds = [{"x": np.arange(6, dtype="float32").reshape(2, 3) * s - 2.0}
             for s in (1.0, -1.0)]
    return feeds, [loss, "w@GRAD", "w"]


def _cond_reaches_loss(fluid):
    def branch_out(L, x, h):
        pred = L.greater_than(L.reduce_sum(x),
                              L.fill_constant([1], "float32", 0.0))
        return L.cond(pred, lambda: L.scale(h, scale=2.0),
                      lambda: L.elementwise_mul(h, h))
    return _with_sgd(fluid, branch_out)


def _switch_case_reaches_loss(fluid):
    def branch_out(L, x, h):
        idx = L.cast(L.greater_than(
            L.reduce_sum(x), L.fill_constant([1], "float32", 0.0)), "int64")
        return L.switch_case(idx, [lambda: L.elementwise_mul(h, h),
                                   lambda: L.tanh(h)])
    return _with_sgd(fluid, branch_out)


def _conditional_block(fluid):
    """A `conditional_block` op built by hand (no layer emits it): its
    block rebinds `acc` and makes `fresh`; skipped, `acc` keeps its value
    and `fresh` is zeros."""
    L = fluid.layers
    x = L.data("x", shape=[3], dtype="float32", append_batch_size=False)
    acc = L.scale(x, scale=1.0, bias=0.5)
    pred = L.greater_than(L.reduce_sum(x),
                          L.fill_constant([1], "float32", 0.0))
    prog = fluid.default_main_program()
    sub = prog._create_block()
    fresh = L.scale(x, scale=3.0)
    L.assign(L.elementwise_add(acc, fresh), output=acc)
    prog._rollback()
    prog.current_block().append_op(
        type="conditional_block", inputs={"Cond": [pred]}, outputs={},
        attrs={"sub_block": sub.idx, "out_names": [fresh.name]})
    feeds = [{"x": np.array([1.0, 2.0, -0.5], "float32")},
             {"x": np.array([-1.0, 2.0, -3.5], "float32")}]
    return feeds, [acc, fresh]


CASES = {
    "while_accumulates": _while_accumulates,
    "while_loop_functional": _while_loop_functional,
    "cond_both_branches": _cond_both_branches,
    "cond_multiple_returns": _cond_multiple_returns,
    "switch_case_with_default": _switch_case_with_default,
    "case_chain": _case_chain,
    "cond_inside_while_updates_loop_var":
        _cond_inside_while_updates_loop_var,
    "while_reads_param_state": _while_reads_param_state,
    "branch_reads_outer_vars_in_while": _branch_reads_outer_vars_in_while,
    "cond_reaches_loss": _cond_reaches_loss,
    "switch_case_reaches_loss": _switch_case_reaches_loss,
    "conditional_block": _conditional_block,
}


def _build(fluid, name):
    main, startup = _programs(fluid)
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        feeds, fetch = CASES[name](fluid)
    return main, startup, feeds, [getattr(f, "name", f) for f in fetch]


def _run_reference(name):
    main, startup, feeds, fetch = _build(rfluid, name)
    exe = rfluid.Executor(rfluid.CPUPlace())
    scope = RScope()
    exe.run(startup, scope=scope)
    state = {v.name: np.asarray(scope.find_var(v.name))
             for v in main.list_vars()
             if v.persistable and scope.find_var(v.name) is not None}
    outs = [[np.asarray(v) for v in exe.run(main, feed=f, fetch_list=fetch,
                                            scope=scope)] for f in feeds]
    return main, state, outs


def _run_port(name, state, device="cpu"):
    main, _, feeds, fetch = _build(tfluid, name)
    exe = tfluid.Executor(tfluid.CPUPlace() if device == "cpu" else None)
    scope = tfluid.Scope()
    load_numpy_state(scope, state, device)
    return main, [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
                  for f in feeds]


def _assert_same(got, want, what):
    assert got.shape == want.shape, what
    if np.issubdtype(want.dtype, np.floating):
        assert got.dtype == want.dtype, what
        np.testing.assert_allclose(got, want, rtol=FLOAT_TOL,
                                   atol=FLOAT_TOL, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fetches_match_reference(name):
    _, state, want = _run_reference(name)
    _, got = _run_port(name, state)
    assert len(got) == len(want)
    for run, (g_run, w_run) in enumerate(zip(got, want)):
        for k, (g, w) in enumerate(zip(g_run, w_run)):
            _assert_same(np.asarray(g), w, "%s run %d fetch %d"
                         % (name, run, k))


def test_reference_answers():
    """The port's own answers to the reference test file's cases."""
    def port(name):
        _, state, _ = _run_reference(name)
        return [[np.asarray(v).ravel().tolist() for v in run]
                for run in _run_port(name, state)[1]]

    assert port("while_accumulates") == [[[20.0], [10]]]
    assert port("while_loop_functional") == [[[120], [6]]]
    assert port("cond_both_branches") == [[[30.0]], [[-8.0]]]
    assert port("switch_case_with_default") == [[[1.0]], [[2.0]], [[99.0]]]
    assert port("case_chain") == [[[10.0]], [[20.0]], [[30.0]]]
    assert port("cond_inside_while_updates_loop_var") == [[[12.0], [6]]]
    assert port("while_reads_param_state") == [[[9.0]]]


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_analysis_matches_reference(name):
    """Scope state in and out of the global block, as the reference's
    analysis finds it: a var read only inside a branch or a loop body
    (nested or not) is state in."""
    r_main, _, r_feeds, r_fetch = _build(rfluid, name)
    t_main, _, t_feeds, t_fetch = _build(tfluid, name)
    want = rlowering.analyze_block(r_main.global_block(), list(r_feeds[0]),
                                   r_fetch)
    got = tlowering.analyze_block(t_main.global_block(), list(t_feeds[0]),
                                  t_fetch)
    assert got == want
    if name == "branch_reads_outer_vars_in_while":
        assert "bonus" in got[0]


def _while_into_loss(fluid):
    L = fluid.layers
    x = L.data("x", shape=[2, 3], dtype="float32", append_batch_size=False)
    w = L.create_parameter([3, 3], "float32", name="w",
                           default_initializer=fluid.initializer.Constant(
                               0.5))
    h = L.matmul(x, w)
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 3)
    c = L.less_than(i, n)
    loop = L.While(c)
    with loop.block():
        L.assign(L.scale(h, scale=0.5), output=h)
        L.increment(i)
        L.less_than(i, n, cond=c)
    loss = L.mean(h)
    fluid.optimizer.SGD(0.1).minimize(loss)
    return [{"x": np.ones((2, 3), "float32")}], [loss]


def test_while_into_loss_raises_as_reference():
    """lax.while_loop is not reverse-differentiable: the reference raises
    ValueError when the loss's gradient would flow back through a While;
    the port raises the same error type, never a silent zero."""
    errors = []
    for fluid, place, scope in ((rfluid, rfluid.CPUPlace(), RScope()),
                                (tfluid, tfluid.CPUPlace(), tfluid.Scope())):
        main, startup = _programs(fluid)
        with fluid.program_guard(main, startup), fluid.unique_name_guard():
            feeds, fetch = _while_into_loss(fluid)
        exe = fluid.Executor(place)
        exe.run(startup, scope=scope)
        with pytest.raises(ValueError) as e:
            exe.run(main, feed=feeds[0], fetch_list=fetch, scope=scope)
        errors.append(str(e.value))
    assert all("Reverse-mode differentiation does not work" in m
               for m in errors), errors


def test_each_iteration_draws_its_own_dropout(monkeypatch):
    """Dropout in a while body: every iteration's mask differs (the
    iteration is folded into the seed), and a second program with the
    same random_seed draws the same masks."""
    opdef = treg.get_op("dropout")
    compute = opdef.compute
    masks = []

    def spy(ins, attrs):
        outs = compute(ins, attrs)
        if outs["Mask"].device.type != "meta":  # not shape inference
            masks.append(outs["Mask"].clone())
        return outs

    monkeypatch.setattr(opdef, "compute", spy)

    def run():
        main, startup = _programs(tfluid)
        L = tfluid.layers
        with tfluid.program_guard(main, startup), \
                tfluid.unique_name_guard():
            x = L.fill_constant([64], "float32", 1.0)
            acc = L.fill_constant([64], "float32", 0.0)
            i = L.fill_constant([1], "int64", 0)
            n = L.fill_constant([1], "int64", 3)
            c = L.less_than(i, n)
            loop = L.While(c)
            with loop.block():
                L.assign(L.elementwise_add(acc, L.dropout(
                    x, 0.5, dropout_implementation="upscale_in_train")),
                    output=acc)
                L.increment(i)
                L.less_than(i, n, cond=c)
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        return exe.run(main, fetch_list=[acc], scope=scope)[0]

    first = run()
    assert len(masks) == 3
    for a in range(3):
        for b in range(a + 1, 3):
            assert not torch.equal(masks[a], masks[b])
    second = run()
    assert all(torch.equal(masks[k], masks[k + 3]) for k in range(3))
    np.testing.assert_array_equal(first, second)


def test_conditional_block_skip_path_makes_zeros():
    """On the skip path the conditional block's new output is zeros on
    the executor's device, in the dtype and shape its block would give."""
    _, state, want = _run_reference("conditional_block")
    _, got = _run_port("conditional_block", state)
    fresh = got[1][1]
    assert fresh.dtype == np.float32 and fresh.shape == (3,)
    assert not fresh.any() and want[1][1].shape == (3,)
