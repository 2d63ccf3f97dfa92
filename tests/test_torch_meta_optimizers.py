"""The rest of the fluid optimizers and fleet's recompute and gradient
merge knobs in the port (paddle_tpu_torch, on the CPU) against the JAX
package, mirroring `tests/test_strategy_knobs.py:79,171` and
`tests/test_ema_model_average.py:31-124`.

- `LookaheadOptimizer` (alpha 0.5, k 2 and 5) over SGD: the slow weights
  start as the params; 6 steps from the reference's startup state,
  every persistable (params, slow weights, the counter) within fp32
  rtol 1e-5 of the reference's after every step.
- `ExponentialMovingAverage` (decay 0.5) and `ModelAverage` (a window
  that never fills, one that rotates, four rotations) over SGD: the
  programs equal op by op; after the steps, `apply()` gives the
  reference's applied params within 1e-5 (computed on the device, not
  through numpy); `restore()` gives back the live params bit for bit in
  the same tensor objects (the values swap in place).
- Replays after `restore()` train the live parameters: through the graph
  path (the captured step's static buffers are the scope's tensors),
  steps, an `apply()`/`restore()`, and more steps equal the same steps
  without the swap, bit for bit.
- `DGCMomentumOptimizer`'s local half (ramp-up at step 2): the same
  ops, `program._dgc_cfg`, and 5 steps within 1e-5.
- fleet's `recompute`, `gradient_merge` and `lamb` knobs at one worker:
  the wrappers applied in the reference's order, the same program op
  by op (checkpoints and the gradient-merge attr on the backward op),
  and 6 steps within 1e-5; `PipelineOptimizer` and the pipeline knob
  raise, naming ROADMAP Queue 1 #10.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rfluid
from paddle_tpu import fleet as rfleet
from paddle_tpu.core.scope import Scope as RScope
from paddle_tpu.fleet import meta_optimizers as rmeta

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import fleet as tfleet
from paddle_tpu_torch.core.scope import load_numpy_state

RTOL, ATOL = 1e-5, 1e-6


def _runner(body):
    return body()


def _persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _mlp(fluid, wrap=None, seed=7):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=32, act="relu")
        logits = fluid.layers.fc(input=h, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        opt = fluid.optimizer.SGDOptimizer(learning_rate=0.5)
        (wrap or (lambda f, o, l: o.minimize(l)))(fluid, opt, loss)
    return main, startup, loss


def _feeds(n):
    r = np.random.RandomState(1)
    return [{"x": r.rand(16, 16).astype("float32"),
             "label": r.randint(0, 4, (16, 1)).astype("int64")}
            for _ in range(n)]


def _reference_steps(main, startup, loss, feeds):
    """(start state, losses, the persistables after each step)."""
    exe, scope = rfluid.Executor(rfluid.CPUPlace()), RScope()
    exe.run(startup, scope=scope)
    names = _persistables(main)
    start = {n: np.asarray(scope.find_var(n)) for n in names}
    losses, states = [], []
    for f in feeds:
        losses.append(float(np.asarray(exe.run(
            main, feed=f, fetch_list=[loss], scope=scope)[0]).ravel()[0]))
        states.append({n: np.asarray(scope.find_var(n)) for n in names})
    return start, losses, states


def _port_steps(main, loss, start, feeds, exe=None, scope=None):
    exe = exe or tfluid.Executor(tfluid.CPUPlace())
    scope = scope or tfluid.Scope()
    if start is not None:
        load_numpy_state(scope, start, "cpu")
    names = _persistables(main)
    losses, states = [], []
    for f in feeds:
        losses.append(float(exe.run(main, feed=f, fetch_list=[loss],
                                    scope=scope)[0].reshape(-1)[0]))
        states.append({n: scope.find_var(n).numpy().copy() for n in names})
    return losses, states


def _match(rmain, tmain, r, t):
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in rmain.global_block().ops]
    np.testing.assert_allclose(t[0], r[0], rtol=RTOL)
    for step, (got, want) in enumerate(zip(t[1], r[1])):
        assert sorted(got) == sorted(want)
        for n, w in want.items():
            np.testing.assert_allclose(got[n], w, rtol=RTOL, atol=ATOL,
                                       err_msg="%s step %d" % (n, step))


@pytest.mark.parametrize("k", [2, 5])
def test_lookahead_matches_reference(k):
    def wrap(fluid, opt, loss):
        fluid.optimizer.LookaheadOptimizer(opt, alpha=0.5, k=k).minimize(
            loss)

    feeds = _feeds(6)
    rmain, rstartup, rloss = _mlp(rfluid, wrap)
    start, r_losses, r_states = _reference_steps(rmain, rstartup, rloss,
                                                 feeds)
    slow = [n for n in start if "@SLOW" in n]
    assert len(slow) == 4
    for n in slow:
        np.testing.assert_array_equal(start[n], start[n.split("@SLOW")[0]])
    tmain, tstartup, tloss = _mlp(tfluid, wrap)
    # the port's startup assigns the slow weights from the params too
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(tstartup, scope=scope)
    for n in slow:
        assert torch.equal(scope.find_var(n), scope.find_var(
            n.split("@SLOW")[0]))
    _match(rmain, tmain, (r_losses, r_states),
           _port_steps(tmain, tloss, start, feeds))


def _ema_wrap(holder, decay=0.5):
    def wrap(fluid, opt, loss):
        opt.minimize(loss)
        ema = fluid.optimizer.ExponentialMovingAverage(decay)
        ema.update()
        holder[fluid] = ema
    return wrap


def _ma_wrap(holder, max_window):
    def wrap(fluid, opt, loss):
        opt.minimize(loss)
        holder[fluid] = fluid.optimizer.ModelAverage(
            0.15, min_average_window=1, max_average_window=max_window)
    return wrap


#: name -> (holder -> wrap, steps)
AVERAGES = {
    "ema": (_ema_wrap, 4),
    "model_average_window": (lambda h: _ma_wrap(h, 100), 5),
    "model_average_rotation": (lambda h: _ma_wrap(h, 3), 7),
    "model_average_four_rotations": (lambda h: _ma_wrap(h, 3), 10),
}


@pytest.mark.parametrize("name", sorted(AVERAGES))
def test_average_apply_restore_matches_reference(name):
    make, steps = AVERAGES[name]
    holder = {}
    feeds = _feeds(steps)
    rmain, rstartup, rloss = _mlp(rfluid, make(holder))
    exe, rscope = rfluid.Executor(rfluid.CPUPlace()), RScope()
    params = ["fc_0.w_0", "fc_0.b_0", "fc_1.w_0", "fc_1.b_0"]
    with rfluid.scope_guard(rscope):
        exe.run(rstartup)
        start = {n: np.asarray(rscope.find_var(n))
                 for n in _persistables(rmain)}
        for f in feeds:
            exe.run(rmain, feed=f, fetch_list=[rloss])
        with holder[rfluid].apply(exe):
            want = {n: np.asarray(rscope.find_var(n)) for n in params}
    tmain, _, tloss = _mlp(tfluid, make(holder))
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in rmain.global_block().ops]
    texe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(scope):
        _port_steps(tmain, tloss, start, feeds, texe, scope)
        live = {n: scope.find_var(n) for n in params}
        before = {n: v.clone() for n, v in live.items()}
        with holder[tfluid].apply(texe):
            for n in params:
                assert scope.find_var(n) is live[n]
                np.testing.assert_allclose(live[n].numpy(), want[n],
                                           rtol=RTOL, atol=ATOL, err_msg=n)
        for n in params:
            assert scope.find_var(n) is live[n]
            assert torch.equal(live[n], before[n]), n


@pytest.mark.parametrize("name", ["ema", "model_average_rotation"])
def test_replays_after_restore_train_the_live_params(name):
    """Graph path: 4 steps, apply()/restore(), 3 more steps equal 7
    steps without the swap, bit for bit; the scope keeps the captured
    step's buffers throughout."""
    make, _ = AVERAGES[name]
    feeds = _feeds(7)
    runs = []
    for swap in (False, True):
        holder = {}
        main, startup, loss = _mlp(tfluid, make(holder))
        exe = tfluid.Executor(tfluid.CPUPlace(), graph_runner=_runner)
        scope = tfluid.Scope()
        with tfluid.scope_guard(scope):
            exe.run(startup)
            first = _port_steps(main, loss, None, feeds[:4], exe, scope)
            bufs = {n: scope.find_var(n) for n in _persistables(main)}
            if swap:
                with holder[tfluid].apply(exe):
                    pass
                assert all(scope.find_var(n) is v for n, v in bufs.items())
            rest = _port_steps(main, loss, None, feeds[4:], exe, scope)
            assert exe.last_entry.phase == "captured"
            assert all(scope.find_var(n) is v for n, v in bufs.items())
        runs.append((first[0] + rest[0], rest[1][-1]))
    assert runs[0][0] == runs[1][0]
    for n, v in runs[0][1].items():
        np.testing.assert_array_equal(runs[1][1][n], v, err_msg=n)


def test_dgc_momentum_local_matches_reference():
    def wrap(fluid, opt, loss):
        fluid.optimizer.DGCMomentumOptimizer(
            learning_rate=0.3, momentum=0.9, rampup_begin_step=2,
            sparsity=[0.5, 0.8]).minimize(loss)

    feeds = _feeds(5)
    rmain, rstartup, rloss = _mlp(rfluid, wrap)
    r = _reference_steps(rmain, rstartup, rloss, feeds)
    tmain, _, tloss = _mlp(tfluid, wrap)
    assert tmain._dgc_cfg == rmain._dgc_cfg == {
        "momentum": 0.9, "sparsity": 0.8, "rampup_begin_step": 2.0}
    assert [op.type for op in tmain.global_block().ops].count(
        "dgc_momentum") == 4
    _match(rmain, tmain, r[1:], _port_steps(tmain, tloss, r[0], feeds))


def _strategy(fleet, checkpoints):
    st = fleet.DistributedStrategy()
    st.recompute = True
    st.recompute_configs = {"checkpoints": checkpoints}
    st.gradient_merge = True
    st.gradient_merge_configs = {"k_steps": 3, "avg": True}
    st.lamb = True
    return st


def _fleet_mlp(fluid, fleet, reference):
    """The MLP with a checkpoint at its hidden layer, Adam(0.01) under
    fleet's recompute, gradient_merge (k 3) and lamb knobs: the port
    through `distributed_optimizer` at one worker, the reference through
    its meta-optimizer composition (its fleet would transpile for the
    test process's virtual devices)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=32, act="relu")
        logits = fluid.layers.fc(input=h, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        st = _strategy(fleet, [h.name])
        opt = fluid.optimizer.AdamOptimizer(0.01)
        if reference:
            inner, applied = rmeta.compose(st, opt)
            inner.minimize(loss)
        else:
            dopt = fleet.distributed_optimizer(opt, st)
            dopt.minimize(loss)
            applied = dopt._applied_meta_list
    return main, startup, loss, applied


def test_fleet_recompute_and_gradient_merge_knobs(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    feeds = _feeds(6)
    rmain, rstartup, rloss, rapplied = _fleet_mlp(rfluid, rfleet, True)
    tmain, _, tloss, tapplied = _fleet_mlp(tfluid, tfleet, False)
    assert tapplied == rapplied == ["lamb", "recompute", "gradient_merge"]
    rb, tb = (next(op for op in m.global_block().ops
                   if op.type == "backward") for m in (rmain, tmain))
    assert tb.attrs["checkpoints"] == rb.attrs["checkpoints"] == ["fc_0.tmp_2"]
    assert tb.attrs["gradient_merge"] == rb.attrs["gradient_merge"]
    assert "lamb" in [op.type for op in tmain.global_block().ops]
    r = _reference_steps(rmain, rstartup, rloss, feeds)
    _match(rmain, tmain, r[1:], _port_steps(tmain, tloss, r[0], feeds))


def test_pipeline_raises_naming_the_queue():
    with pytest.raises(NotImplementedError, match="Queue 1 #10"):
        tfluid.optimizer.PipelineOptimizer(
            tfluid.optimizer.SGDOptimizer(0.1), num_microbatches=2)
    st = tfleet.DistributedStrategy()
    st.pipeline = True

    def wrap(fluid, opt, loss):
        tfleet.distributed_optimizer(opt, st).minimize(loss)

    with pytest.raises(NotImplementedError, match="Queue 1 #10"):
        _mlp(tfluid, wrap)
