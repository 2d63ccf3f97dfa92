"""Gradient merge (`GradientMergeOptimizer`, k-step accumulation) in
the port (paddle_tpu_torch, on the CPU) against the JAX package's
(`paddle_tpu/fluid/lowering.py _run_gradient_merge`), mirroring
`tests/test_strategy_knobs.py:43`.

- The MLP of tests/test_strategy_knobs.py (16-32-4) under SGD (avg),
  Adam (summed) and LAMB with global-norm clipping, k = 3, 7 steps of
  different batches from the reference's startup state: every step's
  loss and every persistable (params, moments, the accumulators and the
  counter) after every step within fp32 rtol 1e-5 of the reference's;
  on the accumulating steps the port's params, moments and learning
  rate stay bit-equal to the step before.
- k averaged steps of one batch equal one plain step (within 1e-6).
- The graph path (the two steps of a window captured over one set of
  static buffers, run on the CPU through `graph_runner`) equal to eager
  bit for bit over 8 steps, across the accumulate/apply switch and
  across a `fluid.save` / `fluid.load` in the middle of a window (the
  host's mirror of the counter read again from the loaded scope); a
  counter set in the scope directly is read again too.
- float16 loss scaling under gradient merge warns and stays unscaled,
  as the reference's decorator does.
- Data parallelism over 2 gloo ranks (`tests/torch_dp_runner.py
  gm_ranks`, spawned at the module's first test), replicated and with
  the sharded update, against the reference's single-process run on the
  global batch (the averaged gradient of two halves is the whole
  batch's): losses and every persistable within 1e-5; the exchange
  (all-reduces, or the bucket reduce-scatters and all-gathers) runs on
  the applying steps only, once a window.
"""
import warnings

import numpy as np
import pytest

import paddle_tpu.fluid as rfluid
from paddle_tpu.core.scope import Scope as RScope

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import distributed
from paddle_tpu_torch.core.scope import dump_numpy_state, load_numpy_state
from paddle_tpu_torch.fluid import io as tio

import torch_dp_runner as runner

RTOL, ATOL, K, STEPS = 1e-5, 1e-6, 3, 7

OPTIMIZERS = {
    "sgd_avg": (lambda f: f.optimizer.SGDOptimizer(0.5), True),
    "adam_sum": (lambda f: f.optimizer.AdamOptimizer(0.01), False),
    "lamb_clip": (lambda f: f.optimizer.LambOptimizer(
        0.01, grad_clip=f.clip.GradientClipByGlobalNorm(0.5)), True),
}


@pytest.fixture(scope="module")
def dp_ranks(tmp_path_factory):
    """The 2-rank spawn, started at the module's first test: (dir,
    spawn context, reference start state)."""
    d = str(tmp_path_factory.mktemp("gm"))
    main, startup, _ = runner.build_gm_mlp(rfluid)
    exe, scope = rfluid.Executor(rfluid.CPUPlace()), RScope()
    exe.run(startup, scope=scope)
    state = {v.name: np.asarray(scope.find_var(v.name))
             for v in main.list_vars() if v.persistable}
    runner.save_state(d, "gm", state)
    ctx = distributed.spawn(runner.gm_ranks, (d,), nprocs=2,
                            backend="gloo", join=False)
    yield d, ctx, state
    ctx.join(1)


@pytest.fixture(autouse=True)
def _start_ranks(dp_ranks):
    return dp_ranks


def _mlp(fluid, name, k=K):
    opt_fn, avg = OPTIMIZERS[name]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=32, act="relu")
        logits = fluid.layers.fc(input=h, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        opt = opt_fn(fluid)
        if k > 1:
            opt = fluid.optimizer.GradientMergeOptimizer(opt, k_steps=k,
                                                         avg=avg)
        opt.minimize(loss)
    return main, startup, loss


def _feeds(n=STEPS, same=False):
    r = np.random.RandomState(1)
    feeds = []
    for _ in range(n):
        if not same or not feeds:
            feeds.append({"x": r.rand(16, 16).astype("float32"),
                          "label": r.randint(0, 4, (16, 1)).astype(
                              "int64")})
        else:
            feeds.append(feeds[0])
    return feeds


def _persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _states_by_step(exe, main, scope, loss, feeds, fetch=np.asarray):
    names = _persistables(main)
    losses, states = [], []
    for f in feeds:
        losses.append(float(np.asarray(exe.run(
            main, feed=f, fetch_list=[loss], scope=scope)[0]).ravel()[0]))
        states.append({n: fetch(scope.find_var(n)).copy() for n in names})
    return losses, states


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_gradient_merge_matches_reference(name):
    feeds = _feeds()
    rmain, rstartup, rloss = _mlp(rfluid, name)
    rexe, rscope = rfluid.Executor(rfluid.CPUPlace()), RScope()
    rexe.run(rstartup, scope=rscope)
    start = {n: np.asarray(rscope.find_var(n))
             for n in _persistables(rmain)}
    r_losses, r_states = _states_by_step(rexe, rmain, rscope, rloss, feeds)

    main, _, loss = _mlp(tfluid, name)
    assert [op.type for op in main.global_block().ops] == \
        [op.type for op in rmain.global_block().ops]
    assert _persistables(main) == sorted(start)
    gm = next(op for op in main.global_block().ops
              if op.type == "backward").attrs["gradient_merge"]
    assert gm["k_steps"] == K and gm["avg"] == OPTIMIZERS[name][1]
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    load_numpy_state(scope, start, "cpu")
    losses, states = _states_by_step(exe, main, scope, loss, feeds,
                                     lambda t: t.numpy())
    np.testing.assert_allclose(losses, r_losses, rtol=RTOL)
    accs = set(gm["acc_map"].values()) | {gm["counter"]}
    prev = start
    for step, (got, want) in enumerate(zip(states, r_states)):
        for n, w in want.items():
            np.testing.assert_allclose(got[n], w, rtol=RTOL, atol=ATOL,
                                       err_msg="%s step %d" % (n, step))
        if (step + 1) % K:
            # an accumulating step: only the window's state moves
            for n, v in got.items():
                if n not in accs:
                    np.testing.assert_array_equal(v, prev[n], err_msg=n)
        prev = got
    assert int(states[-1][gm["counter"]].ravel()[0]) == STEPS % K


def test_merged_window_equals_one_step():
    """k averaged steps of one batch: the params after the k-th equal a
    plain program's after its first step."""
    feeds = _feeds(K, same=True)
    main, startup, loss = _mlp(tfluid, "sgd_avg")
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    p0 = scope.find_var("fc_0.w_0").clone()
    _states_by_step(exe, main, scope, loss, feeds, lambda t: t.numpy())
    plain, pstartup, ploss = _mlp(tfluid, "sgd_avg", k=1)
    pscope = tfluid.Scope()
    exe.run(pstartup, scope=pscope)
    assert (pscope.find_var("fc_0.w_0") == p0).all()
    exe.run(plain, feed=feeds[0], fetch_list=[ploss], scope=pscope)
    for n in ("fc_0.w_0", "fc_0.b_0", "fc_1.w_0", "fc_1.b_0"):
        np.testing.assert_allclose(scope.find_var(n).numpy(),
                                   pscope.find_var(n).numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=n)


def _runner(body):
    return body()


def test_graph_path_equals_eager_across_switch_and_load(tmp_path):
    """8 steps (k = 4, two applies) through the graph path and eagerly
    from one start, bit for bit; then a `fluid.load` of the state saved
    after step 6 (a window's second step) repeats steps 7-8."""
    feeds = _feeds(8)
    main, startup, loss = _mlp(tfluid, "adam_sum", k=4)
    exe0, scope0 = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe0.run(startup, scope=scope0)
    start = dump_numpy_state(scope0, _persistables(main))
    runs = {}
    for graphs in (False, True):
        exe = tfluid.Executor(tfluid.CPUPlace(),
                              graph_runner=_runner if graphs else None)
        scope = tfluid.Scope()
        load_numpy_state(scope, start, "cpu")
        with tfluid.scope_guard(scope):
            out = _states_by_step(exe, main, scope, loss, feeds[:6],
                                  lambda t: t.numpy())
            path = str(tmp_path / ("g" if graphs else "e") / "model")
            tio.save(main, path)
            tail = _states_by_step(exe, main, scope, loss, feeds[6:],
                                   lambda t: t.numpy())
            tio.load(main, path, exe)
            again = _states_by_step(exe, main, scope, loss, feeds[6:],
                                    lambda t: t.numpy())
        info = exe.last_entry.info()
        runs[graphs] = (out[0] + tail[0], out[1] + tail[1], again, info)
    assert runs[True][3]["mode"] == "graph"
    assert [s["phase"] for s in runs[True][3]["gradient_merge"][
        "steps"]] == ["captured", "captured"]
    assert runs[True][0] == runs[False][0]
    for g, e in zip(runs[True][1], runs[False][1]):
        for n, v in e.items():
            np.testing.assert_array_equal(g[n], v, err_msg=n)
    for graphs in (False, True):
        assert runs[graphs][2][0] == runs[graphs][0][6:]
        for g, e in zip(runs[graphs][2][1], runs[graphs][1][6:]):
            for n, v in e.items():
                np.testing.assert_array_equal(g[n], v, err_msg=n)


def test_counter_set_in_scope_is_read_again():
    """A counter rebound in the scope (k - 1: the next step applies)
    moves the host's choice with it."""
    feeds = _feeds(2)
    main, startup, loss = _mlp(tfluid, "sgd_avg")
    gm = next(op for op in main.global_block().ops
              if op.type == "backward").attrs["gradient_merge"]
    exe = tfluid.Executor(tfluid.CPUPlace(), graph_runner=_runner)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    w = scope.find_var("fc_0.w_0").clone()
    counter = scope.find_var(gm["counter"])
    scope.set_var(gm["counter"], counter.new_full(counter.shape, K - 1))
    exe.run(main, feed=feeds[1], fetch_list=[loss], scope=scope)
    assert not (scope.find_var("fc_0.w_0") == w).all()
    assert int(scope.find_var(gm["counter"]).reshape(-1)[0]) == 0


def test_fp16_loss_scaling_under_gradient_merge_warns():
    from paddle_tpu_torch.fluid.contrib import mixed_precision

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name_guard():
        x = tfluid.layers.data(name="x", shape=[16], dtype="float32")
        loss = tfluid.layers.mean(tfluid.layers.fc(input=x, size=4))
        opt = mixed_precision.decorate(
            tfluid.optimizer.GradientMergeOptimizer(
                tfluid.optimizer.SGDOptimizer(0.1), k_steps=2),
            amp_dtype="float16")
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            opt.minimize(loss)
    assert any("UNSCALED" in str(m.message) for m in w)
    bop = next(op for op in main.global_block().ops
               if op.type == "backward")
    assert "dynamic_loss_scaling" not in bop.attrs


def test_data_parallel_exchange_once_per_k(dp_ranks):
    d, ctx, state = dp_ranks
    main, _, loss = runner.build_gm_mlp(rfluid)
    exe, scope = rfluid.Executor(rfluid.CPUPlace()), RScope()
    for n, v in state.items():
        scope.set_var(n, v)
    feeds = runner.gm_feeds()
    r_losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                         scope=scope)[0]).ravel()[0])
                for f in feeds]
    want = {n: np.asarray(scope.find_var(n)) for n in state}
    ctx.join(240)
    ranks = runner.results(d, "gm")
    applies = [(i + 1) % runner.GM_K == 0
               for i in range(runner.GM_STEPS)]
    for variant in runner.GM_VARIANTS:
        key = variant + "."
        for res in ranks:
            # a loss a rank: the mean of the two is the global batch's
            np.testing.assert_allclose(
                res[key + "losses"].reshape(runner.GM_STEPS, -1).mean(1),
                r_losses, rtol=RTOL)
            for n, w in want.items():
                np.testing.assert_allclose(res[key + "state." + n], w,
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=key + n)
            calls = res[key + "calls"]
            for step, apply in enumerate(applies):
                row = dict(zip(runner.GM_EXCHANGE_KINDS, calls[step]))
                if not apply:
                    assert not any(row.values()), (variant, step, row)
                elif variant == "replicated":
                    assert row["all_reduce"] == 4, (step, row)
                else:
                    assert row["zero.reduce_scatter"] >= 1 \
                        and row["zero.all_gather"] >= 1, (step, row)
        assert (int(ranks[0][key + "sharded"]) > 0) == (variant == "zero")
