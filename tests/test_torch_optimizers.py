"""The optimizers of `fluid/optimizer.py:376-718`, gradient clipping
(`fluid/clip.py`), the new `fluid.layers` functions and `fluid.load`
with a `var_list`, each against the JAX package on the CPU.

Each optimizer case builds one program in both packages: an MLP whose
first `fc` takes two inputs (one weight each, summed by the `sum` op),
the optimizer's `minimize`, and for the clip cases a clip attr (an
optimizer's `grad_clip`, `set_gradient_clip`'s default, or a param's
`gradient_clip_attr`). The reference's startup state goes into the
port's scope (`load_numpy_state`); both run 3 steps on the same batch.
Losses and every persistable after the steps agree within float32 rtol
1e-5 (atol 1e-6), and the two programs hold the same ops in the same
order. `DpsgdOptimizer` runs with sigma 0: its noise comes from another
stream in each package (tests/test_torch_math_ops.py holds it by its
moments).

The layers case builds every new `fluid.layers` function of the slice
over fed inputs in both packages and compares the fetches (rtol 1e-5).
`fluid.load` (counterpart of the reference's `io.py:183 load`): the
reference saves, each package loads with a `var_list` of one var, and
both scopes then hold every key of both files, value for value; a
`load_program_state` with the same subset keeps honouring it.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rfluid
from paddle_tpu.core.scope import Scope as RScope
from paddle_tpu.fluid import io as rio

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.scope import load_numpy_state
from paddle_tpu_torch.fluid import io as tio

RTOL, ATOL, STEPS = 1e-5, 1e-6, 3

#: name -> fn(fluid) -> optimizer
OPTIMIZERS = {
    "lars_momentum": lambda f: f.optimizer.LarsMomentumOptimizer(
        0.1, momentum=0.9, lars_coeff=0.01, lars_weight_decay=0.001),
    "adamw": lambda f: f.optimizer.AdamWOptimizer(0.01, weight_decay=0.05),
    "lamb": lambda f: f.optimizer.LambOptimizer(
        0.01, lamb_weight_decay=0.01,
        exclude_from_weight_decay_fn=lambda p: ".b" in p.name),
    "adamax": lambda f: f.optimizer.AdamaxOptimizer(0.01),
    "adagrad": lambda f: f.optimizer.AdagradOptimizer(
        0.05, initial_accumulator_value=0.1),
    "decayed_adagrad": lambda f: f.optimizer.DecayedAdagradOptimizer(
        0.05, decay=0.9),
    "adadelta": lambda f: f.optimizer.AdadeltaOptimizer(1.0, rho=0.9),
    "rmsprop": lambda f: f.optimizer.RMSPropOptimizer(0.01, momentum=0.5),
    "rmsprop_centered": lambda f: f.optimizer.RMSPropOptimizer(
        0.01, centered=True),
    "ftrl": lambda f: f.optimizer.FtrlOptimizer(0.05, l1=0.01, l2=0.01),
    "dpsgd": lambda f: f.optimizer.DpsgdOptimizer(
        0.1, clip=0.5, batch_size=8.0, sigma=0.0),
    "clip_by_value": lambda f: f.optimizer.SGDOptimizer(
        0.5, grad_clip=f.clip.GradientClipByValue(0.05)),
    "clip_by_norm": lambda f: f.optimizer.MomentumOptimizer(
        0.5, momentum=0.9, grad_clip=f.clip.GradientClipByNorm(0.1)),
    "clip_by_global_norm": lambda f: f.optimizer.AdamOptimizer(
        0.01, grad_clip=f.clip.GradientClipByGlobalNorm(0.2)),
    "clip_default": lambda f: f.optimizer.SGDOptimizer(0.5),
}


def _batch():
    r = np.random.RandomState(0)
    return {"a": r.rand(8, 12).astype("float32"),
            "b": r.rand(8, 6).astype("float32"),
            "label": r.randint(0, 4, (8, 1)).astype("int64")}


def _build(fluid, name):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        a = fluid.layers.data(name="a", shape=[12], dtype="float32")
        b = fluid.layers.data(name="b", shape=[6], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=[a, b], size=16, act="tanh")
        logits = fluid.layers.fc(input=h, size=4)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            logits, label))
        if name == "clip_default":
            fluid.clip.set_gradient_clip(
                fluid.clip.GradientClipByGlobalNorm(0.1))
        try:
            OPTIMIZERS[name](fluid).minimize(loss)
        finally:
            fluid.clip._clip_attr.clear()
    return main, startup, loss


def _persistables(program):
    return sorted(v.name for v in program.list_vars() if v.persistable)


def _run_reference(name, feed):
    main, startup, loss = _build(rfluid, name)
    exe = rfluid.Executor(rfluid.CPUPlace())
    scope = RScope()
    names = _persistables(main)
    with rfluid.scope_guard(scope):
        exe.run(startup)
        start = {n: np.asarray(scope.find_var(n)) for n in names}
        losses = [float(np.asarray(exe.run(main, feed=feed,
                                           fetch_list=[loss])[0]).ravel()[0])
                  for _ in range(STEPS)]
        end = {n: np.asarray(scope.find_var(n)) for n in names}
    return main, start, losses, end


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(name):
    feed = _batch()
    rmain, start, r_losses, r_end = _run_reference(name, feed)
    main, startup, loss = _build(tfluid, name)
    assert [op.type for op in main.global_block().ops] == \
        [op.type for op in rmain.global_block().ops]
    assert _persistables(main) == sorted(start)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    load_numpy_state(scope, start, "cpu")
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0].reshape(-1)[0])
              for _ in range(STEPS)]
    np.testing.assert_allclose(losses, r_losses, rtol=RTOL)
    for n, want in r_end.items():
        got = scope.find_var(n).detach().float().numpy()
        np.testing.assert_allclose(got, want.astype(np.float32), rtol=RTOL,
                                   atol=ATOL, err_msg=n)


def test_per_param_clip_attr_matches_reference():
    """A param's `gradient_clip_attr` clips that param's gradient only
    (the optimizer has no `grad_clip` and no default is set)."""
    feed = _batch()

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 7
        with fluid.program_guard(main, startup), fluid.unique_name_guard():
            a = fluid.layers.data(name="a", shape=[12], dtype="float32")
            label = fluid.layers.data(name="label", shape=[1],
                                      dtype="int64")
            logits = fluid.layers.fc(input=a, size=4, param_attr="w0")
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(logits, label))
            main.global_block().var("w0").gradient_clip_attr = \
                fluid.clip.GradientClipByValue(0.01)
            fluid.optimizer.SGDOptimizer(1.0).minimize(loss)
        return main, startup, loss

    rmain, rstart, rloss = build(rfluid)
    exe, scope = rfluid.Executor(rfluid.CPUPlace()), RScope()
    with rfluid.scope_guard(scope):
        exe.run(rstart)
        start = {n: np.asarray(scope.find_var(n))
                 for n in _persistables(rmain)}
        exe.run(rmain, feed=feed, fetch_list=[rloss])
        want = {n: np.asarray(scope.find_var(n)) for n in start}
    main, _, loss = build(tfluid)
    assert [op.type for op in main.global_block().ops].count("clip") == 1
    tscope = tfluid.Scope()
    load_numpy_state(tscope, start, "cpu")
    tfluid.Executor(tfluid.CPUPlace()).run(main, feed=feed,
                                          fetch_list=[loss], scope=tscope)
    for n, v in want.items():
        np.testing.assert_allclose(tscope.find_var(n).numpy(), v,
                                   rtol=RTOL, atol=ATOL, err_msg=n)


def _layers_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        pos = fluid.layers.data(name="pos", shape=[6], dtype="float32")
        L = fluid.layers
        outs = [L.sqrt(pos), L.square(x), L.log(pos), L.abs(x), L.ceil(x),
                L.round(x), L.reciprocal(pos), L.leaky_relu(x, alpha=0.1),
                L.elu(x, alpha=0.5), L.relu6(x, threshold=1.0),
                L.softplus(x), L.softsign(x), L.swish(x, beta=2.0),
                L.hard_sigmoid(x, slope=0.3, offset=0.4),
                L.hard_swish(x), L.logsigmoid(x), L.erf(x), L.sin(x),
                L.maximum(x, pos), L.minimum(x, pos),
                L.reduce_mean(x, dim=1), L.reduce_max(x, dim=[0, 1]),
                L.reduce_min(x, dim=0, keep_dim=True), L.reduce_prod(pos),
                L.reduce_all(L.greater_than(pos, x)),
                L.reduce_any(L.less_than(pos, x), dim=1),
                L.clip(x, -0.3, 0.4), L.clip_by_norm(x, 1.0),
                L.l2_normalize(x, axis=1)]
    return main, outs


def test_layers_match_reference():
    r = np.random.RandomState(2)
    feed = {"x": r.randn(5, 6).astype("float32"),
            "pos": r.uniform(0.2, 2.0, (5, 6)).astype("float32")}
    rmain, routs = _layers_program(rfluid)
    tmain, touts = _layers_program(tfluid)
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in rmain.global_block().ops]
    with rfluid.scope_guard(RScope()):
        want = rfluid.Executor(rfluid.CPUPlace()).run(
            rmain, feed=feed, fetch_list=routs)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=feed, fetch_list=touts, scope=tfluid.Scope())
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        g = np.asarray(g)
        assert g.shape == w.shape, i
        if w.dtype == np.bool_:
            np.testing.assert_array_equal(g, w, err_msg=str(i))
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=str(i))


def test_load_with_var_list_sets_every_key(tmp_path):
    """`fluid.load` sets every key of `.pdparams` and `.pdopt` whatever
    `var_list` says, in both packages; `load_program_state` keeps
    honouring `var_list` in both."""
    feed = _batch()
    rmain, rstartup, rloss = _build(rfluid, "adamw")
    rexe, rscope = rfluid.Executor(rfluid.CPUPlace()), RScope()
    path = str(tmp_path / "model")
    with rfluid.scope_guard(rscope):
        rexe.run(rstartup)
        rexe.run(rmain, feed=feed, fetch_list=[rloss])
        rio.save(rmain, path)
    saved = {}
    for suffix in (".pdparams", ".pdopt"):
        assert os.path.exists(path + suffix)
        saved.update(tio._load_pickle(path + suffix))
    one = [rmain.global_block().var("fc_1.b_0")]
    loaded = RScope()
    with rfluid.scope_guard(loaded):
        rio.load(rmain, path, rexe, var_list=one)
    tmain, _, _ = _build(tfluid, "adamw")
    tloaded = tfluid.Scope()
    with tfluid.scope_guard(tloaded):
        tio.load(tmain, path, tfluid.Executor(tfluid.CPUPlace()),
                 var_list=[tmain.global_block().var("fc_1.b_0")])
    assert len(saved) > 2
    assert sorted(tloaded.local_var_names()) == \
        sorted(loaded.local_var_names()) == sorted(saved)
    for k in saved:
        np.testing.assert_array_equal(tloaded.find_var(k).numpy(),
                                      np.asarray(loaded.find_var(k)),
                                      err_msg=k)
    r_state = rio.load_program_state(path, var_list=one)
    t_state = tio.load_program_state(
        path, var_list=[tmain.global_block().var("fc_1.b_0")])
    assert sorted(r_state) == sorted(t_state) == ["fc_1.b_0"]
    assert torch.equal(torch.as_tensor(t_state["fc_1.b_0"]),
                       torch.as_tensor(np.asarray(r_state["fc_1.b_0"])))
