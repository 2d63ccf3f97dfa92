"""The port's fluid static graph (paddle_tpu_torch.fluid, on the CPU)
against the JAX package's (`paddle_tpu.fluid`), end to end on the MNIST
MLP of `tests/test_mnist_mlp.py` at its widths (784-128-64-10, batch 64).

Both packages build the same program in fresh default programs; the
reference's startup program runs, and every persistable is carried into
the port's scope with `load_numpy_state`. Then both take the same numpy
batches: per-step losses within rtol 1e-5 (float32 on both sides, another
summation order), accuracy, Correct and Total exactly, with the
reference's dtypes and shapes. Then the port's own contracts: both cases
of `tests/test_mnist_mlp.py` from the port's own startup, no silent CPU
fallback, the prepared-block cache and an evaluation clone."""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rfluid
from paddle_tpu.core import scope as rscope

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core import scope as tscope

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7
BATCH = 64
ACC_NAMES = ["accuracy_0.tmp_1", "accuracy_0.tmp_2"]  # Correct, Total


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    """Fresh default programs, scope and unique names for the port (the
    reference's come from tests/conftest.py)."""
    fw = tfluid.framework
    old_main = fw.switch_main_program(fw.Program())
    old_startup = fw.switch_startup_program(fw.Program())
    old_scope = tscope._global_scope
    tscope._global_scope = tscope.Scope()
    with fw.unique_name_guard():
        yield
    fw.switch_main_program(old_main)
    fw.switch_startup_program(old_startup)
    tscope._global_scope = old_scope


def _synthetic_mnist(rng, n=512):
    # the data of tests/test_mnist_mlp.py: separable, so the loss drops
    x = rng.rand(n, 784).astype("float32") * 0.1
    y = rng.randint(0, 10, size=(n, 1)).astype("int64")
    for i in range(n):
        x[i, y[i, 0] * 78:(y[i, 0] + 1) * 78] += 1.0
    return x, y


def build_mlp(fluid):
    img = fluid.layers.data(name="img", shape=[784], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    h = fluid.layers.fc(input=img, size=128, act="relu")
    h = fluid.layers.fc(input=h, size=64, act="relu")
    logits = fluid.layers.fc(input=h, size=10, act=None)
    loss = fluid.layers.softmax_with_cross_entropy(logits, label)
    avg_loss = fluid.layers.mean(loss)
    acc = fluid.layers.accuracy(input=fluid.layers.softmax(logits),
                                label=label)
    return avg_loss, acc


def _optimizer(fluid, kind):
    if kind == "sgd":
        return fluid.optimizer.SGDOptimizer(learning_rate=0.5)
    return fluid.optimizer.AdamOptimizer(learning_rate=1e-3)


def _transplant():
    """The reference's persistables after its startup, into the port's
    scope on the CPU; returns their names."""
    rexe = rfluid.Executor(rfluid.CPUPlace())
    rexe.run(rfluid.default_startup_program())
    names = sorted(v.name for v in rfluid.default_main_program().list_vars()
                   if v.persistable)
    tnames = sorted(v.name for v in tfluid.default_main_program().list_vars()
                    if v.persistable)
    assert names == tnames
    state = {n: np.asarray(rscope.global_scope().find_var(n))
             for n in names}
    tscope.load_numpy_state(tscope.global_scope(), state, "cpu")
    return rexe, tfluid.Executor(tfluid.CPUPlace()), names


def _batches(rng, steps):
    x, y = _synthetic_mnist(rng)
    for step in range(steps):
        i = (step * BATCH) % (len(x) - BATCH)
        yield {"img": x[i:i + BATCH], "label": y[i:i + BATCH]}


@pytest.mark.parametrize("kind,steps", [("sgd", 30), ("adam", 20)])
def test_train_parity_with_reference(rng, kind, steps):
    """Per-step losses within rtol 1e-5, accuracy, Correct and Total
    equal, fetched with the reference's dtypes and shapes; every
    persistable within rtol 1e-4 after the last step."""
    ravg, racc = build_mlp(rfluid)
    _optimizer(rfluid, kind).minimize(ravg)
    tavg, tacc = build_mlp(tfluid)
    _optimizer(tfluid, kind).minimize(tavg)
    rexe, texe, names = _transplant()
    r_losses, t_losses = [], []
    for feed in _batches(rng, steps):
        r = rexe.run(rfluid.default_main_program(), feed=feed,
                     fetch_list=[ravg, racc] + ACC_NAMES)
        t = texe.run(tfluid.default_main_program(), feed=feed,
                     fetch_list=[tavg, tacc] + ACC_NAMES)
        for rv, tv in zip(r, t):
            rv = np.asarray(rv)
            assert (tv.dtype, tv.shape) == (rv.dtype, rv.shape)
        np.testing.assert_array_equal(t[1:], [np.asarray(v) for v in r[1:]])
        r_losses.append(float(r[0][0]))
        t_losses.append(float(t[0][0]))
    np.testing.assert_allclose(t_losses, r_losses, rtol=LOSS_RTOL)
    assert t_losses[-1] < t_losses[0]
    for n in names:
        np.testing.assert_allclose(
            tscope.global_scope().find_var(n).numpy(),
            np.asarray(rscope.global_scope().find_var(n)),
            rtol=1e-4, atol=1e-6, err_msg=n)


def test_first_step_grads_match_reference(rng):
    """`fluid.append_backward` in both packages: every fc_*@GRAD of the
    first batch within rtol 1e-5."""
    ravg, _ = build_mlp(rfluid)
    rgrads = [g.name for _, g in rfluid.append_backward(ravg)]
    tavg, _ = build_mlp(tfluid)
    tgrads = [g.name for _, g in tfluid.append_backward(tavg)]
    assert rgrads == tgrads and len(rgrads) == 6
    rexe, texe, _ = _transplant()
    feed = next(_batches(rng, 1))
    r = rexe.run(rfluid.default_main_program(), feed=feed,
                 fetch_list=[ravg] + rgrads)
    t = texe.run(tfluid.default_main_program(), feed=feed,
                 fetch_list=[tavg] + tgrads)
    for name, rv, tv in zip(["loss"] + rgrads, r, t):
        rv = np.asarray(rv)
        assert (tv.dtype, tv.shape) == (rv.dtype, rv.shape), name
        np.testing.assert_allclose(tv, rv, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


# -- tests/test_mnist_mlp.py, on the port ------------------------------------

def test_mnist_mlp_trains(rng):
    avg_loss, acc = build_mlp(tfluid)
    tfluid.optimizer.SGDOptimizer(learning_rate=0.5).minimize(avg_loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    losses = []
    for feed in _batches(rng, 30):
        out = exe.run(tfluid.default_main_program(), feed=feed,
                      fetch_list=[avg_loss, acc])
        losses.append(float(out[0][0]))
    assert losses[-1] < losses[0] * 0.5, losses
    assert losses[-1] < 0.7, losses


def test_mnist_eval_and_fetch_params(rng):
    avg_loss, acc = build_mlp(tfluid)
    tfluid.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(avg_loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    x, y = _synthetic_mnist(rng, 64)
    l0 = exe.run(feed={"img": x, "label": y}, fetch_list=[avg_loss])[0]
    for _ in range(20):
        exe.run(feed={"img": x, "label": y}, fetch_list=[avg_loss])
    l1 = exe.run(feed={"img": x, "label": y}, fetch_list=[avg_loss])[0]
    assert float(l1[0]) < float(l0[0])


# -- the port's own contracts -------------------------------------------------

def test_executor_without_place_runs_on_the_card():
    """`Executor()` means cuda:0; with no card it raises and says so."""
    if torch.cuda.is_available():
        assert tfluid.Executor().device == torch.device("cuda", 0)
        return
    with pytest.raises(RuntimeError, match="CUDA device.*none is available"):
        tfluid.Executor()
    with pytest.raises(RuntimeError, match="none is available"):
        tfluid.Executor(tfluid.CUDAPlace(0))


def test_no_silent_copy_across_devices(rng):
    """A scope value or a feed on another device raises; nothing is
    copied over."""
    avg_loss, _ = build_mlp(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    feed = next(_batches(rng, 1))
    scope = tscope.global_scope()
    w = scope.find_var("fc_0.w_0")
    scope.set_var("fc_0.w_0", torch.empty(w.shape, device="meta"))
    with pytest.raises(RuntimeError, match="fc_0.w_0.*meta"):
        exe.run(feed=feed, fetch_list=[avg_loss])
    scope.set_var("fc_0.w_0", w)
    bad = dict(feed, img=torch.empty(feed["img"].shape, device="meta"))
    with pytest.raises(RuntimeError, match="feed 'img'.*meta"):
        exe.run(feed=bad, fetch_list=[avg_loss])
    assert exe.run(feed=feed, fetch_list=[avg_loss])[0].shape == (1,)


def test_missing_state_names_the_startup_program(rng):
    avg_loss, _ = build_mlp(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(RuntimeError, match="run the startup program"):
        exe.run(feed=next(_batches(rng, 1)), fetch_list=[avg_loss])


def test_prepared_block_cache_and_eval_clone(rng):
    """One prepared block per (program version, feed shapes, fetches);
    a for_test clone drops backward and updates and changes no param."""
    avg_loss, acc = build_mlp(tfluid)
    main = tfluid.default_main_program()
    test_prog = main.clone(for_test=True)
    tfluid.optimizer.SGDOptimizer(learning_rate=0.5).minimize(avg_loss)
    assert {op.type for op in test_prog.global_block().ops}.isdisjoint(
        {"backward", "sgd"})
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    feeds = list(_batches(rng, 2))
    for feed in feeds:
        exe.run(main, feed=feed, fetch_list=[avg_loss])
    assert len(exe._cache) == 2  # startup + main
    exe.run(main, feed={k: v[:32] for k, v in feeds[0].items()},
            fetch_list=[avg_loss])
    assert len(exe._cache) == 3  # a new batch size
    w = tscope.global_scope().find_var("fc_0.w_0")
    loss, accuracy = exe.run(test_prog, feed=feeds[1],
                             fetch_list=[avg_loss, acc])
    assert tscope.global_scope().find_var("fc_0.w_0") is w
    assert loss.shape == (1,) and 0.0 <= float(accuracy[0]) <= 1.0


def test_executor_flags(rng):
    """FLAGS_check_nan_inf names the non-finite fetch;
    FLAGS_tpu_compile_cache_size bounds the prepared-block cache."""
    from paddle_tpu_torch.utils import flags

    avg_loss, _ = build_mlp(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    feed = next(_batches(rng, 1))
    bad = dict(feed, img=np.full_like(feed["img"], np.nan))
    saved = flags.get_flags(["FLAGS_check_nan_inf",
                             "FLAGS_tpu_compile_cache_size"])
    try:
        flags.set_flags({"FLAGS_check_nan_inf": True,
                         "FLAGS_tpu_compile_cache_size": 1})
        exe.run(feed=feed, fetch_list=[avg_loss])
        with pytest.raises(RuntimeError, match="Inf/Nan.*mean_0.tmp_0"):
            exe.run(feed=bad, fetch_list=[avg_loss])
        assert len(exe._cache) == 1
    finally:
        flags.set_flags(saved)


def test_optimizer_options_not_ported_raise():
    """Gradient clipping is not ported and raises; weight decay is
    ported: a float `weight_decay` means L2Decay of that coefficient."""
    with pytest.raises(NotImplementedError, match="gradient clipping"):
        tfluid.optimizer.SGDOptimizer(0.1, grad_clip=object())
    reg = tfluid.optimizer.AdamOptimizer(weight_decay=1e-4).regularization
    assert isinstance(reg, tfluid.regularizer.L2Decay)
    assert reg._coeff == 1e-4


def test_op_error_names_its_creation_site(rng):
    """An op that fails at run time reports its type and where the model
    code built it (reference: op_call_stack.cc)."""
    avg_loss, _ = build_mlp(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    feed = next(_batches(rng, 1))
    feed["img"] = feed["img"][:, :700]  # not the declared 784 columns
    with pytest.raises(RuntimeError, match=r"(?s)\[operator mul error\]"
                       r".*test_torch_fluid_mnist.py:\d+ in build_mlp"):
        exe.run(feed=feed, fetch_list=[avg_loss])
