"""The fluid Executor's compiled blocks (`fluid/lowering.py compile_block`,
`core/graphs.py`), on the CPU.

Two parts. The capture analysis decides from the program alone which
blocks are captured as CUDA graphs: the MLP, the scanned BERT-small, a
ResNet18-small and the Transformer-small are; the `while_loop`, `cond`
and `switch_case` programs and the startup programs are not, and say
why. Then the static-buffer and write-back logic that the card runs
under capture is driven here through a runner that calls the block
function on the static buffers in place of a replay (tests only): N
steps equal N eager steps bit for bit, for MNIST SGD and Adam and for
the small BERT and Transformer with dropout on; an aliased `assign` whose
source is updated in the same step; a scope swapped through
`load_numpy_state` mid-run; fetches of an earlier step that the next
step does not overwrite; `Executor.warmup` leaving the scope and the
seed counter as they were. Against the JAX package: the MLP's losses
through that path within test_torch_fluid_mnist.py's rtol (1e-5)."""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rfluid
from paddle_tpu.core import scope as rscope

from paddle_tpu_torch import fluid
from paddle_tpu_torch.core.scope import dump_numpy_state, load_numpy_state
from paddle_tpu_torch.fluid import lowering
from paddle_tpu_torch.models import bert, resnet, transformer

LOSS_RTOL = 1e-5


def runner(body):
    """Stands in for a graph replay: the step body on the static
    buffers."""
    return body()


@pytest.fixture
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mlp(fl, kind, drop=False):
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 1
    with fl.program_guard(main, startup), fl.unique_name.guard():
        img = fl.layers.data(name="img", shape=[784], dtype="float32")
        label = fl.layers.data(name="label", shape=[1], dtype="int64")
        h = fl.layers.fc(input=img, size=128, act="relu")
        if drop:
            h = fl.layers.dropout(h, 0.2,
                                  dropout_implementation="upscale_in_train")
        h = fl.layers.fc(input=h, size=64, act="relu")
        logits = fl.layers.fc(input=h, size=10)
        loss = fl.layers.mean(
            fl.layers.softmax_with_cross_entropy(logits, label))
        opt = fl.optimizer.SGDOptimizer(0.5) if kind == "sgd" else \
            fl.optimizer.AdamOptimizer(1e-3)
        opt.minimize(loss)
    return main, startup, loss


def _mnist_feeds(n, batch=32, seed=0):
    r = np.random.RandomState(seed)
    return [{"img": r.rand(batch, 784).astype("float32"),
             "label": r.randint(0, 10, (batch, 1)).astype("int64")}
            for _ in range(n)]


def _bert_small(dropout=0.1):
    cfg = bert.BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = dropout
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        total, _, _, _ = bert.bert_pretrain_loss(cfg, 32, scan_layers=True,
                                                 scan_remat=True)
        fluid.optimizer.AdamOptimizer(1e-3).minimize(total)
    return main, startup, total, [bert.bert_feed(cfg, 4, 32)] * 4


def _transformer_small(dropout=0.1):
    cfg = transformer.TransformerConfig.tiny()
    cfg.dropout = dropout
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 13
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _ = transformer.build_transformer_train(
            cfg, src_len=16, tgt_len=16, warmup=10, scan_layers=True)
    r = np.random.RandomState(0)
    mask = (np.arange(16)[None] < np.array([16, 12, 9, 5])[:, None]
            ).astype("float32")

    def ids(v):
        return np.where(mask > 0, r.randint(2, v, (4, 16)), 1).astype(
            "int64")

    feed = {"src_ids": ids(cfg.src_vocab), "tgt_ids": ids(cfg.tgt_vocab),
            "lbl_ids": ids(cfg.tgt_vocab), "src_mask": mask,
            "tgt_mask": mask}
    return main, startup, loss, [feed] * 4


def _resnet_small():
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 6
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = resnet.build_resnet_train(
            image_shape=(3, 32, 32), class_dim=10, depth=18, lr=0.01)
    return main, startup, loss


# -- the capture analysis ----------------------------------------------------

@pytest.mark.parametrize("name", ["mlp", "bert", "resnet", "transformer"])
def test_training_blocks_are_capturable(name):
    main, startup = {
        "mlp": lambda: _mlp(fluid, "adam", drop=True)[:2],
        "bert": lambda: _bert_small()[:2],
        "resnet": lambda: _resnet_small()[:2],
        "transformer": lambda: _transformer_small()[:2]}[name]()
    assert lowering.capture_blocker(main, main.global_block()) is None
    # a startup program draws from host-seeded generators
    why = lowering.capture_blocker(startup, startup.global_block())
    assert why is not None and "initializer" in why


def _while_program():
    L = fluid.layers
    i = L.fill_constant([1], "int64", 1)
    limit = L.fill_constant([1], "int64", 6)
    fact = L.fill_constant([1], "int64", 1)

    def body(i, fact):
        return (L.elementwise_add(i, L.fill_constant([1], "int64", 1)),
                L.elementwise_mul(fact, i))

    return list(L.while_loop(lambda i, fact: L.less_than(i, limit), body,
                             [i, fact]))


def _cond_program():
    L = fluid.layers
    x = L.data("x", shape=[1], dtype="float32")
    pred = L.greater_than(x, L.fill_constant([1], "float32", 0.0))
    return [L.cond(pred, lambda: L.scale(x, scale=30.0),
                   lambda: L.scale(x, scale=8.0))]


def _switch_program():
    L = fluid.layers
    index = L.data("i", shape=[1], dtype="int64")
    return [L.switch_case(
        index, branch_fns=[lambda: L.fill_constant([1], "float32", 1.0)],
        default=lambda: L.fill_constant([1], "float32", 99.0))]


@pytest.mark.parametrize("build,op", [(_while_program, "while"),
                                      (_cond_program, "cond"),
                                      (_switch_program, "switch_case")])
def test_host_control_flow_is_not_capturable(build, op):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        fetch = build()
    why = lowering.capture_blocker(main, main.global_block())
    assert why is not None and "%r" % op in why and "host" in why
    entry = lowering.compile_block(main, main.global_block(), [],
                                   [f.name for f in fetch], "cpu",
                                   graph_runner=runner)
    assert entry.mode == "eager" and entry.reason == why


def test_no_jit_and_dynamic_shape_flags_block_capture(monkeypatch):
    from paddle_tpu_torch.ops import registry

    main, startup, _ = _mlp(fluid, "sgd")
    opdef = registry.get_op("relu")
    monkeypatch.setattr(opdef, "no_jit", True)
    assert "no_jit" in lowering.capture_blocker(main, main.global_block())
    monkeypatch.setattr(opdef, "no_jit", False)
    monkeypatch.setattr(opdef, "dynamic_shape", True)
    assert "dynamic_shape" in lowering.capture_blocker(main,
                                                       main.global_block())


def test_cpu_entries_run_eagerly_without_a_runner():
    main, _, loss = _mlp(fluid, "sgd")
    entry = lowering.compile_block(main, main.global_block(),
                                   ["img", "label"], [loss.name], "cpu")
    assert entry.mode == "eager" and "CPU" in entry.reason


# -- write-back through the runner --------------------------------------------

def _run(main, startup, feeds, fetch, graphs, state=None, scope=None):
    """The feeds through a fresh executor (the runner's graph path, or
    eager), from `state` (the startup's when None); the program's seed
    counter is put back after. Returns (fetches per step, final
    persistables, state, executor)."""
    exe = fluid.Executor(fluid.CPUPlace(),
                         graph_runner=runner if graphs else None)
    scope = scope or fluid.Scope()
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    if state is None:
        exe.run(startup, scope=scope)
        state = dump_numpy_state(scope, names)
    else:
        load_numpy_state(scope, state, "cpu")
    counter = main._seed_counter
    outs = [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
            for f in feeds]
    main._seed_counter = counter
    return outs, dump_numpy_state(scope, names), state, exe


def _assert_same(a, b):
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("name", ["sgd", "adam", "bert", "transformer"])
def test_graph_steps_equal_eager_steps(name, one_torch_thread):
    if name in ("sgd", "adam"):
        main, startup, loss = _mlp(fluid, name, drop=True)
        feeds = _mnist_feeds(5)
    elif name == "bert":
        main, startup, loss, feeds = _bert_small()
    else:
        main, startup, loss, feeds = _transformer_small()
    g, g_final, state, exe = _run(main, startup, feeds, [loss], True)
    e, e_final, _, _ = _run(main, startup, feeds, [loss], False, state)
    info = exe.last_entry.info()
    assert info["mode"] == "graph" and info["phase"] == "captured"
    assert info["replays"] == len(feeds) - 1
    _assert_same(g, e)
    for n in g_final:
        np.testing.assert_array_equal(g_final[n], e_final[n], err_msg=n)
    # the scope holds the entry's static buffers
    assert len({g_final[n].ctypes.data for n in g_final}) == len(g_final)


def _aliased_assign():
    """x and y persistable; each step y takes x's old value, then x
    grows by 1: the new y IS x's old buffer, which the write-back of x
    overwrites."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        L = fluid.layers
        x = L.create_global_var([2], 1.0, "float32", persistable=True,
                                name="x")
        y = L.create_global_var([2], 0.0, "float32", persistable=True,
                                name="y")
        L.assign(x, output=y)
        L.assign(L.elementwise_add(x, L.fill_constant([2], "float32", 1.0)),
                 output=x)
    return main, startup, [x, y]


def test_aliased_assign_write_back():
    main, startup, fetch = _aliased_assign()
    g, g_final, state, exe = _run(main, startup, [{}] * 4, fetch, True)
    e, e_final, _, _ = _run(main, startup, [{}] * 4, fetch, False, state)
    assert exe.last_entry.info()["phase"] == "captured"
    _assert_same(g, e)
    assert [float(o[1][0]) for o in g] == [1.0, 2.0, 3.0, 4.0]
    assert float(g_final["x"][0]) == 5.0 and float(g_final["y"][0]) == 4.0


def test_scope_swap_mid_run_is_honoured():
    main, startup, loss = _mlp(fluid, "adam")
    feeds = _mnist_feeds(6)
    results = {}
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    start = dump_numpy_state(scope, names)
    for graphs in (True, False):
        scope = fluid.Scope()
        load_numpy_state(scope, start, "cpu")
        exe = fluid.Executor(fluid.CPUPlace(),
                             graph_runner=runner if graphs else None)
        counter = main._seed_counter
        out = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)
               for f in feeds[:3]]
        load_numpy_state(scope, start, "cpu")  # back to the start
        out += [exe.run(main, feed=f, fetch_list=[loss], scope=scope)
                for f in feeds[:3]]
        main._seed_counter = counter
        results[graphs] = out
    _assert_same(results[True], results[False])
    # after the swap the steps repeat the first three
    _assert_same(results[True][3:], results[True][:3])


def test_earlier_fetches_are_not_overwritten():
    main, startup, loss = _mlp(fluid, "sgd")
    exe = fluid.Executor(fluid.CPUPlace(), graph_runner=runner)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    got = [[v.value for v in exe.run(main, feed=f,
                                     fetch_list=[loss, "fc_0.w_0"],
                                     scope=scope, return_numpy=False)]
           for f in _mnist_feeds(4)]
    assert exe.last_entry.info()["phase"] == "captured"
    kept = [[t.clone() for t in step] for step in got]
    exe.run(main, feed=_mnist_feeds(1, seed=9)[0], fetch_list=[loss],
            scope=scope)
    for step, copy in zip(got, kept):
        for t, c in zip(step, copy):
            assert torch.equal(t, c)
    assert not torch.equal(got[1][0], got[2][0])


def test_warmup_leaves_scope_and_seed_counter():
    main, startup, loss = _mlp(fluid, "adam", drop=True)
    exe = fluid.Executor(fluid.CPUPlace(), graph_runner=runner)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    before = dump_numpy_state(scope, names)
    counter = main._seed_counter
    shapes = [{"img": (8, 784), "label": (8, 1)},
              {"img": (16, 784), "label": (16, 1)},
              {"nope": (1,)}]
    rep = exe.warmup(main, shapes=shapes, fetch_list=[loss], scope=scope)
    assert [c["shapes"]["img"] for c in rep["compiled"]] == [[8, 784],
                                                               [16, 784]]
    assert len(rep["skipped"]) == 1 and not rep["cached"]
    assert main._seed_counter == counter
    after = dump_numpy_state(scope, names)
    for n in names:
        np.testing.assert_array_equal(before[n], after[n], err_msg=n)
    assert [b["phase"] for b in exe.compiled_blocks()
            if b["mode"] == "graph"] == ["captured"] * 2
    again = exe.warmup(main, shapes=shapes[:1], fetch_list=[loss],
                       scope=scope)
    assert len(again["cached"]) == 1 and not again["compiled"]
    # the first real step of a warmed shape replays, from the scope
    feed = _mnist_feeds(1, batch=8)[0]
    replays = exe.compiled_blocks()[1]["replays"]
    g = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert exe.last_entry.info()["replays"] == replays + 1
    main._seed_counter = counter
    e = _run(main, startup, [feed], [loss], False, before)[0]
    main._seed_counter = counter
    np.testing.assert_array_equal(g[0], e[0][0])
    with pytest.raises(NotImplementedError, match="meshes.*#10"):
        exe.warmup(main, shapes=shapes[:1], meshes="elastic")
    # in the background: a thread whose report is the foreground's, and
    # the cache, the scope and the seed counter stay as they were
    blocks = exe.compiled_blocks()
    before = dump_numpy_state(scope, names)
    thread = exe.warmup(main, shapes=shapes, fetch_list=[loss], scope=scope,
                        background=True)
    assert thread.name == "paddle-tpu-warmup" and thread.daemon
    thread.join(60)
    assert thread.warmup_report == rep
    assert exe.compiled_blocks() == blocks
    assert main._seed_counter == counter
    after = dump_numpy_state(scope, names)
    for n in names:
        np.testing.assert_array_equal(before[n], after[n], err_msg=n)


def test_lru_eviction_releases_and_close_clears():
    main, startup, loss = _mlp(fluid, "sgd")
    old = fluid.get_flags("FLAGS_tpu_compile_cache_size")
    fluid.set_flags({"FLAGS_tpu_compile_cache_size": 1})
    try:
        exe = fluid.Executor(fluid.CPUPlace(), graph_runner=runner)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        for b in (8, 8, 16):
            exe.run(main, feed=_mnist_feeds(1, batch=b)[0],
                    fetch_list=[loss], scope=scope)
        assert len(exe.compiled_blocks()) == 1
        exe.close()
        assert exe.compiled_blocks() == [] and exe.last_entry is None
    finally:
        fluid.set_flags(old)


# -- against the JAX package --------------------------------------------------

def _mnist_data(n=256):
    rng = np.random.RandomState(0)
    x = rng.rand(n, 784).astype("float32") * 0.1
    y = rng.randint(0, 10, size=(n, 1)).astype("int64")
    for i in range(n):
        x[i, y[i, 0] * 78:(y[i, 0] + 1) * 78] += 1.0
    return x, y


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_mlp_losses_through_the_graph_path_match_jax(kind, one_torch_thread):
    rmain, rstartup, rloss = _mlp(rfluid, kind)
    tmain, _, tloss = _mlp(fluid, kind)
    rexe = rfluid.Executor(rfluid.CPUPlace())
    rscope_ = rfluid.Scope() if hasattr(rfluid, "Scope") else None
    with rscope.scope_guard(rscope_ or rscope.global_scope()):
        rexe.run(rstartup)
        names = sorted(v.name for v in rmain.list_vars() if v.persistable)
        state = {n: np.asarray(rscope.global_scope().find_var(n))
                 for n in names}
        x, y = _mnist_data()
        feeds = [{"img": x[i:i + 64], "label": y[i:i + 64]}
                 for i in range(0, 192, 64)] * 3
        want = [float(np.asarray(rexe.run(rmain, feed=f,
                                          fetch_list=[rloss])[0]).reshape(-1)[0])
                for f in feeds]
    got, _, _, exe = _run(tmain, None, feeds, [tloss], True, state)
    assert exe.last_entry.info()["replays"] == len(feeds) - 1
    np.testing.assert_allclose([float(g[0][0]) for g in got], want,
                               rtol=LOSS_RTOL)


def test_sorted_lookup_gradient_matches_embedding():
    """The lookup ops' weight gradient on the card goes through
    `nn_ops._SortedLookup` (PyTorch's deterministic sorted path for
    heavily repeated ids). Its arithmetic, here on the CPU, is
    `F.embedding`'s, and it leaves the deterministic-algorithms flag as
    it found it."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.nn_ops import _SortedLookup

    g = torch.Generator().manual_seed(0)
    w = torch.randn(9, 6, generator=g, requires_grad=True)
    ids = torch.randint(0, 3, (4, 50), generator=g)
    up = torch.randn(4, 50, 6, generator=g)
    want, = torch.autograd.grad(F.embedding(ids, w), w, up)
    before = torch.are_deterministic_algorithms_enabled()
    out = _SortedLookup.apply(w, ids)
    got, = torch.autograd.grad(out, w, up)
    assert torch.equal(out, F.embedding(ids, w))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.are_deterministic_algorithms_enabled() == before
