"""CUDA-graph capture on the card: the fluid Executor's compiled blocks,
one serving bucket, the dropout kernel and the device seeds. Every test
here needs an NVIDIA GPU (marker ``cuda``) and skips without one. The
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs_cuda.py

A captured step replays the kernels the eager step launched on the same
inputs, so graph and eager runs are compared bit for bit. The dropout
kernel's Mask equals its plain version exactly and its Out within one
unit in the last place."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import fluid, serving
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.core.scope import dump_numpy_state, load_numpy_state
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.ops.kernels import dropout, dropout_reference
from paddle_tpu_torch.ops.kernels.dropout import dropout_scale
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def graphs_flag():
    """Sets FLAGS_cuda_graphs for one test, then restores it."""
    old = fluid.get_flags("FLAGS_cuda_graphs")
    yield lambda on: fluid.set_flags({"FLAGS_cuda_graphs": on})
    fluid.set_flags(old)


def _ulps(a, b):
    """Largest distance in units in the last place between two tensors of
    one float dtype (same-sign values)."""
    itype = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
             torch.float16: torch.int16}[a.dtype]
    return int((a.view(itype).long() - b.view(itype).long()).abs().max())


@pytest.mark.parametrize("upscale", [True, False])
@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_dropout_kernel_matches_plain(dev, dtype, p, upscale):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 1001, 7, generator=g).to(dev, dtype)
    seed = rng.seed_tensor(12345 << 20, dev)
    dropout.launches = 0
    out, mask = dropout(x, seed, p, upscale=upscale)
    assert dropout.launches == 1
    ref_out, ref_mask = dropout_reference(x, seed, p, upscale=upscale)
    assert torch.equal(mask, ref_mask)
    assert _ulps(out, ref_out) <= 1
    keep = mask.float().mean().item()
    n = mask.numel()
    assert abs(keep - (1 - p)) <= 4 * (p * (1 - p) / n) ** 0.5


def test_dropout_kernel_gradient_and_seeds(dev):
    x = torch.randn(4096, device=dev, requires_grad=True)
    a = rng.seed_tensor(1, dev)
    out, mask = dropout(x, a, 0.3)
    (gx,) = torch.autograd.grad(out.sum(), x)
    torch.testing.assert_close(
        gx, mask.float() * dropout_scale(0.3), rtol=0, atol=0)
    same = dropout(x.detach(), rng.seed_tensor(1, dev), 0.3)[1]
    other = dropout(x.detach(), rng.seed_tensor(2, dev), 0.3)[1]
    assert torch.equal(same, mask) and not torch.equal(other, mask)


def test_fold_on_the_card_equals_the_host(dev):
    for seed in (0, 1, 2**31 - 1, 123456789):
        s = rng.seed_tensor(seed, dev)
        for idx in (0, 5, 1000):
            assert int(rng.fold(s, idx)) == rng.op_seed(seed, idx)
            assert int(rng.fold(rng.fold(s, idx), 3)) == rng.op_seed(
                rng.op_seed(seed, idx), 3)


def _mlp(kind):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data(name="img", shape=[784], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=img, size=128, act="relu")
        h = fluid.layers.dropout(h, 0.2,
                                 dropout_implementation="upscale_in_train")
        logits = fluid.layers.fc(input=h, size=10)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        opt = fluid.optimizer.SGDOptimizer(0.5) if kind == "sgd" else \
            fluid.optimizer.AdamOptimizer(1e-3)
        opt.minimize(loss)
    return main, startup, loss


def _steps(main, startup, feeds, fetch, graphs_flag, on, state=None):
    """Run `feeds` (one per step) through a fresh executor and scope,
    capture on or off, from `state` (the startup's when None). Returns
    (fetches per step, final persistables, the executor's last entry)."""
    graphs_flag(on)
    exe = fluid.Executor()
    scope = fluid.Scope()
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    if state is None:
        exe.run(startup, scope=scope)
        state = dump_numpy_state(scope, names)
    else:
        load_numpy_state(scope, state)
    counter = main._seed_counter
    outs = [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
            for f in feeds]
    main._seed_counter = counter
    info = exe.last_entry.info()
    final = dump_numpy_state(scope, names)
    exe.close()
    return outs, final, info, state


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_mlp_graph_equals_eager(dev, graphs_flag, kind):
    main, startup, loss = _mlp(kind)
    r = np.random.RandomState(0)
    feeds = [{"img": r.rand(32, 784).astype("float32"),
              "label": r.randint(0, 10, (32, 1)).astype("int64")}
             for _ in range(5)]
    g_outs, g_final, g_info, state = _steps(main, startup, feeds, [loss],
                                            graphs_flag, True)
    e_outs, e_final, e_info, _ = _steps(main, startup, feeds, [loss],
                                        graphs_flag, False, state)
    assert g_info["mode"] == "graph" and g_info["phase"] == "captured"
    assert g_info["replays"] == 4
    assert e_info["mode"] == "eager" and "FLAGS_cuda_graphs" in \
        e_info["reason"]
    for a, b in zip(g_outs, e_outs):
        np.testing.assert_array_equal(a[0], b[0])
    for n in g_final:
        np.testing.assert_array_equal(g_final[n], e_final[n], err_msg=n)


def test_bert_dropout_graph_equals_eager_and_masks_differ(dev, graphs_flag):
    cfg = bert.BertConfig.tiny()
    seq, batch = 32, 4
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        total, _, _, _ = bert.bert_pretrain_loss(cfg, seq, scan_layers=True,
                                                 scan_remat=True)
        fluid.optimizer.AdamOptimizer(1e-3).minimize(total)
    mask = next(op.output("Mask")[0] for op in main.global_block().ops
                if op.type == "dropout")
    feeds = [bert.bert_feed(cfg, batch, seq)] * 4
    g_outs, g_final, g_info, state = _steps(main, startup, feeds,
                                            [total, mask], graphs_flag, True)
    e_outs, e_final, _, _ = _steps(main, startup, feeds, [total, mask],
                                   graphs_flag, False, state)
    assert g_info["mode"] == "graph" and g_info["replays"] == 3
    assert g_info["launches"].get("dropout", 0) > 0
    for a, b in zip(g_outs, e_outs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for n in g_final:
        np.testing.assert_array_equal(g_final[n], e_final[n], err_msg=n)
    # two replays, two seeds, two masks
    assert not np.array_equal(g_outs[2][1], g_outs[3][1])


def test_serving_bucket_graph_equals_eager(dev, graphs_flag):
    cfg = serving.TinyLMConfig(vocab=64, embed=32, layers=2, heads=2,
                               kv_heads=2, head_dim=16, ffn=64, max_seq=64)
    trace = serving.synthetic_trace(n_requests=5, n_tenants=2, seed=3,
                                    vocab=64, prompt_range=(3, 20),
                                    output_range=(3, 9),
                                    system_prompt_range=(4, 8))
    streams = {}
    for on in (True, False):
        graphs_flag(on)
        eng = serving.Engine(serving.TinyDecoderLM(cfg),
                             config=serving.EngineConfig(
                                 num_pages=64, page_size=4, max_seqs=4,
                                 kv_dtype="bfloat16"), seed=0)
        eng.warmup()
        rpa.launches = 0
        reqs = [eng.submit(tr.prompt, max_new_tokens=tr.max_new_tokens)
                for tr in trace]
        eng.run_until_idle()
        torch.cuda.synchronize()
        st = eng.stats()
        dispatches = st["prefill_dispatches"] + st["decode_dispatches"]
        assert rpa.launches == cfg.layers * dispatches
        info = eng._compiler.bucket_info()
        modes = {v["mode"] for v in info.values()}
        assert modes == ({"graph"} if on else {"eager"})
        streams[on] = [list(r.output_tokens) for r in reqs]
        eng.close()
    assert streams[True] == streams[False]


def _host_read(ins, attrs):
    x = ins["X"][0]
    return {"Out": x * float(x.sum())}


@pytest.fixture
def host_read_op():
    """Registers "test_host_read", an op that reads a value on the host,
    for one test (the registry is shared by every test of the process)."""
    registry.register_op("test_host_read", infer_shape=lambda specs, attrs: {
        "Out": specs["X"]})(_host_read)
    yield
    del registry._REGISTRY["test_host_read"]


def test_forced_capture_failure_raises(dev, graphs_flag, host_read_op):
    graphs_flag(True)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        out = main.global_block().create_var(name="hr_out", dtype="float32",
                                             shape=[-1, 4])
        main.global_block().append_op(type="test_host_read",
                                      inputs={"X": [x]},
                                      outputs={"Out": [out]})
    exe = fluid.Executor()
    feed = {"x": np.ones((2, 4), np.float32)}
    first = exe.run(main, feed=feed, fetch_list=[out])[0]
    np.testing.assert_array_equal(first, np.full((2, 4), 8.0, np.float32))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="CUDA graph capture failed"):
            exe.run(main, feed=feed, fetch_list=[out])
        assert exe.last_entry.mode == "graph"
    exe.close()


def test_host_control_flow_is_named_eager(dev, graphs_flag):
    graphs_flag(True)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        L = fluid.layers
        i = L.fill_constant([1], "int64", 0)
        ten = L.fill_constant([1], "int64", 10)
        out = L.while_loop(
            lambda i: L.less_than(i, ten),
            lambda i: [L.elementwise_add(
                i, L.fill_constant([1], "int64", 1))], [i])
    exe = fluid.Executor()
    for _ in range(3):
        got = exe.run(main, fetch_list=[out[0]])[0]
    assert int(got.reshape(-1)[0]) == 10
    info = exe.last_entry.info()
    assert info["mode"] == "eager" and "'while'" in info["reason"]


def test_warmup_then_first_run_replays(dev, graphs_flag):
    graphs_flag(True)
    main, startup, loss = _mlp("adam")
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    before = dump_numpy_state(scope, names)
    counter = main._seed_counter
    rep = exe.warmup(main, shapes=[{"img": (16, 784), "label": (16, 1)}],
                     fetch_list=[loss], scope=scope)
    assert [c["mode"] for c in rep["compiled"]] == ["graph"]
    assert main._seed_counter == counter
    after = dump_numpy_state(scope, names)
    for n in names:
        np.testing.assert_array_equal(before[n], after[n], err_msg=n)
    r = np.random.RandomState(1)
    feed = {"img": r.rand(16, 784).astype("float32"),
            "label": r.randint(0, 10, (16, 1)).astype("int64")}
    warmed = [b for b in exe.compiled_blocks() if b["mode"] == "graph"]
    assert len(warmed) == 1 and warmed[0]["phase"] == "captured"
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    info = exe.last_entry.info()
    assert info["phase"] == "captured"
    assert info["replays"] == warmed[0]["replays"] + 1
    again = exe.warmup(main, shapes=[{"img": (16, 784), "label": (16, 1)}],
                       fetch_list=[loss], scope=scope)
    assert len(again["cached"]) == 1 and not again["compiled"]
    exe.close()


def test_background_warmup_on_the_card(dev, graphs_flag):
    """`warmup(background=True)` runs its discarded step on a side
    stream while the main thread steps: its report equals a foreground
    warmup's, the cache keeps only the main thread's entry, and the
    main thread's steps equal those of a run without the warmup."""
    graphs_flag(True)
    main, startup, loss = _mlp("adam")
    shapes = [{"img": (16, 784), "label": (16, 1)}]
    r = np.random.RandomState(1)
    feeds = [{"img": r.rand(16, 784).astype("float32"),
              "label": r.randint(0, 10, (16, 1)).astype("int64")}
             for _ in range(4)]
    want, _, _, state = _steps(main, startup, feeds, [loss], graphs_flag,
                               True)
    exe = fluid.Executor()
    scope = fluid.Scope()
    load_numpy_state(scope, state)
    thread = exe.warmup(main, shapes=shapes, fetch_list=[loss], scope=scope,
                        background=True)
    counter = main._seed_counter
    got = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)
           for f in feeds]
    main._seed_counter = counter
    thread.join(120)
    assert thread.name == "paddle-tpu-warmup" and not thread.is_alive()
    fg = fluid.Executor().warmup(main, shapes=shapes, fetch_list=[loss],
                                 scope=scope)
    assert thread.warmup_report == fg
    assert [b["phase"] for b in exe.compiled_blocks()] == ["captured"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
    exe.close()


def test_lookup_gradient_is_deterministic(dev):
    """BERT's position ids repeat every row of the batch: the lookup's
    weight gradient is the same bits run after run (and under a
    captured step), where PyTorch's default path sums each id's rows in
    another order each run."""
    from paddle_tpu_torch.ops import registry as reg

    g = torch.Generator().manual_seed(0)
    w = torch.randn(512, 768, generator=g).to(dev, torch.bfloat16)
    ids = torch.arange(128).repeat(256, 1).to(dev)
    up = torch.randn(256, 128, 768, generator=g).to(dev, torch.bfloat16)
    grads = []
    for _ in range(4):
        leaf = w.clone().requires_grad_(True)
        out = reg.get_op("lookup_table_v2").compute(
            {"W": [leaf], "Ids": [ids]}, {})["Out"]
        grads.append(torch.autograd.grad(out, leaf, up)[0])
    for x in grads[1:]:
        assert torch.equal(x, grads[0])
    want = (up.float().sum(0))
    torch.testing.assert_close(grads[0][:128].float(), want, rtol=2e-2,
                               atol=2e-2)
    assert not grads[0][128:].any()
