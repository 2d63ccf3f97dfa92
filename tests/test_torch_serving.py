"""The port's serving runtime (paddle_tpu_torch.serving, on the CPU)
against the JAX package's: weights carried across with
`load_jax_params`, one forward over a prefill and a decode bucket, the
engine's greedy token streams over a synthetic trace with system
prompts (float32 and int8 pools), and `dense_decode_reference`. Then the
port's own contracts: batched == sequential, prefix cache on == off,
sampled streams independent of batching, drain/adopt continuity, no
silent CPU fallback, and no JAX anywhere in the port at run time.

Tolerances: logits and float32 pages fp32 atol 1e-5 (both sides compute
in float32 on the CPU and differ only in summation order); token ids and
int8 page values exactly."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu_torch import serving

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5

#: tests/test_serving.py's model, and a GQA variant of it
CFGS = {
    "mha": dict(vocab=48, embed=24, layers=2, heads=2, kv_heads=2,
                head_dim=8, ffn=48, max_seq=48),
    "gqa": dict(vocab=48, embed=24, layers=2, heads=4, kv_heads=2,
                head_dim=8, ffn=48, max_seq=48),
}
ENGINE_KW = dict(num_pages=96, page_size=4, max_seqs=4)
_JAX = {}


def _jax_model(name):
    """One JAX model, its jitted forward and numpy params per config.
    The params are made with numpy from a seed, in the layout (keys and
    shapes) of the JAX `init_params`, which is only traced."""
    if name not in _JAX:
        m = jserving.TinyDecoderLM(jserving.TinyLMConfig(**CFGS[name]))
        r = np.random.RandomState(3)

        def leaf(path, shape):
            key = jax.tree_util.keystr(path[-1:])
            if key.endswith("_g']"):
                return np.ones(shape.shape, np.float32)
            if key.endswith("_b']"):
                return np.zeros(shape.shape, np.float32)
            return (0.02 * r.standard_normal(shape.shape)).astype(
                np.float32)

        params = jax.tree_util.tree_map_with_path(
            leaf, jax.eval_shape(m.init_params, 0))
        _JAX[name] = (m, jax.jit(m.forward), params)
    return _JAX[name]


def _port_model(name, **kw):
    _, _, params = _jax_model(name)
    model = serving.TinyDecoderLM(serving.TinyLMConfig(**CFGS[name]), **kw)
    return serving.load_jax_params(model, params)


def _port_engine(name="mha", graph_runner=None, **over):
    _, _, params = _jax_model(name)
    return serving.Engine(_port_model(name), params=params,
                          config=serving.EngineConfig(**{**ENGINE_KW,
                                                         **over}),
                          device="cpu", graph_runner=graph_runner)


def _runner(body):
    """Stands in for a bucket's graph replay on the CPU: the step body
    over the bucket's static buffer and the engine's pages."""
    return body()


def _trace():
    return serving.synthetic_trace(
        n_requests=7, n_tenants=2, seed=5, vocab=48, prompt_range=(3, 14),
        output_range=(3, 8), system_prompt_range=(4, 9))


def _replay(engine, trace):
    reqs = [engine.submit(tr.prompt, max_new_tokens=tr.max_new_tokens)
            for tr in trace]
    engine.run_until_idle()
    return [list(r.output_tokens) for r in reqs]


# -- forward against the JAX model ------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("cfg", sorted(CFGS))
def test_forward_matches_jax(cfg, kv_dtype):
    """One prefill bucket, then one decode bucket, through both models on
    equal weights and equal fresh pools: last logits, next tokens and the
    written pages agree."""
    _, jforward, params = _jax_model(cfg)
    tm = _port_model(cfg)
    spec = dict(num_pages=16, page_size=4, pages_per_seq=12, dtype=kv_dtype)
    jpages = jserving.PagedKVCache(tm.kv_cache_spec(**spec)) \
        .init_device_state()
    tpages = serving.PagedKVCache(tm.kv_cache_spec(**spec)) \
        .init_device_state("cpu")
    tables = np.zeros((4, 12), np.int32)
    tables[0, :4] = [1, 2, 3, 4]
    tables[1, :3] = [5, 6, 7]
    tables[2, :2] = [8, 9]

    def both(tokens, ctx, qlens):
        nonlocal jpages
        jtok, jlog, jpages = jforward(
            params, jnp.asarray(tokens), jpages, jnp.asarray(tables),
            jnp.asarray(ctx), jnp.asarray(qlens))
        tt, tb, tc, tq = (torch.from_numpy(np.array(a))
                          for a in (tokens, tables, ctx, qlens))
        ttok, tlog, _ = tm(tt, tpages, tb, tc, tq)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=0, atol=ATOL)
        assert ttok.numpy().tolist() == np.asarray(jtok).tolist()
        for jentry, tentry in zip(jpages, tpages):
            for ja, ta in zip(jentry, tentry):
                # the port's last page is its scratch page
                ta = ta[:spec["num_pages"]]
                if ta.dtype == torch.int8:
                    assert np.array_equal(ta.numpy(), np.asarray(ja))
                else:
                    np.testing.assert_allclose(ta.numpy(), np.asarray(ja),
                                               rtol=0, atol=ATOL)
        return np.asarray(jtok, np.int32)

    qlens = np.array([14, 9, 5, 0], np.int32)  # slot 3 inactive
    prompt = np.random.RandomState(0).randint(0, 48, (4, 16))
    first = both(prompt.astype(np.int32), qlens, qlens)
    step = np.array([1, 1, 1, 0], np.int32)
    both(first[:, None], qlens + step, step)


def test_dense_decode_reference_matches_jax():
    jm, _, params = _jax_model("gqa")
    prompt = np.random.RandomState(1).randint(0, 48, 9).astype(np.int32)
    want = jserving.dense_decode_reference(jm, params, prompt, 2)
    assert serving.dense_decode_reference(_port_model("gqa"), prompt,
                                          2) == want


# -- the engine against the JAX engine --------------------------------------

@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_engine_greedy_streams_match_jax(kv_dtype):
    """Greedy streams over a multi-tenant trace with system prompts (the
    prefix cache shares their pages) equal the JAX engine's; the port
    writes a fixed number of rows a step, the inactive ones to its
    scratch page."""
    jm, _, params = _jax_model("mha")
    jeng = jserving.Engine(jm, params=params, config=jserving.EngineConfig(
        kv_dtype=kv_dtype, **ENGINE_KW))
    want = _replay(jeng, _trace())
    teng = _port_engine(kv_dtype=kv_dtype)
    assert _replay(teng, _trace()) == want
    assert teng.kv.prefix_hit_tokens == jeng.kv.prefix_hit_tokens > 0
    assert teng.kv.pages_in_use == 0


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_graph_path_streams_match_jax(kv_dtype):
    """The buckets' capture path (static input buffers, warmed and
    captured before traffic, greedy tokens out of the step), driven on
    the CPU through the runner: the streams equal the JAX engine's, and
    every dispatch replayed a captured bucket."""
    jm, _, params = _jax_model("mha")
    jeng = jserving.Engine(jm, params=params, config=jserving.EngineConfig(
        kv_dtype=kv_dtype, **ENGINE_KW))
    want = _replay(jeng, _trace())
    teng = _port_engine(kv_dtype=kv_dtype, graph_runner=_runner)
    warm = teng.warmup()
    assert len(warm["compiled"]) == len(warm["buckets"]) > 1
    assert _replay(teng, _trace()) == want
    info = teng._compiler.bucket_info()
    st = teng.stats()
    assert {v["mode"] for v in info.values()} == {"graph"}
    assert sum(v["replays"] for v in info.values()) == \
        st["prefill_dispatches"] + st["decode_dispatches"]
    assert all(v["eager_runs"] == 1 for v in info.values())


def test_scratch_page_is_in_no_block_table(monkeypatch):
    """The page tensors hold one page past the pool; the pool never hands
    it out, so no block table of a trace names it, and only the scratch
    page takes the inactive rows of a warmup."""
    teng = _port_engine(kv_dtype="float32")
    scratch = teng.kv.config.scratch_page
    assert scratch == ENGINE_KW["num_pages"]
    assert teng.pages[0][0].shape[0] == scratch + 1
    seen = []
    table = teng.kv.block_table

    def spy(seq_id):
        row = table(seq_id)
        seen.append(list(row))
        return row

    monkeypatch.setattr(teng.kv, "block_table", spy)
    teng.warmup()
    for k, v in teng.pages:
        assert not bool(k[:scratch].any()) and not bool(v[:scratch].any())
        assert bool(k[scratch].any())
    _replay(teng, _trace())
    assert seen and all(scratch not in row for row in seen)


def test_engine_stream_matches_dense_reference():
    eng = _port_engine("gqa")
    prompt = np.random.RandomState(2).randint(0, 48, 21).astype(np.int32)
    req = eng.submit(prompt, max_new_tokens=13)  # chunked prefill
    eng.run_until_idle()
    assert req.output_tokens == serving.dense_decode_reference(
        eng.model, prompt, 13)


# -- the port's own contracts -----------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_batched_equals_sequential(kv_dtype):
    trace = _trace()
    batched = _replay(_port_engine(kv_dtype=kv_dtype), trace)
    sequential = [_replay(_port_engine(kv_dtype=kv_dtype), [tr])[0]
                  for tr in trace]
    assert batched == sequential
    assert [len(o) for o in batched] == [tr.max_new_tokens for tr in trace]


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_prefix_cache_on_equals_off(kv_dtype):
    """Repeated prompts force copy-on-write boundary pages; the streams
    are the same with the cache off."""
    trace = _trace()
    trace = trace + trace[:3]
    on = _port_engine(kv_dtype=kv_dtype)
    got = _replay(on, trace)
    assert on.kv.cow_copies > 0 and on.kv.prefix_hit_tokens > 0
    assert got == _replay(_port_engine(kv_dtype=kv_dtype,
                                       prefix_cache=False), trace)


def test_sampled_streams_batch_independent_and_seeded():
    trace = _trace()

    def run(batched, seed=11):
        eng = _port_engine()
        kw = dict(temperature=0.8, top_k=10, top_p=0.9, seed=seed)
        if batched:
            reqs = [eng.submit(tr.prompt, max_new_tokens=tr.max_new_tokens,
                               **kw) for tr in trace]
            eng.run_until_idle()
            return [list(r.output_tokens) for r in reqs]
        out = []
        for tr in trace:
            r = eng.submit(tr.prompt, max_new_tokens=tr.max_new_tokens, **kw)
            eng.run_until_idle()
            out.append(list(r.output_tokens))
        return out

    batched = run(True)
    assert batched == run(False)
    assert batched != run(True, seed=12)
    assert batched != _replay(_port_engine(), trace)


def test_drain_adopt_continues_stream():
    """A stream drained mid-decode and adopted by a second engine equals
    the uninterrupted stream."""
    prompt = np.arange(3, 14, dtype=np.int32)
    want = _replay(_port_engine(), [serving.synthetic_trace(1)[0].__class__(
        0, "", prompt, 12)])[0]
    first = _port_engine()
    req = first.submit(prompt, max_new_tokens=12)
    for _ in range(4):
        first.step()
    out = first.drain(grace_s=0.0)
    assert out["completed"] == 0 and len(out["migrated"]) == 1
    entry = out["migrated"][0]
    second = _port_engine()
    (cont,) = second.adopt(out["migrated"])
    second.run_until_idle()
    assert req.output_tokens[:entry["already_emitted"]] + \
        cont.output_tokens == want
    with pytest.raises(RuntimeError, match="draining"):
        first.submit(prompt)


def test_kv_device_state_and_param_loading():
    kw = dict(num_pages=6, page_size=4, pages_per_seq=3, num_layers=2,
              num_kv_heads=2, head_dim=8)
    st = serving.PagedKVCache(serving.KVCacheConfig(
        dtype="int8", **kw)).init_device_state("cpu")
    assert len(st) == 2 and len(st[0]) == 4
    # 6 pages and the scratch page
    assert st[0][0].dtype == torch.int8 and st[0][0].shape == (7, 4, 2, 8)
    assert st[0][2].dtype == torch.float32 and bool((st[0][2] == 1).all())
    st = serving.PagedKVCache(serving.KVCacheConfig(
        dtype="bfloat16", **kw)).init_device_state("cpu")
    assert len(st[0]) == 2 and st[0][1].dtype == torch.bfloat16
    model = _port_model("mha")
    names = {n for n, _ in model.named_parameters()}
    assert {"emb", "pos", "lnf_g", "layers.1.wq", "layers.0.w2"} <= names
    _, _, params = _jax_model("gqa")
    with pytest.raises(ValueError, match="shape"):
        serving.load_jax_params(model, params)


def test_no_silent_cpu_fallback(monkeypatch):
    """Entry points default to the card: without CUDA, `Engine()` with no
    device raises; int8 weights are not ported and say so."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.Engine(serving.TinyDecoderLM(serving.TinyLMConfig()))
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.Engine(serving.TinyDecoderLM(serving.TinyLMConfig()),
                       device="cuda")
    with pytest.raises(NotImplementedError):
        serving.Engine(serving.TinyDecoderLM(serving.TinyLMConfig()),
                       config=serving.EngineConfig(quantize_weights=True),
                       device="cpu")


def test_port_imports_no_jax():
    """A fresh interpreter serves a tiny trace through the port, takes one
    train step with flash attention, trains a tiny MLP through the fluid
    static graph, takes a bf16 AMP step of a tiny scanned BERT, a step of
    a small ResNet, and two noam-Adam steps of a tiny Transformer, which
    it then decodes with beam search, launches a 2-rank gloo
    data-parallel MLP step (the sharded Adam update, fed by the device
    prefetcher) and a 2-stage pipeline step of the trainer on a mesh of
    those ranks, which import neither, saves and loads the BERT scope
    (bf16 params) through `fluid.io` and `fluid.checkpoint` and a tree
    through `ShardedCheckpointManager`, and has imported neither jax,
    ml_dtypes, orbax nor anything of paddle_tpu."""
    code = (
        "import math, sys\n"
        "from paddle_tpu_torch import serving\n"
        "from paddle_tpu_torch.parallel import transformer as tt\n"
        "eng = serving.Engine(serving.TinyDecoderLM(), device='cpu',\n"
        "    config=serving.EngineConfig(num_pages=32, page_size=4,\n"
        "                                max_seqs=2))\n"
        "s = serving.run_trace(eng, serving.synthetic_trace(3, 2))\n"
        "assert s['finished'] == 3, s\n"
        "cfg = tt.SPMDConfig(vocab=64, d_model=32, n_heads=4, d_ff=64,\n"
        "                    seq_len=16, n_layers=2, use_flash=True)\n"
        "p = tt.init_params(cfg, device='cpu')\n"
        "step = tt.make_train_step(cfg, device='cpu')\n"
        "p, o, loss = step(p, tt.init_opt_state(p),\n"
        "                  *tt.demo_batch(cfg, 2), 0)\n"
        "assert math.isfinite(float(loss)), loss\n"
        "import numpy as np\n"
        "from paddle_tpu_torch import fluid\n"
        "x = fluid.layers.data(name='x', shape=[8], dtype='float32')\n"
        "y = fluid.layers.data(name='y', shape=[1], dtype='int64')\n"
        "h = fluid.layers.fc(input=x, size=16, act='relu')\n"
        "logits = fluid.layers.fc(input=h, size=4)\n"
        "avg = fluid.layers.mean(\n"
        "    fluid.layers.softmax_with_cross_entropy(logits, y))\n"
        "acc = fluid.layers.accuracy(input=fluid.layers.softmax(logits),\n"
        "                            label=y)\n"
        "fluid.optimizer.AdamOptimizer(learning_rate=0.05).minimize(avg)\n"
        "exe = fluid.Executor(fluid.CPUPlace())\n"
        "exe.run(fluid.default_startup_program())\n"
        "r = np.random.RandomState(0)\n"
        "feed = {'x': r.randn(16, 8).astype('float32'),\n"
        "        'y': r.randint(0, 4, (16, 1))}\n"
        "l = [float(exe.run(feed=feed, fetch_list=[avg, acc])[0][0])\n"
        "     for _ in range(10)]\n"
        "assert l[-1] < l[0], l\n"
        "from paddle_tpu_torch.fluid.contrib import mixed_precision\n"
        "from paddle_tpu_torch.models import bert\n"
        "c = bert.BertConfig.tiny()\n"
        "with fluid.program_guard(fluid.Program(), fluid.Program()):\n"
        "    t = bert.bert_pretrain_loss(c, 16, scan_layers=True,\n"
        "                                scan_remat=True)[0]\n"
        "    mixed_precision.decorate(fluid.optimizer.AdamOptimizer(\n"
        "        1e-3)).minimize(t)\n"
        "    fluid.fuse_optimizer_ops(fluid.default_main_program())\n"
        "    exe.run(fluid.default_startup_program())\n"
        "    b = exe.run(feed=bert.bert_feed(c, 2, 16), fetch_list=[t])\n"
        "    import tempfile\n"
        "    from paddle_tpu_torch.fluid import checkpoint as fck, io as fio\n"
        "    td = tempfile.mkdtemp()\n"
        "    bm = fluid.default_main_program()\n"
        "    fio.save(bm, td + '/b')\n"
        "    fio.save_persistables(exe, td + '/p', bm)\n"
        "    fio.load(bm, td + '/b', exe)\n"
        "    fio.load_persistables(exe, td + '/p', bm)\n"
        "    fck.save_checkpoint(exe, td + '/c', fck.TrainStatus(0, 1), bm)\n"
        "    assert fck.load_checkpoint(exe, td + '/c', bm).step_no == 1\n"
        "    from paddle_tpu_torch.distributed import "
        "ShardedCheckpointManager\n"
        "    mg = ShardedCheckpointManager(td + '/s')\n"
        "    mg.save(0, {'w': p['embed']})\n"
        "    assert mg.restore()['w'].shape == p['embed'].shape\n"
        "assert math.isfinite(float(b[0][0])), b\n"
    "from paddle_tpu_torch.models import resnet\n"
    "with fluid.program_guard(fluid.Program(), fluid.Program()):\n"
    "    rl, ra, _ = resnet.build_resnet_train(image_shape=(3, 16, 16),\n"
    "        class_dim=4, lr=1e-3, scan_stages=True)\n"
    "    exe.run(fluid.default_startup_program())\n"
    "    f = {'image': r.randn(2, 3, 16, 16).astype('float32'),\n"
    "         'label': r.randint(0, 4, (2, 1))}\n"
    "    v = exe.run(feed=f, fetch_list=[rl, ra])\n"
    "assert math.isfinite(float(v[0][0])), v\n"
    "from paddle_tpu_torch.models import transformer as wmt\n"
    "tc = wmt.TransformerConfig.tiny()\n"
    "with fluid.program_guard(fluid.Program(), fluid.Program()):\n"
    "    tl, _ = wmt.build_transformer_train(tc, src_len=8, tgt_len=8,\n"
    "                                        scan_layers=True)\n"
    "    sc = fluid.Scope()\n"
    "    exe.run(fluid.default_startup_program(), scope=sc)\n"
    "    ids = r.randint(2, tc.src_vocab, (2, 8))\n"
    "    f = {'src_ids': ids, 'tgt_ids': ids, 'lbl_ids': ids,\n"
    "         'src_mask': np.ones((2, 8), 'float32'),\n"
    "         'tgt_mask': np.ones((2, 8), 'float32')}\n"
    "    w = [exe.run(feed=f, fetch_list=[tl], scope=sc) for _ in (0, 1)]\n"
    "    seqs, scores = wmt.beam_search_decode(sc, ids, f['src_mask'], tc,\n"
    "        beam_size=2, max_out_len=4, device='cpu')\n"
    "assert math.isfinite(float(w[1][0][0])), w\n"
    "assert tuple(seqs.shape) == (2, 2, 5), seqs.shape\n"
        "import subprocess, tempfile\n"
        "from paddle_tpu_torch.distributed.launch import free_port_base\n"
        "dp = ('import sys\\n'\n"
        "      'import numpy as np\\n'\n"
        "      'from paddle_tpu_torch import fleet, fluid\\n'\n"
        "      'fleet.init(is_collective=True)\\n'\n"
        "      'x = fluid.layers.data(name=\"x\", shape=[8])\\n'\n"
        "      'y = fluid.layers.data(name=\"y\", shape=[1], dtype=\"int64\")\\n'\n"
        "      'o = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy('\n"
        "      'fluid.layers.fc(input=x, size=4), y))\\n'\n"
        "      'fluid.optimizer.Adam(0.1).minimize(o)\\n'\n"
        "      'exe = fluid.Executor(fluid.CPUPlace())\\n'\n"
        "      'exe.run(fluid.default_startup_program())\\n'\n"
        "      'p = fluid.CompiledProgram(fluid.default_main_program())\\n'\n"
        "      'p = p.with_data_parallel()\\n'\n"
        "      'r = np.random.RandomState(0)\\n'\n"
        "      'from paddle_tpu_torch import reader\\n'\n"
        "      'f = next(reader.prefetch_to_device(iter([{'\n"
        "      '\"x\": r.randn(4, 8).astype(\"float32\"),'\n"
        "      '\"y\": r.randint(0, 4, (4, 1))}]), device=\"cpu\",'\n"
        "      'sharding=exe.feed_sharding(p)))\\n'\n"
        "      'l = exe.run(p, fetch_list=[o], feed=f)[0]\\n'\n"
        "      'assert l.shape == (2,) and np.isfinite(l).all(), l\\n'\n"
        "      'i = exe.last_entry.info()\\n'\n"
        "      'assert i[\"opt_state_sharded_vars\"] == 4, i\\n'\n"
        "      'from paddle_tpu_torch.parallel import transformer as tt\\n'\n"
        "      'c = tt.SPMDConfig(vocab=64, d_model=32, n_heads=4, d_ff=64, '\n"
        "      'seq_len=16, n_layers=2, n_micro=2, pp=2, use_flash=True)\\n'\n"
        "      'm = c.mesh(device=\"cpu\")\\n'\n"
        "      'mp = tt.shard_params(tt.init_params(c, device=\"cpu\"), c, m)\\n'\n"
        "      'ml = tt.make_train_step(c, m)(mp, tt.init_opt_state(mp), '\n"
        "      '*tt.demo_batch(c, 2), 0)[2]\\n'\n"
        "      'assert np.isfinite(float(ml)), ml\\n'\n"
        "      'bad = [m for m in sys.modules if m.split(\".\")[0] in '\n"
        "      '(\"jax\", \"jaxlib\", \"paddle_tpu\", \"ml_dtypes\", '\n"
        "      '\"orbax\")]\\n'\n"
        "      'assert not bad, bad\\n'\n"
        "      'print(\"DP-CLEAN\", fleet.worker_index())\\n')\n"
        "with tempfile.NamedTemporaryFile('w', suffix='.py',\n"
        "                                 delete=False) as fh:\n"
        "    fh.write(dp)\n"
        "rr = subprocess.run([sys.executable, '-m',\n"
        "    'paddle_tpu_torch.distributed.launch', '--nproc_per_node', '2',\n"
        "    '--started_port', str(free_port_base(3)), '--backend', 'gloo',\n"
        "    fh.name], capture_output=True, text=True, timeout=60)\n"
        "assert rr.returncode == 0 and rr.stdout.count('DP-CLEAN') == 2, (\n"
        "    rr.stdout + rr.stderr)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu',\n"
        "                                    'ml_dtypes', 'orbax'))\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "CLEAN" in res.stdout
