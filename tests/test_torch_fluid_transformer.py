"""The WMT Transformer in the port's fluid static graph (paddle_tpu_torch,
on the CPU) against the JAX package's: `build_transformer_train` (label
smoothing 0.1 with soft-label cross-entropy, the masked mean, noam decay
and Adam(0.9, 0.997, 1e-9)) and `beam_search_decode`.

Configs: `TransformerConfig.tiny()` (d_model 32, 4 heads, FFN 64, 2 + 2
layers, vocab 128) at S 8, and 2 + 2 layers at d_model 64 (4 heads, FFN
128, vocab 96) at S 16, dropout 0 (the generator streams differ). Both
packages build the same program; the reference's startup state (with
`@LR_DECAY_COUNTER@` and, unrolled or stacked, every parameter) is
carried into the port's scope with `load_numpy_state`; the feed is
seeded ids in [2, V) with per-sentence lengths, padding id 1, mask 0.
Then 5 noam-Adam steps: losses within rtol 1e-5, the learning rate equal
each step, every persistable within 1e-4 after them, but for the
parameter elements whose gradient stayed at the rounding floor (the
reference's Adam second moment below (1e-8)^2: the attention key biases,
to which softmax is blind, and a few weights of units that did not
fire), where Adam at epsilon 1e-9 turns rounding noise into steps of the
full learning rate in either package; the same for the
scanned stacks (with and without remat); scan == unrolled within the
port; beam search (beam 3, 6 new tokens) from the trained scopes:
sequences equal, scores within 1e-5; bf16 AMP O2 with fused Adam:
losses within 2e-2, the program equal op by op and every forward
result's dtype equal to the reference's. Last, `dynamic_decode` with a
`BeamSearchDecoder` over a `GRUCell` (beam 2, 5 steps, with lengths):
ids and lengths exact, scores within 1e-5. Each reference program runs
once per module (a fixture)."""
import numpy as np
import pytest

import paddle_tpu.fluid as rfluid
from paddle_tpu.core.scope import Scope as RScope
from paddle_tpu.fluid.contrib import mixed_precision as rmp
from paddle_tpu.models import transformer as rtr

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.scope import dump_numpy_state, load_numpy_state
from paddle_tpu_torch.fluid.contrib import mixed_precision as tmp
from paddle_tpu_torch.models import transformer as ttr

STEPS, LR, WARMUP = 5, 0.05, 4
FP32_RTOL, STATE_TOL, AMP_RTOL, SCORE_TOL = 1e-5, 1e-4, 2e-2, 1e-5
BEAM, MAX_OUT, BATCH = 3, 6, 3
#: name -> (config, S, scan_layers, amp) of each reference run
RUNS = {
    "tiny": ("tiny", 8, False, False),
    "tiny_scan": ("tiny", 8, True, False),
    "d64": ("d64", 16, False, False),
    "tiny_amp": ("tiny", 8, False, True),
}


def _cfg(pkg, name):
    if name == "tiny":
        return pkg.TransformerConfig.tiny()
    return pkg.TransformerConfig(src_vocab=96, tgt_vocab=96, max_len=16,
                                 d_model=64, n_head=4, d_ff=128, n_layer=2,
                                 dropout=0.0)


def _build(fluid, tr, mp, cfg_name, S, scan, amp, remat=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        if amp:
            real = fluid.optimizer.AdamOptimizer

            def decorated(**kw):
                return mp.decorate(real(**kw),
                                   use_dynamic_loss_scaling=False)

            fluid.optimizer.AdamOptimizer = decorated
        try:
            loss, _ = tr.build_transformer_train(
                _cfg(tr, cfg_name), src_len=S, tgt_len=S, lr=LR,
                warmup=WARMUP, label_smooth_eps=0.1, scan_layers=scan,
                scan_remat=remat)
        finally:
            if amp:
                fluid.optimizer.AdamOptimizer = real
        if amp:
            fluid.fuse_optimizer_ops(main)
    lr = next(op.input("LearningRate")[0]
              for op in main.global_block().ops
              if op.type in ("adam", "fused_adam"))
    return main, startup, loss, lr


def _feed(cfg, S, batch=BATCH, seed=0):
    """Ids in [2, V) with per-sentence lengths S/2..S; padding holds id
    1 with mask 0."""
    r = np.random.RandomState(seed)
    lens = r.randint(S // 2, S + 1, size=batch)
    mask = (np.arange(S)[None] < lens[:, None]).astype("float32")

    def ids(v):
        return np.where(mask > 0, r.randint(2, v, (batch, S)),
                        1).astype("int64")

    return {"src_ids": ids(cfg.src_vocab), "tgt_ids": ids(cfg.tgt_vocab),
            "lbl_ids": ids(cfg.tgt_vocab), "src_mask": mask,
            "tgt_mask": mask}


def _forward_outputs(main):
    names = []
    for op in main.global_block().ops:
        if op.type == "backward":
            break
        for slot in ("Out", "Y", "Loss"):
            names.extend(n for n in op.output_names.get(slot, [])
                         if n not in names)
    return names


def _persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


#: an element whose gradient stays below this (the root of Adam's second
#: moment) moves by rounding noise alone
NOISE_FLOOR = 1e-8


def _noise_driven(main, end):
    """param name -> bool mask of its elements whose gradient stayed at
    the rounding floor over the run (from the reference's end state)."""
    out = {}
    for op in main.global_block().ops:
        if op.type in ("adam", "fused_adam"):
            for p, m2 in zip(op.input("Param"), op.input("Moment2")):
                v = end[m2].astype("float64")
                # a zero second moment is a zero gradient: no step at all
                out[p] = (v > 0) & (np.sqrt(v) < NOISE_FLOOR)
    return out


@pytest.fixture(scope="module")
def reference():
    """name -> dict(main, start state, losses, lrs, end state, decode,
    first step's forward values) of the JAX package's run."""
    out = {}
    for name, (cfg_name, S, scan, amp) in RUNS.items():
        cfg = _cfg(rtr, cfg_name)
        main, startup, loss, lr = _build(rfluid, rtr, rmp, cfg_name, S,
                                         scan, amp)
        exe = rfluid.Executor(rfluid.CPUPlace())
        scope = RScope()
        exe.run(startup, scope=scope)
        names = _persistables(main)
        state = {n: np.asarray(scope.find_var(n)) for n in names}
        feed = _feed(cfg, S)
        fetch = [loss.name, lr] + (_forward_outputs(main) if amp else [])
        runs = [[np.asarray(v) for v in exe.run(
            main, feed=feed, fetch_list=fetch, scope=scope)]
            for _ in range(STEPS)]
        end = {n: np.asarray(scope.find_var(n)) for n in names}
        decode = None if amp else [np.asarray(a) for a in
                                   rtr.beam_search_decode(
                                       scope, feed["src_ids"],
                                       feed["src_mask"], cfg,
                                       beam_size=BEAM, max_out_len=MAX_OUT)]
        out[name] = dict(main=main, state=state, feed=feed,
                         losses=[float(r[0].ravel()[0]) for r in runs],
                         lrs=[r[1] for r in runs], end=end, decode=decode,
                         forward=dict(zip(fetch, runs[0])))
    return out


def _port_run(name, state, remat=False, steps=STEPS, fetch_more=()):
    cfg_name, S, scan, amp = RUNS[name]
    main, _, loss, lr = _build(tfluid, ttr, tmp, cfg_name, S, scan, amp,
                               remat=remat)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    load_numpy_state(scope, state, "cpu")
    feed = _feed(_cfg(ttr, cfg_name), S)
    runs = [exe.run(main, feed=feed, fetch_list=[loss, lr] + list(
        fetch_more), scope=scope) for _ in range(steps)]
    return main, scope, [float(r[0].ravel()[0]) for r in runs], \
        [r[1] for r in runs]


@pytest.mark.parametrize("name,remat", [("tiny", False), ("d64", False),
                                        ("tiny_scan", False),
                                        ("tiny_scan", True)])
def test_training_matches_reference(name, remat, reference):
    """5 noam-Adam steps with label smoothing: losses within 1e-5, the
    learning rate equal, the persistables (params, moments, beta powers,
    the step counter) within 1e-4 after them."""
    ref = reference[name]
    main, scope, losses, lrs = _port_run(name, ref["state"], remat=remat)
    np.testing.assert_allclose(losses, ref["losses"], rtol=FP32_RTOL)
    for got, want in zip(lrs, ref["lrs"]):
        np.testing.assert_array_equal(got, want)
    assert losses[-1] < losses[0]
    got = dump_numpy_state(scope, _persistables(main))
    assert sorted(got) == sorted(ref["end"])
    noise = _noise_driven(ref["main"], ref["end"])
    skipped = sum(int(m.sum()) for m in noise.values())
    assert skipped < 0.01 * sum(m.size for m in noise.values())
    for n, want in ref["end"].items():
        assert got[n].dtype == want.dtype, n
        keep = ~noise[n] if n in noise else np.ones(want.shape, bool)
        np.testing.assert_allclose(got[n][keep], want[keep], rtol=STATE_TOL,
                                   atol=STATE_TOL, err_msg=n)
    np.testing.assert_array_equal(got["@LR_DECAY_COUNTER@"], [1 + STEPS])


def _stacked_from_unrolled(vals, cfg):
    out = dict(vals)
    for pre in ("enc", "dec"):
        for suf in ttr.layer_param_suffixes(pre):
            out["%s_stack%s" % (pre, suf)] = np.stack(
                [vals["%s_%d%s" % (pre, i, suf)]
                 for i in range(cfg.n_layer)])
    return out


@pytest.mark.parametrize("remat", [False, True])
def test_scan_equals_unrolled(remat, reference):
    """The scanned stacks, from the unrolled params stacked: losses and
    learning rates within the port equal within 1e-5."""
    state = reference["tiny"]["state"]
    _, _, want, want_lr = _port_run("tiny", state)
    main_s, start_s, _, _ = _build(tfluid, ttr, tmp, "tiny", 8, True, False,
                                   remat=remat)
    own = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(start_s, scope=own)
    scan_state = dump_numpy_state(own, _persistables(main_s))
    stacked = _stacked_from_unrolled(state, _cfg(ttr, "tiny"))
    scan_state.update((n, v) for n, v in stacked.items()
                      if n in scan_state and not n.startswith("Adam"))
    _, _, got, got_lr = _port_run("tiny_scan", scan_state, remat=remat)
    np.testing.assert_allclose(got, want, rtol=FP32_RTOL)
    np.testing.assert_array_equal(np.ravel(got_lr), np.ravel(want_lr))


@pytest.mark.parametrize("name", ["tiny", "tiny_scan", "d64"])
def test_beam_search_matches_reference(name, reference):
    """Beam search from the scope the port trained (unrolled or stacked
    params): the reference's sequences exactly, its scores within 1e-5;
    bos first; the shapes [B, K, T + 1] and [B, K]."""
    ref = reference[name]
    cfg = _cfg(ttr, RUNS[name][0])
    _, scope, _, _ = _port_run(name, ref["state"])
    stats = {}
    seqs, scores = ttr.beam_search_decode(
        scope, ref["feed"]["src_ids"], ref["feed"]["src_mask"], cfg,
        beam_size=BEAM, max_out_len=MAX_OUT, device="cpu", stats=stats)
    want_seqs, want_scores = ref["decode"]
    assert tuple(seqs.shape) == (BATCH, BEAM, MAX_OUT + 1)
    assert tuple(scores.shape) == (BATCH, BEAM)
    assert (seqs[:, :, 0] == 0).all()
    # a near tie between candidates would make the comparison ill-posed
    assert float(stats["min_topk_margin"].min()) > 1e-4, stats
    np.testing.assert_array_equal(seqs.numpy(), want_seqs)
    np.testing.assert_allclose(scores.numpy(), want_scores, rtol=SCORE_TOL,
                               atol=SCORE_TOL)


def test_beam_search_stops_early_without_changing_the_result(reference):
    """Once every beam has finished, further steps change nothing: a
    decode that runs out its steps (eos never reached is forced by a
    huge max_out_len only where all beams end) equals one cut at the
    finishing step, and the loop stops there."""
    ref = reference["tiny"]
    cfg = _cfg(ttr, "tiny")
    _, scope, _, _ = _port_run("tiny", ref["state"])
    # make eos the best token everywhere: every beam ends on step 2
    b = scope.find_var("dec_out_proj.b").clone()
    b[1] += 50.0
    scope.set_var("dec_out_proj.b", b)
    src, mask = ref["feed"]["src_ids"], ref["feed"]["src_mask"]
    stats = {}
    long_seqs, long_scores = ttr.beam_search_decode(
        scope, src, mask, cfg, beam_size=BEAM, max_out_len=12,
        device="cpu", stats=stats)
    assert stats["steps"] < 12
    short_seqs, short_scores = ttr.beam_search_decode(
        scope, src, mask, cfg, beam_size=BEAM, max_out_len=stats["steps"],
        device="cpu")
    np.testing.assert_array_equal(long_seqs[..., :stats["steps"] + 1],
                                  short_seqs)
    assert (long_seqs[..., stats["steps"] + 1:] == 1).all()
    np.testing.assert_array_equal(long_scores, short_scores)


def test_amp_losses_match_reference(reference):
    """bf16 AMP O2 (fp32 masters) with fuse_optimizer_ops: one fused
    Adam reads the noam rate after the counter's increment; losses
    within 2e-2 over 5 steps."""
    ref = reference["tiny_amp"]
    main, _, losses, lrs = _port_run("tiny_amp", ref["state"])
    types = [op.type for op in main.global_block().ops]
    assert types[0] == "increment" and types.count("fused_adam") == 1
    np.testing.assert_allclose(losses, ref["losses"], rtol=AMP_RTOL)
    for got, want in zip(lrs, ref["lrs"]):
        np.testing.assert_array_equal(got, want)


def _program_record(program):
    blocks = []
    for block in program.blocks:
        ops = [(op.type, op.input_names, op.output_names,
                {k: v for k, v in op.attrs.items()
                 if k in ("loss_name", "diff_names")
                 or op.type != "backward"})
               for op in block.ops]
        vars_ = [(n, tuple(v.shape), v.dtype, bool(v.persistable))
                 for n, v in block.vars.items()]
        blocks.append((block.parent_idx, ops, vars_))
    return blocks


@pytest.mark.parametrize("name", ["tiny_amp", "tiny_scan"])
def test_program_matches_reference_op_by_op(name, reference):
    """The same blocks, ops, slots, attrs (the positional table and the
    causal mask as `assign_value` lists), var shapes and dtypes."""
    cfg_name, S, scan, amp = RUNS[name]
    main, _, _, _ = _build(tfluid, ttr, tmp, cfg_name, S, scan, amp)
    assert _program_record(main) == _program_record(reference[name]["main"])


def test_amp_forward_dtypes_match_reference(reference):
    """Under bf16 AMP O2 every forward result has the reference's dtype
    (one_hot and label_smooth in float32, the products bf16, the
    soft-label cross-entropy float32) and, on the first step, its value
    within 2e-2 relative in norm (bf16 rounds at 2^-8 and the products
    carry it on)."""
    ref = reference["tiny_amp"]
    main, _, _, _ = _build(tfluid, ttr, tmp, "tiny", 8, False, True)
    names = _forward_outputs(main)
    assert names == _forward_outputs(ref["main"])
    scope = tfluid.Scope()
    load_numpy_state(scope, ref["state"], "cpu")
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed=ref["feed"], fetch_list=names, scope=scope)
    dtypes = {}
    for n, g in zip(names, got):
        want = ref["forward"][n]
        assert g.dtype == want.dtype and g.shape == want.shape, n
        dtypes[n] = str(g.dtype)
        if np.issubdtype(want.dtype, np.integer) or want.dtype == bool:
            np.testing.assert_array_equal(g, want, err_msg=n)
        else:
            g, want = g.astype("float64"), want.astype("float64")
            assert np.linalg.norm(g - want) <= AMP_RTOL * max(
                np.linalg.norm(want), 1e-30), n
    assert {"bfloat16", "float32"} <= set(dtypes.values())
    one_hot = [op.output("Out")[0] for op in main.global_block().ops
               if op.type in ("one_hot", "label_smooth")]
    assert len(one_hot) == 2 and all(dtypes[n] == "float32"
                                     for n in one_hot)


def _dynamic_decode(fluid):
    """tests/test_decode_distributions.py's decoder: a GRUCell over
    one-hot ids, an fc to 16 classes, beam 2, 5 steps, with lengths."""
    rnn = fluid.layers.rnn_decode
    cell = rnn.GRUCell(hidden_size=8)
    decoder = rnn.BeamSearchDecoder(
        cell, start_token=0, end_token=1, beam_size=2,
        embedding_fn=lambda ids: fluid.layers.one_hot(
            fluid.layers.unsqueeze(ids, [1]), depth=16),
        output_fn=lambda h: fluid.layers.fc(h, 16, name="len_out_fc"))
    init = fluid.layers.data("h0", shape=[2, 8], dtype="float32",
                             append_batch_size=False)
    return rnn.dynamic_decode(decoder, inits=init, max_step_num=5,
                              return_length=True)


def test_dynamic_decode_matches_reference():
    feed = {"h0": np.random.RandomState(2).randn(2, 8).astype("float32")}
    got = {}
    for fluid, place, scope in ((rfluid, rfluid.CPUPlace(), RScope()),
                                (tfluid, tfluid.CPUPlace(), tfluid.Scope())):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 4
        with fluid.program_guard(main, startup), fluid.unique_name_guard():
            outs = _dynamic_decode(fluid)
        exe = fluid.Executor(place)
        if fluid is rfluid:
            exe.run(startup, scope=scope)
            state = {v.name: np.asarray(scope.find_var(v.name))
                     for v in main.list_vars() if v.persistable}
        else:
            load_numpy_state(scope, state, "cpu")
        got[fluid is tfluid] = [np.asarray(v) for v in exe.run(
            main, feed=feed, fetch_list=list(outs), scope=scope)]
    (r_ids, r_scores, r_len), (t_ids, t_scores, t_len) = got[False], \
        got[True]
    assert t_ids.shape == (2, 5, 2) and t_len.shape == (2, 2)
    np.testing.assert_array_equal(t_ids, r_ids)
    np.testing.assert_array_equal(t_len, r_len)
    np.testing.assert_allclose(t_scores, r_scores, rtol=SCORE_TOL,
                               atol=SCORE_TOL)


def test_scan_stack_init_scale_matches_unrolled():
    """The stacked [L, d, d] weights draw Xavier at the per-layer fan (as
    tests/test_transformer_scan.py holds the reference to): a layer's
    slice has about the unrolled weight's spread."""
    stds = []
    for scan in (False, True):
        main, startup, _, _ = _build(tfluid, ttr, tmp, "tiny", 8, scan,
                                     False)
        scope = tfluid.Scope()
        tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
        w = scope.find_var("enc_stack_selfattn_q.w")[0] if scan else \
            scope.find_var("enc_0_selfattn_q.w")
        stds.append(float(w.std()))
    assert 0.5 < stds[1] / stds[0] < 2.0, stds
