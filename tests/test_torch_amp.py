"""float16 mixed precision with loss scaling (`fluid.contrib.
mixed_precision`, the loss-scaled step of `fluid/lowering.py`) against
the JAX package on the CPU, after the reference's own tests
(`tests/test_mixed_precision.py:300-520`).

Each case builds one program in both packages (an MLP, or BERT-tiny at 2
layers with LAMB), carries the reference's startup state into the port's
scope and runs the same batches. What must match, and how closely:
- every skip decision and the scale state (scale, good and bad counts)
  exactly; an overflow step leaves every param, master and moment bit
  for bit; every overflow is forced well clear of the edge (a scale of
  2^40 against gradients of order 1, where float16 ends at 65504);
- float16 values (live params) within rtol 2e-3, float32 state (masters,
  moments) within 2e-3 of its largest value, and losses after 3 steps
  within 5e-3;
- O0 is the float32 program (rtol 1e-5).
The captured path runs on the CPU through `Executor(graph_runner=...)`
(the step on static buffers), bit-equal to eager runs; `capture_blocker`
lets such a program be captured. The data-parallel cases live in
`test_fp16_data_parallel_matches_reference` (2 gloo ranks against the
reference on a 2-device mesh)."""
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rfluid
from paddle_tpu.core.scope import Scope as RScope
from paddle_tpu.fluid.contrib import mixed_precision as rmp
from paddle_tpu.models import bert as rbert

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import distributed
from paddle_tpu_torch.core.scope import load_numpy_state
from paddle_tpu_torch.fluid import lowering
from paddle_tpu_torch.fluid.contrib import mixed_precision as tmp
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.utils import flags as tflags

import torch_amp_runner as runner

F16_RTOL, LOSS_RTOL, STATE_RTOL, STEPS = 2e-3, 5e-3, 2e-3, 3
OVERFLOW = 2.0 ** 40


def _feed(n=16, seed=0):
    r = np.random.RandomState(seed)
    return {"img": r.rand(n, 32).astype("float32"),
            "label": r.randint(0, 4, (n, 1)).astype("int64")}


def _mlp(fluid, mp, opt, clip=None, level="O2", **dkw):
    """The MLP under `mp.decorate(opt)`; returns (main, startup, loss,
    decorated optimizer, fetchable global norm or None)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        img = fluid.layers.data(name="img", shape=[32], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=img, size=16, act="relu")
        logits = fluid.layers.fc(input=h, size=4)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            logits, label))
        kw = {"grad_clip": clip(fluid)} if clip else {}
        if opt == "sgd":
            o = fluid.optimizer.SGDOptimizer(0.1, **kw)
        elif opt == "adam":
            o = fluid.optimizer.AdamOptimizer(0.01, **kw)
        else:
            o = fluid.optimizer.LambOptimizer(0.01, **kw)
        cfg = dict(amp_dtype="float16", amp_level=level,
                   init_loss_scaling=2.0 ** 8, incr_every_n_steps=2,
                   decr_every_n_nan_or_inf=1, decr_ratio=0.5)
        cfg.update(dkw)
        d = mp.decorate(o, **cfg)
        d.minimize(loss)
    norm = next((n for op in main.global_block().ops if op.type == "sqrt"
                 for n in op.output_arg_names), None)
    return main, startup, loss, d, norm


def _persistables(program):
    return sorted(v.name for v in program.list_vars() if v.persistable)


class _Ref:
    """The reference program in its own scope."""

    def __init__(self, build):
        self.main, startup, self.loss, self.opt, self.norm = build(rfluid,
                                                                   rmp)
        self.exe, self.scope = rfluid.Executor(rfluid.CPUPlace()), RScope()
        with rfluid.scope_guard(self.scope):
            self.exe.run(startup)

    def state(self):
        return {n: np.asarray(self.scope.find_var(n))
                for n in _persistables(self.main)
                if self.scope.find_var(n) is not None}

    def set(self, name, value):
        import jax.numpy as jnp

        self.scope.set_var(name, jnp.asarray(value))

    def step(self, feed, extra=()):
        with rfluid.scope_guard(self.scope):
            out = self.exe.run(self.main, feed=feed,
                               fetch_list=[self.loss] + list(extra))
        return [np.asarray(v) for v in out]


class _Port:
    """The port's program from a reference start state."""

    def __init__(self, build, start, graph=False):
        self.main, _, self.loss, self.opt, self.norm = build(tfluid, tmp)
        runner = (lambda body: body()) if graph else None
        self.exe = tfluid.Executor(tfluid.CPUPlace(), graph_runner=runner)
        self.scope = tfluid.Scope()
        load_numpy_state(self.scope, start, "cpu")

    def state(self):
        return {n: self.scope.find_var(n).detach().cpu().clone()
                for n in _persistables(self.main)}

    def set(self, name, value):
        cur = self.scope.find_var(name)
        self.scope.set_var(name, torch.as_tensor(np.asarray(value)).to(
            cur.dtype).reshape(cur.shape))

    def step(self, feed, extra=()):
        out = self.exe.run(self.main, feed=feed,
                           fetch_list=[self.loss] + list(extra),
                           scope=self.scope)
        return [np.asarray(v) for v in out]


def _np(v):
    return v.float().numpy() if isinstance(v, torch.Tensor) else \
        np.asarray(v).astype(np.float32)


def _check_state(port, ref, dls):
    """Scale state exact; float16 values within F16_RTOL, float32 state
    within STATE_RTOL of its scale."""
    for k in ("scale", "good", "bad"):
        assert _np(port[dls[k]]).tolist() == _np(ref[dls[k]]).tolist(), k
    for n, want in ref.items():
        got, want_f = _np(port[n]), _np(want)
        if str(want.dtype) == "float16":
            np.testing.assert_allclose(got, want_f, rtol=F16_RTOL,
                                       atol=1e-3, err_msg=n)
        else:
            tol = STATE_RTOL * max(float(np.abs(want_f).max()), 1e-6)
            np.testing.assert_allclose(got, want_f, rtol=0, atol=tol,
                                       err_msg=n)


@pytest.mark.parametrize("opt,clip", [
    ("sgd", None), ("adam", None),
    ("lamb", lambda f: f.clip.GradientClipByGlobalNorm(1.0))])
def test_fp16_o2_dynamic_scaling_matches_reference(opt, clip):
    def build(fluid, mp):
        return _mlp(fluid, mp, opt, clip)

    ref = _Ref(build)
    port = _Port(build, ref.state())
    assert port.opt._scale_state is not None
    feed = _feed()
    r_losses = [float(ref.step(feed)[0].ravel()[0]) for _ in range(STEPS)]
    t_losses = [float(port.step(feed)[0].ravel()[0]) for _ in range(STEPS)]
    np.testing.assert_allclose(t_losses, r_losses, rtol=LOSS_RTOL)
    _check_state(port.state(), ref.state(), ref.opt._scale_state)
    # the 3 steps were clean: the scale doubled once (every 2)
    assert float(port.state()[port.opt._scale_state["scale"]]) == 2.0 ** 9
    with tfluid.scope_guard(port.scope):
        assert port.opt.get_loss_scaling() == 2.0 ** 9


def test_fp16_overflow_skips_update_and_decays_scale():
    """At 2^40 every step overflows: nothing moves but the scale (halved
    a step) and the counters; once the scale is set back into range, the
    update applies again, as in the reference."""
    def build(fluid, mp):
        return _mlp(fluid, mp, "adam", init_loss_scaling=OVERFLOW)

    ref = _Ref(build)
    start = ref.state()
    port = _Port(build, start)
    dls = port.opt._scale_state
    feed = _feed()
    for i in range(2):
        r_loss, t_loss = ref.step(feed)[0], port.step(feed)[0]
        np.testing.assert_array_equal(t_loss, r_loss)
        state = port.state()
        assert float(state[dls["scale"]]) == OVERFLOW / 2 ** (i + 1)
        assert int(state[dls["good"]]) == 0 == int(state[dls["bad"]])
        for n, v in start.items():
            if n not in (dls["scale"], dls["good"], dls["bad"]):
                assert np.array_equal(_np(state[n]), _np(v)), n
    _check_state(port.state(), ref.state(), dls)
    for side in (ref, port):
        side.set(dls["scale"], [16.0])
    ref.step(feed)
    port.step(feed)
    after = port.state()
    assert not np.array_equal(_np(after["fc_0.w_0@MASTER"]),
                              _np(start["fc_0.w_0@MASTER"]))
    _check_state(after, ref.state(), dls)


def test_fp16_scale_growth_every_n_clean_steps():
    def build(fluid, mp):
        return _mlp(fluid, mp, "sgd", init_loss_scaling=16.0)

    ref = _Ref(build)
    port = _Port(build, ref.state())
    dls = port.opt._scale_state
    feed = _feed()
    seen = []
    for _ in range(3):
        ref.step(feed)
        port.step(feed)
        s = port.state()
        seen.append((float(s[dls["scale"]]), int(s[dls["good"]])))
        _check_state(s, ref.state(), dls)
    assert seen == [(16.0, 1), (32.0, 0), (32.0, 1)]


def test_fp16_scale_state_survives_checkpoint(tmp_path):
    """The scale and its counters persist through save_persistables and
    load_persistables like any optimizer state (float32 and int32 in the
    files): a restored run resumes the state machine where it was."""
    def build(fluid, mp):
        return _mlp(fluid, mp, "sgd", init_loss_scaling=16.0,
                    incr_every_n_steps=3)

    ref = _Ref(build)
    port = _Port(build, ref.state())
    dls = port.opt._scale_state
    feed = _feed()
    for _ in range(2):
        port.step(feed)
    want = port.state()
    assert int(want[dls["good"]]) == 2
    with tfluid.scope_guard(port.scope):
        tfluid.io.save_persistables(port.exe, str(tmp_path), port.main)
    port.step(feed)
    assert int(port.state()[dls["good"]]) == 0
    with tfluid.scope_guard(port.scope):
        tfluid.io.load_persistables(port.exe, str(tmp_path), port.main)
    got = port.state()
    for n, v in want.items():
        assert got[n].dtype == v.dtype and torch.equal(got[n], v), n
    assert np.load(os.path.join(str(tmp_path), dls["good"] + ".npy")) \
        .dtype == np.int32
    port.step(feed)  # the third clean step since the save: growth
    assert float(port.state()[dls["scale"]]) == 32.0


def test_fp16_global_norm_clip_fetch_reads_zero_on_skip():
    """Global-norm clipping under dynamic scaling: the global norm (a var
    the post-backward section creates) fetches as zeros on an overflow
    step and as the reference's value on a clean one; the clipped,
    dtype-promoted gradients leave the step in their float16 dtype."""
    def build(fluid, mp):
        return _mlp(fluid, mp, "sgd",
                    lambda f: f.clip.GradientClipByGlobalNorm(0.5),
                    init_loss_scaling=OVERFLOW)

    ref = _Ref(build)
    port = _Port(build, ref.state())
    assert port.norm is not None and port.norm == ref.norm
    dls = port.opt._scale_state
    feed = _feed()
    r = ref.step(feed, [ref.norm])
    t = port.step(feed, [port.norm])
    assert float(r[1].ravel()[0]) == 0.0 == float(t[1].ravel()[0])
    for side in (ref, port):
        side.set(dls["scale"], [16.0])
    r = ref.step(feed, [ref.norm])
    t = port.step(feed, [port.norm])
    assert float(t[1].ravel()[0]) > 0
    np.testing.assert_allclose(t[1], r[1], rtol=F16_RTOL)
    _check_state(port.state(), ref.state(), dls)


@pytest.mark.parametrize("level", ["O0", "O1"])
def test_fp16_levels_match_reference(level):
    """O0 minimizes as if undecorated (float32, no scale state); O1 is
    the cast policy over float32 params, with loss scaling."""
    def build(fluid, mp):
        return _mlp(fluid, mp, "adam", level=level)

    ref = _Ref(build)
    port = _Port(build, ref.state())
    assert (port.opt._scale_state is None) == (level == "O0")
    assert not port.opt.get_master_weights()
    assert all(str(v.dtype) != "float16" for v in port.main.list_vars()
               if v.persistable)
    feed = _feed()
    r = [float(ref.step(feed)[0].ravel()[0]) for _ in range(STEPS)]
    t = [float(port.step(feed)[0].ravel()[0]) for _ in range(STEPS)]
    rtol = 1e-5 if level == "O0" else LOSS_RTOL
    np.testing.assert_allclose(t, r, rtol=rtol)
    for n, want in ref.state().items():
        np.testing.assert_allclose(_np(port.state()[n]), _np(want),
                                   rtol=rtol * 10, atol=1e-5, err_msg=n)


def test_fp16_static_scaling_matches_reference():
    """Static scaling: the cotangent times the constant, the gradients
    divided by it, no state and no skip."""
    def build(fluid, mp):
        return _mlp(fluid, mp, "adam", use_dynamic_loss_scaling=False,
                    init_loss_scaling=128.0)

    ref = _Ref(build)
    port = _Port(build, ref.state())
    assert port.opt._scale_state is None
    bop = next(op for op in port.main.global_block().ops
               if op.type == "backward")
    assert bop.attrs["static_loss_scaling"] == 128.0
    feed = _feed()
    r = [float(ref.step(feed)[0].ravel()[0]) for _ in range(STEPS)]
    t = [float(port.step(feed)[0].ravel()[0]) for _ in range(STEPS)]
    np.testing.assert_allclose(t, r, rtol=LOSS_RTOL)


def test_amp_flags_override_level_and_dtype():
    """FLAGS_tpu_amp_level O0 leaves a decorated program undecorated;
    FLAGS_tpu_amp_dtype float16 turns a bf16 decoration into float16
    with its scale state; "float8_e4m3" raises, naming the queue item."""
    saved = tflags.get_flags(["FLAGS_tpu_amp_level", "FLAGS_tpu_amp_dtype"])
    try:
        tflags.set_flags({"FLAGS_tpu_amp_level": "O0"})
        main, _, _, d, _ = _mlp(tfluid, tmp, "sgd")
        assert not getattr(main, "_amp", False) and d._scale_state is None
        tflags.set_flags({"FLAGS_tpu_amp_level": "",
                          "FLAGS_tpu_amp_dtype": "float16"})
        main, _, _, d, _ = _mlp(tfluid, tmp, "sgd", amp_dtype="bfloat16")
        assert main._amp_dtype == "float16" and d._scale_state is not None
        tflags.set_flags({"FLAGS_tpu_amp_dtype": "float8_e4m3"})
        with pytest.raises(NotImplementedError, match="#10"):
            _mlp(tfluid, tmp, "sgd")
    finally:
        tflags.set_flags(saved)


@pytest.mark.parametrize("scale", [16.0, OVERFLOW])
def test_fp16_captured_step_equals_eager(scale):
    """The captured path (the step on static buffers, as a replay runs
    it) equals eager runs bit for bit, clean and overflowing;
    `capture_blocker` lets a float16 program be captured."""
    def build(fluid, mp):
        return _mlp(fluid, mp, "adam", init_loss_scaling=scale)

    ref = _Ref(build)
    start = ref.state()
    eager, graph = _Port(build, start), _Port(build, start, graph=True)
    block = graph.main.global_block()
    assert lowering.capture_blocker(graph.main, block) is None
    feed = _feed()
    for _ in range(STEPS):
        a, b = eager.step(feed)[0], graph.step(feed)[0]
        np.testing.assert_array_equal(a, b)
    assert graph.exe.last_entry.mode == "graph"
    ea, gr = eager.state(), graph.state()
    for n in ea:
        assert torch.equal(ea[n], gr[n]), n


def test_fp16_explicit_sync_warns_and_passes_the_scale_through():
    """A fleet-transpiled program sums its gradients with ops after the
    backward: loss scaling is not wired there, the lowering says so, and
    the scale state passes through unchanged (as the reference does)."""
    from paddle_tpu_torch import fleet

    main, startup, loss, d, _ = _mlp(tfluid, tmp, "sgd",
                                     init_loss_scaling=1024.0)
    fleet.transpile_collective(main, nranks=2)
    assert any(op.type == "c_allreduce_sum"
               for op in main.global_block().ops)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    assert any("explicit-sync" in str(w.message) for w in rec), \
        [str(w.message) for w in rec]
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    assert float(scope.find_var(d._scale_state["scale"])) == 1024.0


def test_gradient_merge_warning_wording():
    """The decorator's warning where gradient merge owns the update
    cadence, as the reference words it."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name_guard():
        x = tfluid.layers.data(name="img", shape=[32], dtype="float32")
        loss = tfluid.layers.mean(tfluid.layers.fc(input=x, size=4))
        opt = tfluid.optimizer.SGDOptimizer(0.1)
        params_grads = opt.backward(loss)
        bop = next(op for op in main.global_block().ops
                   if op.type == "backward")
        bop.attrs["gradient_merge"] = {"k_steps": 2}
        d = tmp.decorate(opt, amp_dtype="float16")
        d._optimizer = type("Done", (), {
            "minimize": lambda self, *a, **k: ([], params_grads)})()
        with pytest.warns(UserWarning, match="not wired under gradient "
                          "merge"):
            d.minimize(loss)
    assert d._scale_state is None


# -- BERT with LAMB under float16 ------------------------------------------

SEQ, BATCH = 16, 2


def _bert_cfg(bert):
    cfg = bert.BertConfig.tiny()
    cfg.num_hidden_layers = 2
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _bert(fluid, mp):
    bert = rbert if fluid is rfluid else tbert
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        total, _, _, _ = bert.bert_pretrain_loss(_bert_cfg(bert), SEQ,
                                                 scan_layers=True)
        opt = fluid.optimizer.LambOptimizer(
            1e-3, lamb_weight_decay=0.01,
            exclude_from_weight_decay_fn=lambda p: "ln" in p.name
            or ".b" in p.name,
            grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0))
        d = mp.decorate(opt, amp_dtype="float16", amp_level="O2",
                        init_loss_scaling=2.0 ** 15,
                        use_dynamic_loss_scaling=True)
        d.minimize(total)
        fluid.fuse_optimizer_ops(main)
    return main, startup, total, d, None


def test_bert_lamb_float16_matches_reference():
    """BERT-tiny (2 layers, scanned) pretraining with LAMB, global-norm
    clipping and float16 O2 dynamic scaling, as chip_smoke.py's phase 17
    builds it at full width: 3 steps against the reference (losses within
    5e-3, scale state exact, float16 params within 2e-3); the LAMB update
    keeps the reference's exclusions from weight decay."""
    ref = _Ref(_bert)
    port = _Port(_bert, ref.state())
    assert [op.type for op in port.main.global_block().ops] == \
        [op.type for op in ref.main.global_block().ops]
    feed = tbert.bert_feed(_bert_cfg(tbert), BATCH, SEQ)
    r = [float(ref.step(feed)[0].ravel()[0]) for _ in range(STEPS)]
    t = [float(port.step(feed)[0].ravel()[0]) for _ in range(STEPS)]
    np.testing.assert_allclose(t, r, rtol=LOSS_RTOL)
    dls = port.opt._scale_state
    ps, rs = port.state(), ref.state()
    for k in ("scale", "good", "bad"):
        assert _np(ps[dls[k]]).tolist() == _np(rs[dls[k]]).tolist(), k
    for n, want in rs.items():
        if str(want.dtype) == "float16":
            np.testing.assert_allclose(_np(ps[n]), _np(want), rtol=F16_RTOL,
                                       atol=2e-3, err_msg=n)


# -- data parallelism at 2 gloo ranks --------------------------------------

def test_fp16_data_parallel_matches_reference(tmp_path):
    """2 gloo ranks (`tests/torch_amp_runner.py`) against the reference on
    a 2-device mesh, from the same start states and global batches:
    float16 O2 dynamic scaling replicated and under the sharded update,
    with an overflow that lands in rank 0's shard only (both ranks and
    the reference skip that step: the found-inf count is all-reduced),
    and LAMB and LARS under the sharded update (their norms summed over
    the shards). float16: scale state exact, losses within 5e-3, params
    within 2e-3; float32: rtol 1e-5. The two ranks agree bit for bit."""
    d = str(tmp_path)
    runner.write_starts(d)
    sc = distributed.spawn(runner.run, (d,), nprocs=2, backend="gloo",
                           join=False)
    ref = runner.reference(d, 2)
    sc.join(240)
    for case in runner.CASES:
        ranks = [dict(np.load(os.path.join(d, "%s.rank%d.npz" % (case, r))))
                 for r in range(2)]
        for n in ranks[0]:
            assert np.array_equal(ranks[0][n], ranks[1][n]), (case, n)
        got, want = ranks[0], ref[case]
        assert (int(got["__sharded__"]) > 0) == (case != "f16_replicated")
        f16 = case.startswith("f16")
        rtol = LOSS_RTOL if f16 else 1e-5
        np.testing.assert_allclose(got["__losses__"].ravel(),
                                   want["__losses__"].ravel(), rtol=rtol,
                                   err_msg=case)
        for n, w in want.items():
            if n == "__losses__":
                continue
            g = np.asarray(got[n])
            if f16 and ("loss_scaling" in n or "num_" in n):
                assert g.tolist() == np.asarray(w).tolist(), (case, n)
            elif f16:
                np.testing.assert_allclose(
                    g.astype(np.float32), np.asarray(w).astype(np.float32),
                    rtol=F16_RTOL, atol=2e-3, err_msg=(case, n))
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                           err_msg=(case, n))
        if f16:
            # steps 0, 1 clean (the scale doubles after the second), the
            # spike overflows (halved), the last is clean again
            scale = next(n for n in want if "loss_scaling" in n)
            assert float(got[scale]) == 256.0
