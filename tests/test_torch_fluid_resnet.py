"""ResNet50 training in the port's fluid static graph (paddle_tpu_torch,
on the CPU) against the JAX package's: full depth (bottleneck blocks
[3, 4, 6, 3], widths 64-2048), 32 x 32 images, batch 4, 10 classes,
Momentum(3e-3, 0.9), `scan_stages` on and off.

The reference's startup program runs once, for the unrolled program, and
each residual branch's last BN scale (`*_branch2c_bn_scale`) is then set
to 0, the zero-gamma start of Goyal et al. 2017 ("Accurate, Large
Minibatch SGD", section 5.1). From the plain random start this model is
chaotic under batch statistics: the gradients grow about 3e4-fold from
the head to conv1, so a 1e-7 relative change of the input images moves
the reference's own first-step gradients by 2% (median over the
parameters) and its scanned and unrolled programs, the same math,
differ by 1.7e-4 in the first loss and 26% in the second. No two
float32 implementations can agree to 1e-4 there; from the zero-gamma
start the reference against itself stays within 1e-6 (loss) and 3e-5
(gradients), and every op still runs and moves its state.

The scanned programs start from the same values, their stacked [L, ...]
conv, BN and running-statistic vars stacked from the unrolled blocks'
(the recipe of `tests/test_resnet_scan.py`), and the bf16 AMP O2 program
from those as fp32 masters and their bf16 casts. Each state goes into
both packages (`load_numpy_state` for the port). Then 3 steps:
- float32, unrolled and scanned: losses within 1e-4 relative, every BN
  running statistic after the steps within 1e-4 and every parameter's
  first-step gradient within 1e-3, relative in norm;
- within the port, scanned equals unrolled: losses and running
  statistics within 2e-5 (the reference test's tolerance);
- bf16 AMP O2 with `fuse_optimizer_ops` (one `fused_momentum`): losses
  within 2e-2, every forward result's dtype equal to the reference's,
  and the program equal op by op.
`build_resnet_train` (Momentum with L2Decay, accuracy) at depth 18
(basic blocks) runs 3 steps from the port's startup state (zero-gamma)
carried into the reference: losses within 1e-4, accuracies equal; then
its is_test program, and the port's for_test clone. Each reference
program runs once per module (fixtures)."""
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu.fluid as rfluid
from paddle_tpu.core.scope import Scope as RScope
from paddle_tpu.fluid.contrib import mixed_precision as rmp
from paddle_tpu.models import resnet as rresnet

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.scope import dump_numpy_state, load_numpy_state
from paddle_tpu_torch.fluid.contrib import mixed_precision as tmp
from paddle_tpu_torch.models import resnet as tresnet

IMG, CLASSES, BATCH, STEPS, LR = 32, 10, 4, 3, 3e-3
FP32_RTOL, GRAD_RTOL, SCAN_RTOL, AMP_RTOL = 1e-4, 1e-3, 2e-5, 2e-2
COUNTS = (3, 4, 6, 3)


def _build(fluid, mp, resnet, scan, amp=False):
    """ResNet50 over [3, IMG, IMG] images with Momentum (AMP: decorated
    with bf16 O2, then fuse_optimizer_ops, as bench.py builds it):
    (main, loss, gradient names)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 6
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        img = fluid.layers.data("image", shape=[3, IMG, IMG],
                                dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        logits = resnet.resnet(img, class_dim=CLASSES, depth=50,
                               scan_stages=scan)
        loss = fluid.layers.mean(
            fluid.layers.loss.softmax_with_cross_entropy(logits, label))
        opt = fluid.optimizer.MomentumOptimizer(LR, momentum=0.9)
        if amp:
            opt = mp.decorate(opt, use_dynamic_loss_scaling=False)
        _, params_grads = opt.minimize(loss)
        if amp:
            fluid.fuse_optimizer_ops(main)
    return main, startup, loss, sorted(g.name for _, g in params_grads)


def _feed():
    r = np.random.RandomState(0)
    return {"image": r.randn(BATCH, 3, IMG, IMG).astype("float32"),
            "label": r.randint(0, CLASSES, (BATCH, 1)).astype("int64")}


def _stack_unrolled(vals, tail=""):
    """The scanned stages' stacked vars from the unrolled blocks' in
    `vals` (those ending in `tail`, e.g. "@GRAD"):
    res{s}_{b}_branch{suf}_{kind}{tail} -> res{s}_scan{suf}_{kind}{tail}
    [b - 1]."""
    out = {}
    for stage, count in enumerate(COUNTS):
        s = stage + 2
        for suf in ("2a", "2b", "2c"):
            for kind in ("weights", "bn_scale", "bn_offset", "bn_mean",
                         "bn_var"):
                rows = ["res%d_%d_branch%s_%s%s" % (s, b, suf, kind, tail)
                        for b in range(1, count)]
                if rows[0] in vals:
                    out["res%d_scan%s_%s%s" % (s, suf, kind, tail)] = \
                        np.stack([vals[r] for r in rows])
    return out


#: name prefixes of the unrolled blocks that the scanned program stacks
_TAIL_BLOCKS = tuple("res%d_%d_" % (stage + 2, b)
                     for stage, count in enumerate(COUNTS)
                     for b in range(1, count))


def _as_scanned(vals, tail=""):
    """`vals` of the unrolled program under the scanned program's names:
    the tail blocks' values stacked, the rest as they are."""
    out = {n: v for n, v in vals.items() if not n.startswith(_TAIL_BLOCKS)}
    out.update(_stack_unrolled(vals, tail))
    return out


def _state_for(main, vals):
    """Every persistable of `main` from the unrolled values `vals`:
    stacked where the program scans, a zero velocity where it has no
    value; with AMP O2 each master is the fp32 value and its live param
    the bf16 cast."""
    vals = dict(vals, **_stack_unrolled(vals))
    masters = getattr(main, "_amp_master_of", {})
    state = {}
    for v in main.list_vars():
        if not v.persistable:
            continue
        n = v.name
        if n in vals:
            state[n] = vals[n]
        elif n.endswith("@MASTER"):
            state[n] = vals[n[:-len("@MASTER")]]
        else:
            assert "velocity" in n, n
            state[n] = np.zeros(v.shape, "float32")
    for p in masters:
        state[p] = np.asarray(jnp.asarray(vals[p]).astype(jnp.bfloat16))
    return state


def _stat_names(state):
    return sorted(n for n in state if n.endswith(("_bn_mean", "_bn_var")))


def _forward_outputs(main):
    """The global block's forward results (every op's Out, Y, Output or
    Loss before the backward section), in order."""
    names = []
    for op in main.global_block().ops:
        if op.type == "backward":
            break
        for slot in ("Out", "Y", "Output", "Loss"):
            names.extend(n for n in op.output_names.get(slot, [])
                         if n not in names)
    return names


def _ref_run(main, loss, state, extra):
    """STEPS reference steps from `state`: (losses, the first step's
    `extra` fetches by name, the scope after the steps)."""
    exe = rfluid.Executor(rfluid.CPUPlace())
    scope = RScope()
    for n, v in state.items():
        scope.set_var(n, jnp.asarray(v))
    runs = [[np.asarray(v) for v in exe.run(
        main, feed=_feed(), fetch_list=[loss.name] + extra, scope=scope)]
        for _ in range(STEPS)]
    return ([float(r[0].ravel()[0]) for r in runs],
            dict(zip(extra, runs[0][1:])), scope)


def _port_run(main, loss, state, extra):
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    load_numpy_state(scope, state, "cpu")
    runs = [exe.run(main, feed=_feed(), fetch_list=[loss] + extra,
                    scope=scope) for _ in range(STEPS)]
    return ([float(r[0].ravel()[0]) for r in runs],
            dict(zip(extra, runs[0][1:])), scope)


@pytest.fixture(scope="module")
def reference():
    """name -> (program, start state, losses, first-step fetches,
    running statistics after the steps) of the JAX package's float32
    unrolled run (its gradients and statistics under the scanned
    program's names, stacked) and its scanned AMP run."""
    main_u, start_u, loss_u, grads_u = _build(rfluid, rmp, rresnet, False)
    exe = rfluid.Executor(rfluid.CPUPlace())
    scope = RScope()
    exe.run(start_u, scope=scope)
    vals = {v.name: np.asarray(scope.find_var(v.name))
            for v in main_u.list_vars() if v.persistable}
    vals.update((n, np.zeros_like(v)) for n, v in vals.items()
                if n.endswith("_branch2c_bn_scale"))
    losses, grads, rscope = _ref_run(main_u, loss_u, vals, grads_u)
    stats = {n: np.asarray(rscope.find_var(n)) for n in _stat_names(vals)}
    out = {"fp32": (main_u, vals, losses, _as_scanned(grads, "@GRAD"),
                    _as_scanned(stats))}
    main, _, loss, _ = _build(rfluid, rmp, rresnet, True, True)
    state = _state_for(main, vals)
    out["amp"] = (main, state) + _ref_run(
        main, loss, state, _forward_outputs(main))[:2]
    return out


@pytest.fixture(scope="module")
def port(reference):
    """The port's float32 runs from the reference's start state:
    losses, first-step gradients and running statistics, under the
    scanned program's names (the unrolled program's stacked)."""
    out = {}
    for name, scan in (("unrolled", False), ("scanned", True)):
        main, _, loss, grads = _build(tfluid, tmp, tresnet, scan)
        state = _state_for(main, reference["fp32"][1])
        losses, fetched, scope = _port_run(main, loss, state, grads)
        stats = dump_numpy_state(scope, _stat_names(state))
        out[name] = (losses, _as_scanned(fetched, "@GRAD"),
                     _as_scanned(stats))
    return out


def _rel(a, b):
    a, b = np.asarray(a, "float64"), np.asarray(b, "float64")
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("name", ["unrolled", "scanned"])
def test_fp32_steps_match_reference(name, reference, port):
    """Losses, first-step gradients and the running statistics after 3
    Momentum steps, against the reference's unrolled run (the unrolled
    programs' gradients and statistics stacked as the scan's)."""
    _, start, want, r_grads, r_stats = reference["fp32"]
    start = _as_scanned(start)
    got, t_grads, t_stats = port[name]
    np.testing.assert_allclose(got, want, rtol=FP32_RTOL)
    assert sorted(t_grads) == sorted(r_grads) and len(t_grads) == 89
    bad = {n: _rel(t_grads[n], r_grads[n]) for n in r_grads
           if _rel(t_grads[n], r_grads[n]) > GRAD_RTOL}
    assert not bad, bad
    bad = {n: _rel(t_stats[n], r_stats[n]) for n in r_stats
           if _rel(t_stats[n], r_stats[n]) > FP32_RTOL}
    assert not bad, bad
    # training moved every row of every running statistic
    for n, v in t_stats.items():
        assert (v != start[n]).any(axis=-1).all(), n


def test_scanned_equals_unrolled(port):
    """Under shared weights the scanned stages compute what the unrolled
    blocks do: equal losses, first-step gradients and running statistics
    (the scan's stacked rows against the blocks' own)."""
    lu, gu, su = port["unrolled"]
    ls, gs, ss = port["scanned"]
    np.testing.assert_allclose(ls, lu, rtol=SCAN_RTOL)
    assert sorted(gs) == sorted(gu) and sorted(ss) == sorted(su)
    for n in gs:
        assert _rel(gs[n], gu[n]) <= SCAN_RTOL, n
    for n in ss:
        np.testing.assert_allclose(ss[n], su[n], rtol=SCAN_RTOL, atol=1e-6,
                                   err_msg=n)


def _program_record(program):
    """Every block's ops (type, slots, attrs) and vars (shape, dtype,
    persistable), in order."""
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


def test_amp_program_matches_reference_op_by_op(reference):
    """The scanned bf16 AMP O2 program with fused Momentum: equal blocks,
    ops, slots, attrs, var shapes and dtypes."""
    r_main = reference["amp"][0]
    t_main, _, _, _ = _build(tfluid, tmp, tresnet, True, True)
    assert _program_record(t_main) == _program_record(r_main)
    types = [op.type for op in t_main.global_block().ops]
    assert types.count("fused_momentum") == 1 and "momentum" not in types
    assert types.count("scan") == 4
    gb = t_main.global_block()
    assert gb.var("res3_scan2b_weights").dtype == "bfloat16"
    assert gb.var("res3_scan2b_weights@MASTER").dtype == "float32"
    assert gb.var("res3_scan2b_bn_mean").dtype == "float32"


def test_amp_matches_reference(reference):
    """bf16 AMP O2 with fused Momentum: losses within 2e-2 over 3 steps,
    and on the first step every forward result has the reference's dtype
    and shape (bf16 out of the convolutions, float32 out of batch_norm
    and the ops that follow it)."""
    r_main, state, want, r_vals = reference["amp"]
    main, _, loss, _ = _build(tfluid, tmp, tresnet, True, True)
    names = _forward_outputs(main)
    assert names == list(r_vals)
    got, t_vals, _ = _port_run(main, loss, state, names)
    np.testing.assert_allclose(got, want, rtol=AMP_RTOL)
    assert np.isfinite(got).all()
    dtypes = {}
    for n in names:
        assert (t_vals[n].dtype, t_vals[n].shape) == \
            (r_vals[n].dtype, r_vals[n].shape), n
        dtypes.setdefault(str(t_vals[n].dtype), n)
    assert {"bfloat16", "float32"} <= set(dtypes)


def _build_train(fluid, resnet, is_test=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 6
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        loss, acc, feeds = resnet.build_resnet_train(
            image_shape=(3, IMG, IMG), class_dim=CLASSES, depth=18, lr=LR,
            is_test=is_test)
    return main, startup, loss, acc, feeds


def test_build_resnet_train_matches_reference():
    """ResNet18 (basic blocks) with Momentum and L2Decay(1e-4): 3 steps
    equal, accuracies equal; then the is_test program (running
    statistics, no update) from the trained state, and the port's
    for_test clone of the training program agrees with it."""
    t_main, t_start, t_loss, t_acc, feeds = _build_train(tfluid, tresnet)
    r_main, _, r_loss, r_acc, _ = _build_train(rfluid, rresnet)
    assert feeds == ["image", "label"]
    types = [op.type for op in t_main.global_block().ops]
    assert types.count("momentum") > 20 and "sign" not in types
    assert types.count("scale") == types.count("momentum")
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(t_start, scope=scope)
    names = [v.name for v in t_main.list_vars() if v.persistable]
    state = dump_numpy_state(scope, names)
    # zero-gamma, as above: a basic block's branch ends in its 2b BN
    state.update((n, np.zeros_like(v)) for n, v in state.items()
                 if n.endswith("_branch2b_bn_scale"))
    load_numpy_state(scope, state, "cpu")

    r_exe = rfluid.Executor(rfluid.CPUPlace())
    r_scope = RScope()
    for n, v in state.items():
        r_scope.set_var(n, jnp.asarray(v))
    want = [r_exe.run(r_main, feed=_feed(), fetch_list=[r_loss, r_acc],
                      scope=r_scope) for _ in range(STEPS)]
    got = [exe.run(t_main, feed=_feed(), fetch_list=[t_loss, t_acc],
                   scope=scope) for _ in range(STEPS)]
    np.testing.assert_allclose([g[0][0] for g in got],
                               [float(np.asarray(w[0])[0]) for w in want],
                               rtol=FP32_RTOL)
    assert [float(g[1][0]) for g in got] == \
        [float(np.asarray(w[1])[0]) for w in want]

    r_test, _, r_tloss, r_tacc, _ = _build_train(rfluid, rresnet, True)
    t_test, _, t_tloss, t_tacc, _ = _build_train(tfluid, tresnet, True)
    want = r_exe.run(r_test, feed=_feed(), fetch_list=[r_tloss, r_tacc],
                     scope=r_scope)
    got = exe.run(t_test, feed=_feed(), fetch_list=[t_tloss, t_tacc],
                  scope=scope)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=FP32_RTOL)
    assert float(got[1][0]) == float(np.asarray(want[1])[0])
    before = dump_numpy_state(scope, names)
    clone = exe.run(t_main.clone(for_test=True), feed=_feed(),
                    fetch_list=[t_loss, t_acc], scope=scope)
    np.testing.assert_allclose(clone[0], got[0], rtol=1e-6)
    after = dump_numpy_state(scope, names)
    for n in names:
        np.testing.assert_array_equal(after[n], before[n], err_msg=n)


def test_scan_stages_rejects_basic_blocks():
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()), \
            tfluid.unique_name_guard():
        img = tfluid.layers.data("image", shape=[3, IMG, IMG],
                                 dtype="float32")
        with pytest.raises(ValueError, match="bottleneck"):
            tresnet.resnet(img, class_dim=CLASSES, depth=18,
                           scan_stages=True)
