"""BERT pretraining in the port's fluid static graph (paddle_tpu_torch,
on the CPU) against the JAX package's, at `BertConfig.tiny` (vocab 1024,
hidden 64, 2 layers, 4 heads, FFN 128), sequence 32, batch 4, with the
reference's synthetic masked-LM feed.

Both packages build the same program in fresh programs; the reference's
startup program runs and every persistable of its scope (with AMP O2 the
fp32 masters and the bf16 live params) is carried into the port's scope
with `load_numpy_state`. Dropout is off (the generator streams differ).
Then 3 Adam steps: losses within rtol 1e-5 in float32, unrolled and
scanned; within rtol 1e-2 with bf16 AMP O2 and `fuse_optimizer_ops`, as
bench.py builds it. Within the port: the scanned encoder equals the
unrolled one (stacked from its values), with remat on and off; each layer
of the scan draws its own dropout masks, and remat's recompute draws the
same ones. Each reference program runs once per module (fixtures)."""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rfluid
from paddle_tpu.core.scope import Scope as RScope
from paddle_tpu.fluid.contrib import mixed_precision as rmp
from paddle_tpu.models import bert as rbert

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.scope import dump_numpy_state, load_numpy_state
from paddle_tpu_torch.fluid.contrib import mixed_precision as tmp
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import registry as treg

SEQ, BATCH, STEPS = 32, 4, 3
FP32_RTOL, AMP_RTOL = 1e-5, 1e-2
#: (scan_layers, amp) of each reference run
RUNS = {"unrolled": (False, False), "scanned": (True, False),
        "scanned_amp": (True, True)}


def _cfg(dropout=0.0):
    cfg = tbert.BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = dropout
    return cfg


def _build(fluid, mp, bert, cfg, scan, amp, remat=False, is_test=False):
    """The pretraining program as bench.py builds it (AMP: decorate with
    bf16 O2 over Adam, then fuse_optimizer_ops); Adam at lr 1e-3."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        total, _, _, _ = bert.bert_pretrain_loss(
            cfg, SEQ, is_test=is_test, scan_layers=scan, scan_remat=remat)
        if not is_test:
            opt = fluid.optimizer.AdamOptimizer(1e-3)
            if amp:
                opt = mp.decorate(opt, use_dynamic_loss_scaling=False)
            opt.minimize(total)
            if amp:
                fluid.fuse_optimizer_ops(main)
    return main, startup, total


def _port_steps(main, total, state, feed, steps=STEPS):
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    load_numpy_state(scope, state, "cpu")
    losses = [float(exe.run(main, feed=feed, fetch_list=[total],
                            scope=scope)[0][0]) for _ in range(steps)]
    return losses, scope


@pytest.fixture(scope="module")
def feed():
    return tbert.bert_feed(_cfg(), BATCH, SEQ)


def _forward_outputs(main):
    """The global block's forward results (every op's Out, Y, Result or
    Loss before the backward section), in order."""
    names = []
    for op in main.global_block().ops:
        if op.type == "backward":
            break
        for slot in ("Out", "Y", "Result", "Loss"):
            names.extend(n for n in op.output_names.get(slot, [])
                         if n not in names)
    return names


@pytest.fixture(scope="module")
def reference(feed):
    """name -> (program, startup state, per-step losses, the first
    step's forward results by name) of the JAX package's run."""
    out = {}
    for name, (scan, amp) in RUNS.items():
        main, startup, total = _build(rfluid, rmp, rbert, _cfg(), scan, amp)
        exe = rfluid.Executor(rfluid.CPUPlace())
        scope = RScope()
        exe.run(startup, scope=scope)
        state = {v.name: np.asarray(scope.find_var(v.name))
                 for v in main.list_vars() if v.persistable}
        fetch = [total.name] + (_forward_outputs(main) if amp else [])
        runs = [[np.asarray(v) for v in exe.run(
            main, feed=feed, fetch_list=fetch, scope=scope)]
            for _ in range(STEPS)]
        out[name] = (main, state, [float(r[0].ravel()[0]) for r in runs],
                     dict(zip(fetch, runs[0])))
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_losses_match_reference(name, reference, feed):
    scan, amp = RUNS[name]
    _, state, want, _ = reference[name]
    main, _, total = _build(tfluid, tmp, tbert, _cfg(), scan, amp)
    got, _ = _port_steps(main, total, state, feed)
    np.testing.assert_allclose(got, want,
                               rtol=AMP_RTOL if amp else FP32_RTOL)
    assert got[-1] < got[0]


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
    """The scanned AMP program with fused Adam, built in both packages:
    equal blocks, ops, slots, attrs, var shapes and dtypes (bf16 live
    params and grads, fp32 masters, one fused_adam, the trailing casts)."""
    r_main = reference["scanned_amp"][0]
    t_main, _, _ = _build(tfluid, tmp, tbert, _cfg(), True, True)
    assert _program_record(t_main) == _program_record(r_main)
    types = [op.type for op in t_main.global_block().ops]
    assert types.count("fused_adam") == 1 and "adam" not in types
    assert t_main.global_block().var("enc_qkv.w").dtype == "bfloat16"
    assert t_main.global_block().var("enc_qkv.w@MASTER").dtype == "float32"


def test_amp_forward_dtypes_match_reference(reference, feed):
    """Under bf16 AMP O2 every forward result of the global block has the
    reference's dtype (bf16 out of the white-list products and the ops
    that follow them, float32 out of the black-list ones and the
    layer norms) and, on the first step, its value within 2e-2."""
    r_main, state, _, r_vals = reference["scanned_amp"]
    main, _, _ = _build(tfluid, tmp, tbert, _cfg(), True, True)
    names = _forward_outputs(main)
    assert names == _forward_outputs(r_main)
    scope = tfluid.Scope()
    load_numpy_state(scope, state, "cpu")
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed=feed, fetch_list=names, scope=scope)
    dtypes = set()
    for n, g in zip(names, got):
        want = r_vals[n]
        assert g.dtype == want.dtype and g.shape == want.shape, n
        dtypes.add(str(g.dtype))
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(g, want, err_msg=n)
        else:
            np.testing.assert_allclose(g.astype("float32"),
                                       want.astype("float32"), rtol=2e-2,
                                       atol=2e-2, err_msg=n)
    assert {"bfloat16", "float32"} <= dtypes


def test_amp_state_crosses_bit_for_bit(reference):
    """The reference's bf16 live params load into the port's scope bit
    for bit (a uint16 view, never through float32) and dump back the
    same; the port's own startup makes bf16 live params that are the
    cast of their fp32 masters."""
    state = reference["scanned_amp"][1]
    scope = tfluid.Scope()
    load_numpy_state(scope, state, "cpu")
    bf16 = [n for n, a in state.items() if str(a.dtype) == "bfloat16"]
    assert "enc_qkv.w" in bf16 and "word_embedding" in bf16
    back = dump_numpy_state(scope, bf16)
    for n in bf16:
        assert scope.find_var(n).dtype == torch.bfloat16
        np.testing.assert_array_equal(back[n].view(np.uint16),
                                      state[n].view(np.uint16))

    main, startup, _ = _build(tfluid, tmp, tbert, _cfg(), True, True)
    own = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=own)
    for n in bf16:
        live, master = own.find_var(n), own.find_var(n + "@MASTER")
        assert (live.dtype, master.dtype) == (torch.bfloat16, torch.float32)
        torch.testing.assert_close(live, master.bfloat16(), rtol=0, atol=0)


def _stack_unrolled(vals, cfg):
    """The scan path's stacked [L, ...] params from the unrolled
    per-layer values (q | k | v fused on the output axis)."""
    L = cfg.num_hidden_layers
    out = {}
    for suffix in ("w", "b"):
        axis = 1 if suffix == "w" else 0
        out["enc_qkv." + suffix] = np.stack([np.concatenate(
            [vals["layer_%d_attn_%s.%s" % (i, p, suffix)]
             for p in "qkv"], axis=axis) for i in range(L)])
    for scan_name, fmt in [
            ("enc_attn_out.%s", "layer_%d_attn_out.%s"),
            ("enc_ffn0.%s", "layer_%d_ffn0.%s"),
            ("enc_ffn1.%s", "layer_%d_ffn1.%s")]:
        for suffix in ("w", "b"):
            out[scan_name % suffix] = np.stack(
                [vals[fmt % (i, suffix)] for i in range(L)])
    for ln in ("post_att_ln", "post_ffn_ln"):
        for suffix in ("scale", "bias"):
            out["enc_%s.%s" % (ln, suffix)] = np.stack(
                [vals["layer_%d_%s.%s" % (i, ln, suffix)]
                 for i in range(L)])
    return out


@pytest.mark.parametrize("remat", [False, True])
def test_scanned_equals_unrolled(remat, reference, feed):
    """Same parameter values (the scan's stacked from the unrolled
    ones): equal losses over 3 Adam steps, within the port."""
    state = reference["unrolled"][1]
    cfg = _cfg()
    main_u, _, tot_u = _build(tfluid, tmp, tbert, cfg, False, False)
    main_s, start_s, tot_s = _build(tfluid, tmp, tbert, cfg, True, False,
                                    remat=remat)
    want, _ = _port_steps(main_u, tot_u, state, feed)
    # the scan program's own startup (its Adam moments and beta powers),
    # then the shared and stacked values over its params
    own = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(start_s, scope=own)
    names = [v.name for v in main_s.list_vars() if v.persistable]
    scan_state = dict(dump_numpy_state(own, names))
    scan_state.update((n, v) for n, v in dict(
        state, **_stack_unrolled(state, cfg)).items() if n in scan_state
        and not n.startswith("AdamOptimizer"))
    got, _ = _port_steps(main_s, tot_s, scan_state, feed)
    np.testing.assert_allclose(got, want, rtol=FP32_RTOL)


def _record_dropout_masks(monkeypatch):
    masks = []
    opdef = treg.get_op("dropout")
    compute = opdef.compute

    def spy(ins, attrs):
        outs = compute(ins, attrs)
        if not attrs.get("is_test", False):
            masks.append(outs["Mask"].clone())
        return outs

    monkeypatch.setattr(opdef, "compute", spy)
    return masks


def test_scan_layers_draw_their_own_masks_and_remat_redraws_them(
        monkeypatch, feed):
    """With dropout on: each layer of the scan draws its own masks, the
    recompute under remat draws exactly the forward's again, and a step
    with remat equals a step without it (same masks, same math)."""
    cfg = _cfg(dropout=0.1)
    main, startup, total = _build(tfluid, tmp, tbert, cfg, True, False,
                                  remat=True)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    names = [v.name for v in main.list_vars() if v.persistable]
    state = dump_numpy_state(scope, names)
    masks = _record_dropout_masks(monkeypatch)
    with_remat = exe.run(main, feed=feed, fetch_list=[total], scope=scope)
    # embedding dropout, 2 layers x 2 in the forward, their recompute
    assert len(masks) == 1 + 4 + 4
    forward, recompute = masks[1:5], masks[5:]
    for i in range(4):
        for j in range(i + 1, 4):
            assert not torch.equal(forward[i], forward[j]), (i, j)
    # the backward recomputes the last layer first
    for got, want in zip(recompute, forward[2:] + forward[:2]):
        assert torch.equal(got, want)
    monkeypatch.undo()

    main_n, _, total_n = _build(tfluid, tmp, tbert, cfg, True, False,
                                remat=False)
    without, scope_n = _port_steps(main_n, total_n, state, feed, steps=1)
    np.testing.assert_allclose(with_remat[0][0], without[0], rtol=1e-6)
    for n in ("enc_ffn0.w", "enc_qkv.w", "word_embedding"):
        torch.testing.assert_close(scope.find_var(n), scope_n.find_var(n),
                                   rtol=1e-6, atol=1e-7)


def test_unported_paths_raise():
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()), \
            tfluid.unique_name_guard():
        with pytest.raises(NotImplementedError, match="Queue 1 #5"):
            tbert.build_bert_pretrain(_cfg(), SEQ, use_lamb=True)
        with pytest.raises(NotImplementedError, match="float16"):
            tmp.decorate(tfluid.optimizer.AdamOptimizer(1e-3),
                         amp_dtype="float16")
