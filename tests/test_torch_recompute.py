"""Activation recompute in the port (paddle_tpu_torch, on the CPU)
against the JAX package: `append_backward(checkpoints=...)`,
`RecomputeOptimizer` and the lowering's recompute segments
(`fluid/lowering.py _remat_segments`, run under non-reentrant
`torch.utils.checkpoint`), mirroring `tests/test_recompute.py:51-126`.

- The backward op carries the same checkpoints in both packages, and
  the forward splits into the same segments (bounds equal; what leaves
  each segment a subset of what the reference keeps, since the port
  leaves out the names that only pass through).
- The MLP of tests/test_recompute.py (64-128-128-128-10, SGD 0.1,
  checkpoints at the first two hidden layers) from the reference's
  startup state: 4 steps' losses and every parameter within fp32 rtol
  1e-5 of the reference's recompute run; within the port, with a dropout
  layer on, recompute against no recompute bit for bit (the recomputed
  forward draws the same masks), and the recomputed forward runs every
  segment's ops again (twice the `mul` launches of a step).
- BertConfig.tiny, unrolled, checkpoints at each encoder layer's output
  (`bert_pretrain_loss(checkpoints_out=...)`), Adam 1e-3, from the
  reference's startup state with dropout off: 3 steps' losses within
  1e-5 of the reference's recompute run (held once per module in a
  fixture); with dropout 0.1 in the port, recompute against none bit
  for bit, losses and every persistable.
- The graph path (a captured step's static buffers and write-back, run
  on the CPU through `graph_runner`) equal to eager bit for bit under
  recompute.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as rfluid
from paddle_tpu.core.scope import Scope as RScope
from paddle_tpu.fluid import lowering as rlowering
from paddle_tpu.models import bert as rbert

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.scope import dump_numpy_state, load_numpy_state
from paddle_tpu_torch.fluid import lowering as tlowering
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import registry as treg

RTOL, ATOL = 1e-5, 1e-6
MLP_STEPS, BERT_STEPS, SEQ, BATCH = 4, 3, 32, 4


def _runner(body):
    return body()


def _mlp(fluid, recompute, dropout=None, via_backward=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        x = fluid.layers.data(name="x", shape=[64], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h1 = fluid.layers.fc(input=x, size=128, act="relu")
        if dropout:
            h1 = fluid.layers.dropout(
                h1, dropout, dropout_implementation="upscale_in_train")
        h2 = fluid.layers.fc(input=h1, size=128, act="relu")
        h3 = fluid.layers.fc(input=h2, size=128, act="relu")
        logits = fluid.layers.fc(input=h3, size=10)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        if via_backward:
            fluid.backward.append_backward(loss, checkpoints=[h1, h2.name])
            return main, startup, loss
        opt = fluid.optimizer.SGDOptimizer(learning_rate=0.1)
        if recompute:
            opt = fluid.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints([h1, h2])
        opt.minimize(loss)
    return main, startup, loss


def _mlp_feed():
    r = np.random.RandomState(0)
    return {"x": r.rand(32, 64).astype("float32"),
            "label": r.randint(0, 10, (32, 1)).astype("int64")}


def _persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _reference_run(main, startup, loss, feed, steps):
    exe, scope = rfluid.Executor(rfluid.CPUPlace()), RScope()
    exe.run(startup, scope=scope)
    names = _persistables(main)
    start = {n: np.asarray(scope.find_var(n)) for n in names}
    losses = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                       scope=scope)[0]).ravel()[0])
              for _ in range(steps)]
    return start, losses, {n: np.asarray(scope.find_var(n)) for n in names}


def _port_run(main, loss, state, feed, steps, graphs=False):
    exe = tfluid.Executor(tfluid.CPUPlace(),
                          graph_runner=_runner if graphs else None)
    scope = tfluid.Scope()
    load_numpy_state(scope, state, "cpu")
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0].reshape(-1)[0])
              for _ in range(steps)]
    return losses, dump_numpy_state(scope, _persistables(main)), exe


def _bop(main):
    return next(op for op in main.global_block().ops
                if op.type == "backward")


def test_append_backward_records_checkpoints():
    """`append_backward(checkpoints=[var, name])` records the names on
    the backward op, as the reference does."""
    rmain = _mlp(rfluid, False, via_backward=True)[0]
    tmain = _mlp(tfluid, False, via_backward=True)[0]
    assert _bop(tmain).attrs["checkpoints"] == \
        _bop(rmain).attrs["checkpoints"]
    assert len(_bop(tmain).attrs["checkpoints"]) == 2


def test_segments_match_reference():
    rmain, _, rloss = _mlp(rfluid, True)
    tmain, _, tloss = _mlp(tfluid, True)
    ckpts = _bop(tmain).attrs["checkpoints"]
    assert ckpts == _bop(rmain).attrs["checkpoints"]
    rops, tops = rmain.global_block().ops, tmain.global_block().ops
    bwd = [op.type for op in tops].index("backward")
    assert [op.type for op in tops] == [op.type for op in rops]
    live = {tloss.name} | set(_persistables(tmain))
    for op in tops[bwd + 1:]:
        live.update(op.input_arg_names)
    want = rlowering._remat_segments(rops[:bwd], ckpts, live)
    got = tlowering._remat_segments(tops[:bwd], ckpts, live)
    assert len(got) == 3
    assert [(a, b) for a, b, _ in got] == [(a, b) for a, b, _ in want]
    for (_, _, g), (_, _, w) in zip(got, want):
        assert g <= w


def test_mlp_recompute_matches_reference():
    feed = _mlp_feed()
    rmain, rstartup, rloss = _mlp(rfluid, True)
    start, r_losses, r_end = _reference_run(rmain, rstartup, rloss, feed,
                                            MLP_STEPS)
    tmain, _, tloss = _mlp(tfluid, True)
    losses, end, _ = _port_run(tmain, tloss, start, feed, MLP_STEPS)
    np.testing.assert_allclose(losses, r_losses, rtol=RTOL)
    assert losses[-1] < losses[0]
    for n, want in r_end.items():
        np.testing.assert_allclose(end[n], want, rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def test_recompute_is_bit_equal_with_dropout(monkeypatch):
    """With a dropout layer inside a segment: the same losses and
    params, bit for bit, as without recompute; the recompute runs each
    segment's ops again (every `mul` twice a step)."""
    feed = _mlp_feed()
    calls = {"mul": 0}
    opdef = treg.get_op("mul")
    compute = opdef.compute

    def counted(ins, attrs):
        calls["mul"] += 1
        return compute(ins, attrs)

    monkeypatch.setattr(opdef, "compute", counted)
    runs = {}
    for rc in (False, True):
        main, startup, loss = _mlp(tfluid, rc, dropout=0.3)
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        calls["mul"] = 0
        losses = [exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0] for _ in range(MLP_STEPS)]
        runs[rc] = (losses, dump_numpy_state(scope, _persistables(main)),
                    calls["mul"])
    for a, b in zip(runs[False][0], runs[True][0]):
        np.testing.assert_array_equal(a, b)
    for n, v in runs[False][1].items():
        np.testing.assert_array_equal(runs[True][1][n], v, err_msg=n)
    assert runs[False][2] == 4 * MLP_STEPS
    assert runs[True][2] == 8 * MLP_STEPS


def test_recompute_graph_path_equals_eager():
    feed = _mlp_feed()
    main, startup, loss = _mlp(tfluid, True, dropout=0.3)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    state = dump_numpy_state(scope, _persistables(main))
    # both runs from the same step seeds
    counter = main._seed_counter
    e_losses, e_end, _ = _port_run(main, loss, state, feed, MLP_STEPS)
    main._seed_counter = counter
    g_losses, g_end, gexe = _port_run(main, loss, state, feed, MLP_STEPS,
                                      graphs=True)
    assert gexe.last_entry.phase == "captured"
    assert g_losses == e_losses
    for n, v in e_end.items():
        np.testing.assert_array_equal(g_end[n], v, err_msg=n)


def _cfg(bert, dropout):
    cfg = bert.BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = dropout
    return cfg


def _bert(fluid, bert, recompute, dropout=0.0):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 23
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        ckpts = []
        total, _, _, _ = bert.bert_pretrain_loss(
            _cfg(bert, dropout), SEQ, checkpoints_out=ckpts)
        opt = fluid.optimizer.AdamOptimizer(1e-3)
        if recompute:
            opt = fluid.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(ckpts)
        opt.minimize(total)
    return main, startup, total, ckpts


@pytest.fixture(scope="module")
def bert_reference():
    """The reference's BERT-tiny recompute run: (start state, losses)."""
    feed = tbert.bert_feed(_cfg(tbert, 0.0), BATCH, SEQ)
    main, startup, total, ckpts = _bert(rfluid, rbert, True)
    assert len(ckpts) == 2
    start, losses, _ = _reference_run(main, startup, total, feed,
                                      BERT_STEPS)
    return feed, start, losses


def test_bert_recompute_matches_reference(bert_reference):
    feed, start, r_losses = bert_reference
    main, _, total, ckpts = _bert(tfluid, tbert, True)
    assert _bop(main).attrs["checkpoints"] == [v.name for v in ckpts]
    losses, _, _ = _port_run(main, total, start, feed, BERT_STEPS)
    np.testing.assert_allclose(losses, r_losses, rtol=RTOL)


def test_bert_recompute_is_bit_equal_with_dropout(bert_reference):
    """Dropout 0.1 (hidden and attention probabilities) in every
    recomputed layer: recompute against none, bit for bit."""
    feed, start, _ = bert_reference
    out = []
    for rc in (False, True):
        main, _, total, _ = _bert(tfluid, tbert, rc, dropout=0.1)
        out.append(_port_run(main, total, start, feed, BERT_STEPS)[:2])
    assert out[0][0] == out[1][0]
    for n, v in out[0][1].items():
        np.testing.assert_array_equal(out[1][1][n], v, err_msg=n)
