"""The Transformer slice's ops, control flow, two training steps and a
beam-search decode on the card against the port's own CPU result. Every
test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_transformer_cuda.py

Tolerances: float32 1e-5 relative in norm for the ops (TF32 is off),
1e-4 for losses after training steps and for decode scores; integer and
bool outputs, control-flow results and decoded sequences exact."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import fluid
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.core.scope import dump_numpy_state, load_numpy_state
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.ops import registry

pytestmark = pytest.mark.cuda

OP_TOL, STEP_TOL = 1e-5, 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device("cuda:0")


def _f(*shape):
    return lambda g: torch.randn(*shape, generator=g)


def _pos(*shape):
    return lambda g: torch.rand(*shape, generator=g) + 0.5


def _i(lo, hi, *shape):
    return lambda g: torch.randint(lo, hi, shape, generator=g,
                                   dtype=torch.int32)


def _b(*shape):
    return lambda g: torch.rand(*shape, generator=g) < 0.5


#: name -> (op type, {slot: [maker]}, attrs, slots to differentiate)
CASES = {
    "elementwise_sub": ("elementwise_sub", {"X": [_f(4, 8, 16)],
                                            "Y": [_f(8)]}, {"axis": 1},
                        ["X", "Y"]),
    "elementwise_min": ("elementwise_min", {"X": [_f(1)], "Y": [_f(1)]}, {},
                        ["X", "Y"]),
    "elementwise_pow": ("elementwise_pow", {"X": [_pos(1)],
                                            "Y": [_f(1)]}, {}, ["X"]),
    "elementwise_mod": ("elementwise_mod", {"X": [_i(-9, 9, 3, 4)],
                                            "Y": [_i(1, 5, 4)]}, {}, []),
    "less_than": ("less_than", {"X": [_f(4, 3)], "Y": [_f(1)]}, {}, []),
    "logical_and": ("logical_and", {"X": [_b(4, 3)], "Y": [_b(4, 3)]}, {},
                    []),
    "one_hot": ("one_hot", {"X": [_i(-1, 33000, 32, 128, 1)]},
                {"depth": 32000}, []),
    "label_smooth": ("label_smooth", {"X": [_f(8, 128, 32000)]},
                     {"epsilon": 0.1}, ["X"]),
    "unsqueeze2": ("unsqueeze2", {"X": [_f(32, 128)]}, {"axes": [1]},
                   ["X"]),
    "squeeze2": ("squeeze2", {"X": [_f(32, 1, 128)]}, {"axes": [1]}, ["X"]),
    "stack": ("stack", {"X": [_f(4, 16), _f(4, 16)]}, {"axis": 0}, ["X"]),
    "increment": ("increment", {"X": [_i(0, 9, 1)]}, {"step": 1.0}, []),
    "where": ("where", {"Condition": [_b(1)], "X": [_f(1)], "Y": [_f(1)]},
              {}, ["X", "Y"]),
    "exp": ("exp", {"X": [_f(64)]}, {}, ["X"]),
}


def _run(op_type, ins, attrs, device, diff):
    t_ins = {s: [v.to(device).requires_grad_(s in diff) for v in vs]
             for s, vs in ins.items()}
    outs = registry.run_op(op_type, t_ins, dict(attrs, _device=device))
    grads = []
    if diff:
        y = outs["Y" if op_type == "stack" else "Out"][0]
        ct = torch.linspace(-1, 1, y.numel()).reshape(y.shape).to(device)
        grads = torch.autograd.grad(
            y, [v for s in diff for v in t_ins[s]], grad_outputs=ct)
    return [v.detach().cpu() for vs in outs.values() for v in vs] + \
        [g.cpu() for g in grads]


def _close(got, want, tol, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if not want.is_floating_point():
        assert torch.equal(got, want), what
        return
    err = (got.double() - want.double()).norm() \
        / want.double().norm().clamp_min(1e-30)
    assert err <= tol, (what, float(err))


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_on_card_matches_cpu(dev, name):
    """Forward results and input gradients (one_hot and label_smooth at
    the vocab head's width), card against CPU."""
    op_type, makers, attrs, diff = CASES[name]
    g = torch.Generator().manual_seed(sorted(CASES).index(name))
    ins = {s: [m(g) for m in ms] for s, ms in makers.items()}
    card = _run(op_type, ins, attrs, dev, diff)
    cpu = _run(op_type, ins, attrs, torch.device("cpu"), diff)
    for k, (a, b) in enumerate(zip(card, cpu)):
        _close(a, b, OP_TOL, "%s %d" % (name, k))


def test_assign_value_is_made_once_on_the_device(dev):
    """An assign_value constant lands on the card, once: the second run
    hands back the same tensor."""
    attrs = {"shape": [2, 2], "dtype": "float32",
             "fp32_values": [1.0, 2.0, 3.0, 4.5], "_device": dev}
    a = registry.run_op("assign_value", {}, attrs)["Out"][0]
    b = registry.run_op("assign_value", {}, attrs)["Out"][0]
    assert a.device == dev and a is b
    assert a.cpu().tolist() == [[1.0, 2.0], [3.0, 4.5]]


def _control_flow():
    """5! by a while_loop, and a cond inside a while updating the loop's
    accumulator; returns the fetch vars."""
    L = fluid.layers
    i = L.fill_constant([1], "int64", 1)
    limit = L.fill_constant([1], "int64", 6)
    fact = L.fill_constant([1], "int64", 1)
    i, fact = L.while_loop(
        lambda i, fact: L.less_than(i, limit),
        lambda i, fact: (i + L.fill_constant([1], "int64", 1), fact * i),
        [i, fact])
    j = L.fill_constant([1], "int64", 0)
    acc = L.fill_constant([1], "float32", 0.0)
    c = L.less_than(j, limit)
    w = L.While(c)
    with w.block():
        odd = L.equal(j % 2, L.fill_constant([1], "int64", 1))
        L.cond(odd, lambda: L.assign(acc + 3.0, output=acc),
               lambda: L.assign(acc + 1.0, output=acc))
        L.increment(j)
        L.less_than(j, limit, cond=c)
    return [fact, i, acc, j]


def test_control_flow_on_card_matches_cpu(dev):
    vals = []
    for place in (None, fluid.CPUPlace()):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            fetch = _control_flow()
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        vals.append([v.tolist() for v in exe.run(main, fetch_list=fetch,
                                                 scope=scope)])
    assert vals[0] == vals[1] == [[120], [6], [12.0], [6]]


def _cfg():
    return transformer.TransformerConfig(
        src_vocab=512, tgt_vocab=512, max_len=32, d_model=128, n_head=4,
        d_ff=256, n_layer=2, dropout=0.0)


def test_transformer_steps_and_decode_on_card_match_cpu(dev):
    """Two noam-Adam steps of the unrolled Transformer (label smoothing
    0.1) on the card and on the CPU from one startup state: losses and
    learning rates within 1e-4; then beam search (beam 4, 10 steps) from
    each trained scope: sequences equal where the CPU's top-k margin
    stayed above 1e-5, scores within 1e-4; no attention kernel
    launched."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    cfg, S, B = _cfg(), 16, 4
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _ = transformer.build_transformer_train(
            cfg, src_len=S, tgt_len=S, lr=0.5, warmup=4,
            label_smooth_eps=0.1)
    lr = next(op.input("LearningRate")[0] for op in main.global_block().ops
              if op.type == "adam")
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    state = dump_numpy_state(scope, sorted(
        v.name for v in main.list_vars() if v.persistable))
    r = np.random.RandomState(0)
    mask = (np.arange(S)[None] < r.randint(S // 2, S + 1, (B, 1))
            ).astype("float32")
    ids = [np.where(mask > 0, r.randint(2, 512, (B, S)), 1).astype("int64")
           for _ in range(3)]
    feed = {"src_ids": ids[0], "tgt_ids": ids[1], "lbl_ids": ids[2],
            "src_mask": mask, "tgt_mask": mask}
    fa.fwd_launches = 0
    out = {}
    for place, device in ((None, None), (fluid.CPUPlace(), "cpu")):
        exe = fluid.Executor(place)
        s = fluid.Scope()
        load_numpy_state(s, state, exe.device)
        steps = [exe.run(main, feed=feed, fetch_list=[loss, lr], scope=s)
                 for _ in range(2)]
        stats = {}
        seqs, scores = transformer.beam_search_decode(
            s, feed["src_ids"], mask, cfg, beam_size=4, max_out_len=10,
            device=device, stats=stats)
        assert seqs.device.type == exe.device.type
        out[exe.device.type] = (
            np.array([[float(a[0][0]), float(a[1][0])] for a in steps]),
            seqs.cpu().numpy(), scores.cpu().numpy(),
            stats["min_topk_margin"].cpu().numpy())
    card, cpu = out["cuda"], out["cpu"]
    np.testing.assert_allclose(card[0], cpu[0], rtol=STEP_TOL)
    for b in range(B):
        if cpu[3][b] >= 1e-5:
            np.testing.assert_array_equal(card[1][b], cpu[1][b])
    np.testing.assert_allclose(card[2], cpu[2], rtol=STEP_TOL)
    assert fa.fwd_launches == 0


def test_decode_refuses_params_off_its_device(dev):
    """Params on the CPU and a decode asked for on the card: an error,
    not a quiet copy."""
    cfg = _cfg()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        transformer.build_transformer_train(cfg, src_len=8, tgt_len=8)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    src = np.full((1, 8), 3, "int64")
    with pytest.raises(RuntimeError, match="not on the decode device"):
        transformer.beam_search_decode(scope, src, np.ones((1, 8),
                                                           "float32"), cfg)
