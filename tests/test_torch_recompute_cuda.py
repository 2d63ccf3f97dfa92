"""Recompute and gradient merge on the card: the recomputed forward runs
the flash kernels and the dropout kernel again with the same seeds, and
the two captured steps of a gradient-merge window replay what an eager
run computes. Every test here needs an NVIDIA GPU (marker ``cuda``) and
skips without one. The file imports neither JAX nor the JAX package, so
on a GPU machine without JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_recompute_cuda.py

A small BERT (2 layers, hidden 128, 2 heads of 64) at S 256 with the flash
kernels' gate lowered to 256 (`FLAGS_flash_attention_min_seq`), bf16
AMP O2, dropout 0.1 on the hidden states and the attention
probabilities. Tolerances: bit for bit throughout (the kernels are
deterministic and their dropout hashes stateless)."""
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid.contrib import mixed_precision
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.ops.kernels import dropout, flash_attention

pytestmark = pytest.mark.cuda

SEQ, BATCH = 256, 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    before = fluid.get_flags(["FLAGS_flash_attention_min_seq",
                              "FLAGS_cuda_graphs"])
    fluid.set_flags({"FLAGS_flash_attention_min_seq": SEQ})
    yield torch.device("cuda", 0)
    fluid.set_flags(before)


def _cfg():
    return bert.BertConfig(vocab_size=1024, hidden_size=128,
                           num_hidden_layers=2, num_attention_heads=2,
                           intermediate_size=256,
                           max_position_embeddings=SEQ)


def _program(recompute, k=1):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ckpts = []
        total, _, _, _ = bert.bert_pretrain_loss(_cfg(), SEQ,
                                                 checkpoints_out=ckpts)
        opt = fluid.optimizer.LambOptimizer(
            1e-3, grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0))
        if recompute:
            opt = fluid.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(ckpts)
        if k > 1:
            opt = fluid.optimizer.GradientMergeOptimizer(opt, k_steps=k)
        opt = mixed_precision.decorate(opt, use_dynamic_loss_scaling=False)
        _, params_grads = opt.minimize(total)
    return main, startup, total, [g.name for _, g in params_grads]


def _start(main, startup):
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    return {n: scope.find_var(n).clone() for n in scope.local_var_names()}


def _scope(state):
    scope = fluid.Scope()
    for n, v in state.items():
        scope.set_var(n, v.clone())
    return scope


def test_recompute_is_bit_equal_with_flash_and_dropout(dev):
    """One step with and without recompute from one start: the loss and
    every gradient bit for bit; the recompute launches the forward kernel
    and the dropout kernel once more a layer (the embeddings' dropout
    too)."""
    feed = bert.bert_feed(_cfg(), BATCH, SEQ)
    state, out = None, {}
    L = _cfg().num_hidden_layers
    for rc in (False, True):
        main, startup, total, grads = _program(rc)
        state = state or _start(main, startup)
        exe = fluid.Executor()
        flash_attention.fwd_launches = dropout.launches = 0
        vals = exe.run(main, feed=feed, fetch_list=[total] + grads,
                       scope=_scope(state), return_numpy=False)
        out[rc] = ([v.value.clone() for v in vals],
                   flash_attention.fwd_launches, dropout.launches)
    for a, b in zip(out[False][0], out[True][0]):
        assert torch.equal(a, b)
    assert (out[False][1], out[True][1]) == (L, 2 * L)
    assert out[True][2] == 2 * out[False][2] == 2 * (1 + 2 * L)


def test_gradient_merge_captured_equals_eager(dev):
    """k 2 with recompute, 6 steps captured and eagerly from one start
    and one seed counter: every loss and persistable bit for bit; both
    steps of the window captured."""
    feed = bert.bert_feed(_cfg(), BATCH, SEQ)
    main, startup, total, _ = _program(True, k=2)
    state = _start(main, startup)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    counter = main._seed_counter
    runs = {}
    for graphs in (True, False):
        fluid.set_flags({"FLAGS_cuda_graphs": graphs})
        exe, scope = fluid.Executor(), _scope(state)
        main._seed_counter = counter
        losses = [exe.run(main, feed=feed, fetch_list=[total], scope=scope,
                          return_numpy=False)[0].value.clone()
                  for _ in range(6)]
        runs[graphs] = (losses, {n: scope.find_var(n).clone()
                                 for n in names}, exe.last_entry.info())
    assert [s["phase"] for s in runs[True][2]["gradient_merge"][
        "steps"]] == ["captured", "captured"]
    for a, b in zip(runs[True][0], runs[False][0]):
        assert torch.equal(a, b)
    for n in names:
        assert torch.equal(runs[True][1][n], runs[False][1][n]), n
