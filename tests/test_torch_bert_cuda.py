"""The fluid BERT path on the card: `scaled_dot_product_attention`'s route
to the flash kernels, the fused vocab head's float32-accumulated bf16
products, and a tiny BERT step through the whole fluid chain. Every test
here needs an NVIDIA GPU (marker ``cuda``) and skips without one. The
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_bert_cuda.py

Tolerances: bf16 2e-2 (the tensor-core kernels round P and dS to bf16
before their second product); the fused head 1e-4 against the float32
head on the bf16-rounded operands (both accumulate in float32, in
another order)."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid.contrib import mixed_precision
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.ops.kernels import flash_attention as fa

pytestmark = pytest.mark.cuda

BF16_TOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def min_seq():
    """Sets FLAGS_flash_attention_min_seq for one test, then restores
    it."""
    old = fluid.get_flags("FLAGS_flash_attention_min_seq")

    def set_(v):
        fluid.set_flags({"FLAGS_flash_attention_min_seq": v})

    yield set_
    fluid.set_flags(old)


def _zero_counts():
    fa.fwd_launches = fa.dkv_launches = fa.dq_launches = 0
    fa.tc_launches = dict.fromkeys(fa.tc_launches, 0)


def _sdpa(q, k, v, bias, p, seed, impl="auto"):
    attrs = {"causal": False, "sm_scale": 0.125, "attn_dropout_prob": p,
             "is_test": False, "flash_impl": impl, "_rng_seed": seed,
             "_rng_generator": torch.Generator(q.device).manual_seed(seed)}
    return registry.run_op("scaled_dot_product_attention",
                           {"Q": [q], "K": [k], "V": [v], "KeyBias": [bias]},
                           attrs)["Out"][0]


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_sdpa_takes_the_kernels_at_the_gate(dev, min_seq, p):
    """At Sk >= FLAGS_flash_attention_min_seq the op launches the three
    bf16 kernels on tensor cores (forward, and dK/dV and dQ in its
    backward) and agrees with their plain version under the same dropout
    hash; one key below the gate it launches none."""
    g = torch.Generator().manual_seed(0)
    B, H, S, D = 2, 4, 256, 64
    qkv = torch.randn(B, S, 3 * H * D, generator=g).to(dev, torch.bfloat16)
    q, k, v = (qkv[:, :, i * H * D:(i + 1) * H * D].reshape(B, S, H, D)
               .transpose(1, 2).requires_grad_(True) for i in range(3))
    bias = torch.zeros(B, S, device=dev)
    bias[1, S // 2:] = -1e4
    do = torch.randn(B, H, S, D, generator=g).to(dev, torch.bfloat16)
    min_seq(S)
    _zero_counts()
    out = _sdpa(q, k, v, bias, p, seed=5 << 32)
    grads = torch.autograd.grad(out, (q, k, v), do)
    want = {"forward": 1, "dkv": 1, "dq": 1}
    assert (fa.fwd_launches, fa.dkv_launches, fa.dq_launches) == (1, 1, 1)
    assert fa.tc_launches == want
    ref = _sdpa(q, k, v, bias, p, seed=5 << 32, impl="reference")
    ref_grads = torch.autograd.grad(ref, (q, k, v), do)
    assert fa.tc_launches == want  # the plain version launches nothing
    for got, exp in zip((out,) + grads, (ref,) + ref_grads):
        torch.testing.assert_close(got.float(), exp.float(), rtol=BF16_TOL,
                                   atol=BF16_TOL)
    min_seq(S + 1)
    _sdpa(q, k, v, bias, p, seed=5 << 32)
    assert fa.tc_launches == want


def test_linear_xent_bf16_on_the_card(dev):
    """The fused vocab head on bf16 operands (cuBLAS with float32 output)
    against the float32 head on the bf16-rounded operands on the CPU."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(96, 64, generator=g).bfloat16()
    w = (torch.randn(64, 1000, generator=g) * 0.1).bfloat16()
    b = torch.randn(1000, generator=g) * 0.1
    label = torch.randint(0, 1000, (96, 1), generator=g)

    def head(x, w, b, label):
        x, w, b = (t.requires_grad_(True) for t in (x, w, b))
        loss = registry.run_op(
            "fused_linear_softmax_xent",
            {"X": [x], "W": [w], "Bias": [b], "Label": [label]},
            {"chunk_size": 256})["Loss"][0]
        return (loss,) + torch.autograd.grad(loss.sum(), (x, w, b))

    card = head(x.to(dev), w.to(dev), b.to(dev), label.to(dev))
    cpu = head(x.float(), w.float(), b, label)
    assert card[0].dtype == torch.float32 and card[1].dtype == torch.bfloat16
    torch.testing.assert_close(card[0].cpu(), cpu[0], rtol=1e-4, atol=1e-4)
    for got, exp in zip(card[1:], cpu[1:]):
        torch.testing.assert_close(got.float().cpu(), exp.float(),
                                   rtol=BF16_TOL, atol=BF16_TOL)


def test_tiny_bert_amp_step_card_vs_cpu(dev, min_seq):
    """BertConfig.tiny with the scan encoder under remat, bf16 AMP O2 and
    fused Adam: two steps on the card (the flash kernels, gate lowered to
    the sequence length) and on the CPU (the composite path) from the
    same numpy state, dropout off: losses within 2e-2; the card's step
    launched each flash kernel 2L / L / L times (the forward again in the
    recompute), all on tensor cores."""
    cfg = bert.BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    seq, batch = 64, 4
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        total, _, _, _ = bert.bert_pretrain_loss(cfg, seq, scan_layers=True,
                                                 scan_remat=True)
        mixed_precision.decorate(fluid.optimizer.AdamOptimizer(1e-3),
                                 use_dynamic_loss_scaling=False).minimize(
                                     total)
        fluid.fuse_optimizer_ops(main)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    state = {n: scope.find_var(n).cpu() for n in scope.local_var_names()}
    feed = bert.bert_feed(cfg, batch, seq)
    min_seq(seq)
    _zero_counts()
    card = [float(exe.run(main, feed=feed, fetch_list=[total],
                          scope=scope)[0][0]) for _ in range(2)]
    L = cfg.num_hidden_layers
    assert fa.tc_launches == {"forward": 4 * L, "dkv": 2 * L, "dq": 2 * L}
    cpu_scope = fluid.Scope()
    for n, v in state.items():
        cpu_scope.set_var(n, v)
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu = [float(cpu_exe.run(main, feed=feed, fetch_list=[total],
                             scope=cpu_scope)[0][0]) for _ in range(2)]
    np.testing.assert_allclose(card, cpu, rtol=BF16_TOL)
    assert all(np.isfinite(card))
