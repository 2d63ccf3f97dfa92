"""The flash attention CUDA kernels (forward, dK/dV, dQ) against their
plain PyTorch versions, on the card. Every test here needs an NVIDIA GPU
(marker ``cuda``) and skips without one. The file imports neither JAX nor
the JAX package, so on a GPU machine without JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_cuda.py

Tolerances: float32 forward atol/rtol 2e-5 and gradients 3e-4 (those of
tests/test_flash_attention.py: float32 arithmetic on both sides, in
another summation order); bfloat16 2e-2 (both sides compute in float32
from the same bf16 inputs and round the result to bf16). The bfloat16
forward and dQ kernels run on tensor cores and round P and dS to bf16
before their second product, so their results are no longer bit-equal to
the plain version's (which keeps P and dS in float32); two runs of a
kernel, and a kernel on strided views against the same call on contiguous
copies, still are."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention

pytestmark = pytest.mark.cuda

FWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GRAD_TOL = {torch.float32: 3e-4, torch.bfloat16: 2e-2}

#: name -> (B, H, Sq, Sk, D, dtype, causal, padding bias, dropout_p)
CASES = {
    # the trainer's shape (SPMDConfig defaults, batch 8)
    "trainer_bf16_causal": (8, 12, 512, 512, 64, torch.bfloat16, True, False,
                            0.0),
    # BERT's shape: non-causal with a padding bias
    "bert_f32_bias": (4, 12, 128, 128, 64, torch.float32, False, True, 0.0),
    # S 100: padded to 104, a ragged last 64-row tile
    "unaligned_f32_causal": (2, 3, 100, 100, 64, torch.float32, True, False,
                             0.0),
    "dropout_f32_bias": (2, 4, 128, 128, 64, torch.float32, False, True, 0.1),
    "dropout_bf16_causal": (2, 2, 192, 192, 64, torch.bfloat16, True, False,
                            0.3),
    "head_dim_128_f32": (1, 2, 130, 130, 128, torch.float32, True, False,
                         0.0),
    "head_dim_40_bf16_bias": (2, 2, 96, 96, 40, torch.bfloat16, False, True,
                              0.0),
    "decode_q1_f32": (3, 2, 1, 200, 64, torch.float32, False, True, 0.0),
    "cross_len_f32": (1, 2, 64, 192, 32, torch.float32, False, False, 0.2),
    "head_dim_128_bf16": (2, 2, 256, 256, 128, torch.bfloat16, True, False,
                          0.0),
    # S 200 unpadded (blocks of 8): a ragged last 128-row q tile and a
    # ragged last 64-key tile
    "ragged_200_bf16": (2, 3, 200, 200, 64, torch.bfloat16, True, False,
                        0.0),
    "dropout_bf16_causal_512": (1, 4, 512, 512, 64, torch.bfloat16, True,
                                False, 0.1),
}
#: cases padded to blocks other than the default 128
BLOCK = {"ragged_200_bf16": 8}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, seed, B, H, Sq, Sk, D, dtype, pad_bias):
    rng = np.random.default_rng(seed)
    t = lambda shape: torch.tensor(rng.standard_normal(shape),
                                   dtype=torch.float32).to(dev, dtype)
    q, k, v = t((B, H, Sq, D)), t((B, H, Sk, D)), t((B, H, Sk, D))
    w = t((B, H, Sq, D))
    bias = None
    if pad_bias:
        mask = np.ones((B, Sk), np.float32)
        for b in range(B):
            mask[b, rng.integers(Sk // 2, Sk + 1):] = 0.0
        bias = torch.tensor((mask - 1.0) * 1e4, device=dev)
    return q, k, v, w, bias


def _run(impl, q, k, v, w, bias, causal, p, block=128):
    qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = flash_attention(qs, ks, vs, key_bias=bias, causal=causal,
                          dropout_p=p, dropout_seed=1234 if p else None,
                          block_q=block, block_k=block, impl=impl)
    (out.float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    return out.detach(), qs.grad, ks.grad, vs.grad


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_match_plain(dev, case):
    B, H, Sq, Sk, D, dtype, causal, pad_bias, p = CASES[case]
    q, k, v, w, bias = _inputs(dev, sum(map(ord, case)), B, H, Sq, Sk, D,
                               dtype, pad_bias)
    before = (flash_attention.fwd_launches, flash_attention.dkv_launches,
              flash_attention.dq_launches)
    block = BLOCK.get(case, 128)
    got = _run("kernel", q, k, v, w, bias, causal, p, block)
    after = (flash_attention.fwd_launches, flash_attention.dkv_launches,
             flash_attention.dq_launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    want = _run("reference", q, k, v, w, bias, causal, p, block)
    for name, g, r in zip(("o", "dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == r.shape, name
        assert bool(torch.isfinite(g.float()).all()), name
        tol = FWD_TOL[dtype] if name == "o" else GRAD_TOL[dtype]
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=tol,
                                   msg=lambda m: "%s: %s" % (name, m))


def test_lse_matches_plain(dev):
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_reference)

    q, k, v, _, bias = _inputs(dev, 5, 2, 2, 96, 96, 64, torch.float32,
                               True)
    bias = bias.repeat_interleave(2, dim=0).contiguous()
    o, lse = flash_attention_fwd(q, k, v, bias, 0, sm_scale=0.125,
                                 causal=True, impl="kernel")
    o_r, lse_r = flash_attention_fwd_reference(q, k, v, bias, 0,
                                               sm_scale=0.125, causal=True)
    torch.testing.assert_close(lse, lse_r, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(o, o_r, atol=2e-5, rtol=2e-5)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    _, lse = flash_attention_fwd(qb, kb, vb, bias, 0, sm_scale=0.125,
                                 causal=True, impl="kernel")
    _, lse_r = flash_attention_fwd_reference(qb, kb, vb, bias, 0,
                                             sm_scale=0.125, causal=True)
    torch.testing.assert_close(lse, lse_r, atol=2e-2, rtol=2e-2)


def test_deterministic_and_seed_sensitive(dev):
    q, k, v, w, _ = _inputs(dev, 6, 1, 2, 128, 128, 64, torch.float32,
                            False)
    a = _run("kernel", q, k, v, w, None, False, 0.2)
    b = _run("kernel", q, k, v, w, None, False, 0.2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = flash_attention(q, k, v, dropout_p=0.2, dropout_seed=1235,
                        impl="kernel")
    assert not torch.allclose(a[0], c)


def test_kernel_rejects_what_it_does_not_take(dev):
    q, k, v, _, _ = _inputs(dev, 7, 1, 1, 16, 16, 160, torch.float32, False)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, k, v, impl="kernel")
    q, k, v, _, _ = _inputs(dev, 7, 1, 1, 16, 16, 32, torch.float16, False)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q, k, v, impl="kernel")


def _qkv_views(dev, seed, B, S, H, D, dtype):
    """q, k, v as the trainer makes them: [B, H, S, D] views of one
    [B, S, 3, H, D] leaf tensor, which is returned too."""
    rng = np.random.default_rng(seed)
    qkv = torch.tensor(rng.standard_normal((B, S, 3, H, D)),
                       dtype=torch.float32).to(dev, dtype).requires_grad_(True)
    return qkv, [qkv[:, :, i].transpose(1, 2) for i in range(3)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_strided_views_bit_equal_to_contiguous_copies(dev, dtype):
    B, S, H, D = 2, 384, 3, 64
    qkv, (q, k, v) = _qkv_views(dev, 11, B, S, H, D, dtype)
    w = torch.randn((B, H, S, D), device=dev).to(dtype)
    fwd, dkv, dq = (flash_attention.fwd_launches,
                    flash_attention.dkv_launches, flash_attention.dq_launches)
    out = flash_attention(q, k, v, causal=True, impl="kernel")
    (out.float() * w.float()).sum().backward()
    assert (flash_attention.fwd_launches, flash_attention.dkv_launches,
            flash_attention.dq_launches) == (fwd + 1, dkv + 1, dq + 1)
    # the output is a view of a [B, S, H, D] tensor: merging heads is free
    assert out.transpose(1, 2).is_contiguous()
    copies = [x.detach().contiguous().requires_grad_(True)
              for x in (q, k, v)]
    ref = flash_attention(*copies, causal=True, impl="kernel")
    (ref.float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    for i, c in enumerate(copies):
        assert torch.equal(qkv.grad[:, :, i].transpose(1, 2), c.grad)


def test_bf16_runs_bit_equal(dev):
    q, k, v, w, _ = _inputs(dev, 12, 2, 4, 512, 512, 64, torch.bfloat16,
                            False)
    a = _run("kernel", q, k, v, w, None, True, 0.1)
    b = _run("kernel", q, k, v, w, None, True, 0.1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_unaligned_row_stride_still_launches_the_kernel(dev):
    # rows of 68 bf16 values: a 136-byte stride, which TMA cannot read in
    # place, so the wrapper hands the kernel a contiguous copy
    rng = np.random.default_rng(13)
    bases = [torch.tensor(rng.standard_normal((2, 2, 160, 68)),
                          dtype=torch.float32).to(dev, torch.bfloat16)
             for _ in range(3)]
    w = torch.tensor(rng.standard_normal((2, 2, 160, 64)),
                     dtype=torch.float32).to(dev, torch.bfloat16)

    def run(impl):
        leaves = [b.clone().requires_grad_(True) for b in bases]
        q, k, v = (x[..., :64] for x in leaves)
        assert q.stride(2) == 68
        out = flash_attention(q, k, v, causal=True, impl=impl)
        (out.float() * w.float()).sum().backward()
        torch.cuda.synchronize()
        return [out.detach()] + [x.grad[..., :64] for x in leaves]

    fwd, dq = flash_attention.fwd_launches, flash_attention.dq_launches
    got = run("kernel")
    assert (flash_attention.fwd_launches, flash_attention.dq_launches) == \
        (fwd + 1, dq + 1)
    want = run("reference")
    for name, g, r in zip(("o", "dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g.float(), r.float(), atol=2e-2, rtol=2e-2,
                                   msg=lambda m: "%s: %s" % (name, m))
