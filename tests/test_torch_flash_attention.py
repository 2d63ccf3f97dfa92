"""The port's flash attention (paddle_tpu_torch.ops.kernels.flash_attention,
its plain PyTorch version on the CPU) against the JAX package's: the
Pallas kernels under the interpreter and `reference_attention`, on the
same numpy inputs. Forward and the three gradients, causal and not, with
a key bias, with S not a multiple of the block, in bfloat16, and with
dropout, whose keep mask must equal the reference's `_dropout_mask` bit
for bit.

Each JAX case runs once per module (a fixture shares it), since the
Pallas interpreter compiles for seconds per case.

Tolerances: float32 forward 2e-5 and gradients 3e-4 (as in
tests/test_flash_attention.py: float32 on both sides, another summation
order); bfloat16 2e-2 (both sides compute in float32 from the same bf16
inputs and round the result); masks exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jax_flash
from paddle_tpu.ops.pallas import reference_attention as jax_reference
from paddle_tpu.ops.pallas.flash_attention import _dropout_mask
from paddle_tpu_torch.ops.kernels import flash_attention
from paddle_tpu_torch.ops.kernels.flash_attention import (
    dropout_keep_mask, flash_attention_bwd_reference,
    flash_attention_fwd_reference, reference_attention)

FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 3e-4, "bfloat16": 2e-2}

#: name -> (B, H, Sq, Sk, D, dtype, causal, bias, dropout_p, block)
CASES = {
    "causal": (1, 2, 64, 64, 16, "float32", True, False, 0.0, 32),
    "bias": (2, 1, 64, 64, 16, "float32", False, True, 0.0, 32),
    "unaligned_causal": (1, 2, 50, 50, 16, "float32", True, False, 0.0, 32),
    "bfloat16": (1, 2, 48, 48, 16, "bfloat16", False, False, 0.0, 32),
    "dropout_bias": (1, 2, 64, 64, 16, "float32", False, True, 0.25, 32),
}
SEED = 4242


def _inputs(name):
    B, H, Sq, Sk, D, dtype, _, with_bias, _, _ = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    arr = lambda shape: rng.standard_normal(shape).astype(np.float32)
    q, k, v, w = arr((B, H, Sq, D)), arr((B, H, Sk, D)), arr((B, H, Sk, D)), \
        arr((B, H, Sq, D))
    bias = None
    if with_bias:
        mask = np.ones((B, Sk), np.float32)
        mask[0, Sk * 3 // 4:] = 0.0
        mask[-1, Sk // 3:] = 0.0
        bias = (mask - 1.0) * 1e4
    if dtype == "bfloat16":  # round once; both sides start from these
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(
            jnp.float32)) for x in (q, k, v))
    return q, k, v, w, bias


def _kwargs(name):
    *_, causal, _, p, block = CASES[name]
    kw = dict(causal=causal, block_q=block, block_k=block)
    if p:
        kw.update(dropout_p=p)
    return kw


@pytest.fixture(scope="module")
def jax_results():
    """{case: (o, dq, dk, dv)} from the JAX flash kernels (interpreted)."""
    out = {}
    for name in CASES:
        q, k, v, w, bias = _inputs(name)
        dtype = jnp.dtype(CASES[name][5])
        kw = _kwargs(name)
        if "dropout_p" in kw:
            kw["dropout_seed"] = jnp.int32(SEED)
        jb = None if bias is None else jnp.asarray(bias)

        def f(q, k, v):
            return jax_flash(q, k, v, key_bias=jb, **kw)

        o, vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in (q, k, v)))
        grads = vjp(jnp.asarray(w, dtype))
        out[name] = tuple(np.asarray(x.astype(jnp.float32))
                          for x in (o,) + tuple(grads))
    return out


def _torch_run(name, impl="auto"):
    q, k, v, w, bias = _inputs(name)
    dtype = getattr(torch, CASES[name][5])
    ts = [torch.tensor(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    kw = _kwargs(name)
    if "dropout_p" in kw:
        kw["dropout_seed"] = SEED
    o = flash_attention(*ts, key_bias=None if bias is None
                        else torch.tensor(bias), impl=impl, **kw)
    o.backward(torch.tensor(w).to(dtype))
    return tuple(x.detach().float().numpy()
                 for x in (o, ts[0].grad, ts[1].grad, ts[2].grad))


@pytest.fixture(scope="module")
def torch_results():
    return {name: _torch_run(name) for name in CASES}


@pytest.mark.parametrize("what", ["o", "dq", "dk", "dv"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_flash_kernel(jax_results, torch_results, case, what):
    i = ("o", "dq", "dk", "dv").index(what)
    dtype = CASES[case][5]
    tol = FWD_TOL[dtype] if what == "o" else GRAD_TOL[dtype]
    np.testing.assert_allclose(torch_results[case][i], jax_results[case][i],
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", sorted(n for n in CASES
                                        if not CASES[n][8]))
def test_matches_jax_reference_attention(torch_results, case):
    """Without dropout, the port equals the JAX golden reference too
    (forward and all three gradients)."""
    q, k, v, w, bias = _inputs(case)
    causal = CASES[case][6]
    jb = None if bias is None else jnp.asarray(bias)

    @jax.jit
    def fwd_and_grads(q, k, v, w):
        o, vjp = jax.vjp(lambda q, k, v: jax_reference(
            q, k, v, key_bias=jb, causal=causal), q, k, v)
        return (o,) + tuple(vjp(w))

    want = fwd_and_grads(q, k, v, w)
    dtype = CASES[case][5]
    for i, (got, ref) in enumerate(zip(torch_results[case], want)):
        tol = FWD_TOL[dtype] if i == 0 else GRAD_TOL[dtype]
        np.testing.assert_allclose(got, np.asarray(ref), atol=tol, rtol=tol)


def test_reference_attention_matches_jax():
    q, k, v, _, bias = _inputs("bias")
    got = reference_attention(*(torch.tensor(x) for x in (q, k, v)),
                              key_bias=torch.tensor(bias), causal=True)
    want = jax_reference(q, k, v, key_bias=bias, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def _numpy_mask(seed, BH, S, Sk, p):
    """numpy replica of the reference's `_dropout_mask` (as in
    tests/test_flash_attention.py)."""
    r = np.arange(S, dtype=np.uint32)[None, :, None]
    c = np.arange(Sk, dtype=np.uint32)[None, None, :]
    b = np.arange(BH, dtype=np.uint32)[:, None, None]
    with np.errstate(over="ignore"):
        x = (r * np.uint32(0x9E3779B1)) ^ (c * np.uint32(0x85EBCA77))
        x = x ^ (b * np.uint32(0xC2B2AE3D)) ^ np.uint32(seed & 0xFFFFFFFF)
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x85EBCA6B)
        x = x ^ (x >> np.uint32(13))
        x = x * np.uint32(0xC2B2AE35)
        x = x ^ (x >> np.uint32(16))
    thresh = np.uint32(min(int(p * 4294967296.0), 0xFFFFFFFF))
    return np.where(x >= thresh, 1.0 / (1.0 - p), 0.0).astype(np.float32)


@pytest.mark.parametrize("seed,p", [(0, 0.1), (12345, 0.3), (-7, 0.5),
                                    (2 ** 31 - 1, 0.9)])
def test_dropout_mask_bit_identical(seed, p):
    BH, S, Sk = 3, 40, 72
    got = dropout_keep_mask(seed, BH, S, Sk, p).numpy()
    np.testing.assert_array_equal(got, _numpy_mask(seed, BH, S, Sk, p))
    jseed = jnp.asarray(np.int32(seed)).astype(jnp.uint32)
    for bh in (0, BH - 1):
        # one block of the JAX kernel's own mask, at an offset
        want = np.asarray(_dropout_mask(jseed, bh, 8, 16, 24, 40, p))
        np.testing.assert_array_equal(got[bh, 8:32, 16:56], want)


def test_dropout_rate_and_blocking_independence():
    mask = dropout_keep_mask(777, 2, 256, 256, 0.4).numpy()
    assert abs(float((mask == 0.0).mean()) - 0.4) < 0.02
    q, k, v, _, bias = _inputs("dropout_bias")
    ts = [torch.tensor(x) for x in (q, k, v)]
    kw = dict(key_bias=torch.tensor(bias), dropout_p=0.25, dropout_seed=9)
    a = flash_attention(*ts, **kw)
    b = flash_attention(*ts, block_q=16, block_k=24, **kw)
    torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)
    c = flash_attention(*ts, key_bias=kw["key_bias"], dropout_p=0.25,
                        dropout_seed=10)
    assert not torch.allclose(a, c)


def test_plain_versions_match_autograd_of_full_softmax():
    """The plain forward/backward pair equals autograd through a dense
    softmax on the same [BH, S, D] inputs (lse included)."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.tensor(rng.standard_normal((2, 24, 8)),
                                dtype=torch.float32) for _ in range(4))
    bias = torch.tensor(rng.standard_normal((2, 24)), dtype=torch.float32)
    o, lse = flash_attention_fwd_reference(q, k, v, bias, sm_scale=0.3,
                                           causal=True)
    qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
    s = torch.einsum("bqd,bkd->bqk", qs, ks) * 0.3 + bias[:, None, :]
    s = s.masked_fill(torch.ones(24, 24).triu(1).bool(), -1e30)
    dense = torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), vs)
    dense.backward(do)
    torch.testing.assert_close(o, dense.detach(), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, torch.logsumexp(s.detach(), -1),
                               atol=1e-5, rtol=1e-5)
    grads = flash_attention_bwd_reference(q, k, v, bias, 0, o, lse, do,
                                          sm_scale=0.3, causal=True)
    for got, want in zip(grads, (qs.grad, ks.grad, vs.grad)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_key_bias_gets_no_gradient_and_cpu_counts_nothing():
    q, k, v, _, bias = _inputs("bias")
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    tb = torch.tensor(bias, requires_grad=True)
    before = (flash_attention.fwd_launches, flash_attention.dkv_launches,
              flash_attention.dq_launches)
    flash_attention(*ts, key_bias=tb).sum().backward()
    assert tb.grad is None
    assert all(t.grad is not None for t in ts)
    assert (flash_attention.fwd_launches, flash_attention.dkv_launches,
            flash_attention.dq_launches) == before


def test_argument_errors():
    q = torch.zeros(1, 1, 8, 8)
    with pytest.raises(ValueError, match="needs CUDA"):
        flash_attention(q, q, q, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        flash_attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, q, q, dropout_p=0.5)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        flash_attention(q, q, q, dropout_p=1.0, dropout_seed=1)
