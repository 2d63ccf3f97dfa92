"""The ragged paged attention CUDA kernel against its plain PyTorch
version, on the card. Every test here needs an NVIDIA GPU (marker
``cuda``) and skips without one. The file imports neither JAX nor the JAX
package, so on a GPU machine without JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_rpa_cuda.py

Tolerance: max abs error 2e-5 with rtol 1e-4 (float32 arithmetic on both
sides, in another summation order), and exact zeros on inactive rows.
The kernel splits every sequence's keys into chunks of 128 positions and
merges the chunks in order, so a sequence's result is bit-equal alone and
inside a batch, and from run to run."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import (ragged_paged_attention,
                                          ragged_paged_attention_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, seed, seqs, Q, Hq, Hkv, D, page, npages, dtype):
    rng = np.random.default_rng(seed)
    S = len(seqs)
    P = S * npages + 2
    k = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    tables = np.zeros((S, npages), np.int32)
    perm = rng.permutation(P - 1) + 1
    n = 0
    for s, (ctx, _) in enumerate(seqs):
        for j in range(-(-ctx // page)):
            tables[s, j] = perm[n]
            n += 1
    kw = {}
    if dtype == torch.int8:
        ks = np.maximum(np.abs(k).max(axis=(2, 3)), 1e-9) / 127.0
        vs = np.maximum(np.abs(v).max(axis=(2, 3)), 1e-9) / 127.0
        k = np.clip(np.round(k / ks[:, :, None, None]), -127, 127)
        v = np.clip(np.round(v / vs[:, :, None, None]), -127, 127)
        kw = dict(k_scale=torch.tensor(ks, dtype=torch.float32, device=dev),
                  v_scale=torch.tensor(vs, dtype=torch.float32, device=dev))
    t = lambda a, dt=torch.int32: torch.tensor(a, dtype=dt, device=dev)
    q = t(rng.standard_normal((S, Q, Hq, D)), torch.float32)
    return (q, t(k, dtype), t(v, dtype), t(tables),
            t([c for c, _ in seqs]), t([n for _, n in seqs])), kw


SHAPES = {
    "decode": dict(seqs=[(48, 1), (5, 1), (16, 1), (0, 0)], Q=1, Hq=4,
                   Hkv=4, D=64, page=16, npages=4),
    "prefill_mixed": dict(seqs=[(40, 40), (13, 13), (17, 1), (64, 0)],
                          Q=40, Hq=4, Hkv=4, D=64, page=16, npages=4),
    "gqa_d128": dict(seqs=[(30, 7), (3, 2), (16, 1)], Q=7, Hq=12, Hkv=4,
                     D=128, page=16, npages=2),
    "small_head_dim": dict(seqs=[(24, 24), (9, 1)], Q=24, Hq=2, Hkv=1, D=8,
                           page=4, npages=6),
    "odd_head_dim": dict(seqs=[(11, 3), (7, 7)], Q=7, Hq=3, Hkv=3, D=100,
                         page=8, npages=2),
    "page_over_32_slots": dict(seqs=[(90, 30), (47, 1)], Q=30, Hq=2, Hkv=2,
                               D=32, page=48, npages=2),
    # contexts over many chunks, ending mid-chunk and mid-page, with GQA
    # (held against JAX on the CPU in test_torch_ragged_paged_attention.py)
    "long_context_gqa": dict(seqs=[(1999, 4), (1025, 1), (130, 3),
                                   (2000, 0), (777, 2)], Q=4, Hq=12, Hkv=4,
                             D=64, page=16, npages=125),
    # more packed rows (G 3 x Q 30 = 90) than one 64-row tile holds
    "two_row_tiles": dict(seqs=[(300, 30), (129, 1), (128, 17)], Q=30,
                          Hq=6, Hkv=2, D=64, page=16, npages=20),
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int8": torch.int8}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_matches_plain(dev, shape, dtype):
    spec = dict(SHAPES[shape])
    seqs = spec["seqs"]
    args, kw = _inputs(dev, sum(map(ord, shape)), dtype=DTYPES[dtype],
                       **spec)
    before = ragged_paged_attention.launches
    got = ragged_paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches == before + 1
    want = ragged_paged_attention_reference(*args, **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-5)
    for s, (_, n) in enumerate(seqs):
        assert not got[s, n:].any()


def test_kernel_rejects_what_it_does_not_take(dev):
    args, _ = _inputs(dev, 0, [(8, 1)], Q=1, Hq=2, Hkv=2, D=160, page=8,
                      npages=1, dtype=torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        ragged_paged_attention(*args)
    args, kw = _inputs(dev, 0, [(8, 1)], Q=1, Hq=2, Hkv=2, D=16, page=8,
                       npages=1, dtype=torch.float32)
    q, kp, vp, tb, cl, ql = args
    with pytest.raises(TypeError, match="float32 q"):
        ragged_paged_attention(q.half(), kp, vp, tb, cl, ql)
    with pytest.raises(ValueError, match="contiguous"):
        ragged_paged_attention(q.transpose(2, 3).contiguous().transpose(
            2, 3), kp, vp, tb, cl, ql)
    with pytest.raises(TypeError, match="int32"):
        ragged_paged_attention(q, kp, vp, tb.long(), cl, ql)
    with pytest.raises(ValueError, match="is on"):
        ragged_paged_attention(q, kp.cpu(), vp.cpu(), tb, cl, ql)
    with pytest.raises(ValueError, match="int8"):
        ragged_paged_attention(q, kp, vp, tb, cl, ql,
                               k_scale=torch.ones(kp.shape[:2], device=dev),
                               v_scale=torch.ones(kp.shape[:2], device=dev))


#: a batch of 8: long and short contexts, prefill and decode rows, an
#: inactive slot; GQA at BERT-base head_dim
BATCH = dict(seqs=[(1999, 4), (17, 4), (640, 1), (1025, 3), (0, 0),
                   (129, 2), (777, 4), (1500, 1)], Hq=12, Hkv=4, D=64,
             page=16, npages=125)


@pytest.mark.parametrize("Q", [1, 4])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_alone_bit_equal_to_batch(dev, dtype, Q):
    spec = dict(BATCH, seqs=[(c, min(n, Q)) for c, n in BATCH["seqs"]])
    args, kw = _inputs(dev, 21, Q=Q, dtype=DTYPES[dtype], **spec)
    q, kp, vp, tables, ctx, ql = args
    batched = ragged_paged_attention(*args, **kw)
    for s in range(q.shape[0]):
        alone = ragged_paged_attention(
            q[s:s + 1].contiguous(), kp, vp, tables[s:s + 1].contiguous(),
            ctx[s:s + 1].contiguous(), ql[s:s + 1].contiguous(), **kw)
        assert torch.equal(alone[0], batched[s]), "sequence %d" % s
    torch.testing.assert_close(
        batched, ragged_paged_attention_reference(*args, **kw), rtol=1e-4,
        atol=2e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_two_runs_bit_equal(dev, dtype):
    args, kw = _inputs(dev, 22, Q=4, dtype=DTYPES[dtype], **BATCH)
    a = ragged_paged_attention(*args, **kw)
    b = ragged_paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
