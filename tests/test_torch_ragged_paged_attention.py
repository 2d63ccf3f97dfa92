"""The port's ragged paged attention (paddle_tpu_torch) against the JAX
package's: the plain PyTorch version is held against JAX's
`ragged_paged_attention_reference` and against the Pallas kernel run in
interpret mode (``impl="kernel"``) on the same numpy inputs — mixed
prefill and decode, decode only, GQA, an inactive slot (exact zeros) and
int8 pages with per-slot scales.

Tolerance: fp32, rtol 1e-5 and atol 1e-6. Both sides compute in float32
on the CPU; they differ only in summation order (einsum vs the kernel's
page-by-page online softmax).

The long-context GQA case is the shape that tests/test_torch_rpa_cuda.py
runs on the card against the plain version (the kernel's 128-position
chunks: contexts up to 2,000 slots that end mid-chunk and mid-page), so
the plain version is held against JAX there too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import ragged_paged_attention as jax_rpa
from paddle_tpu_torch.ops.kernels import (ragged_paged_attention,
                                          ragged_paged_attention_reference)

RTOL, ATOL = 1e-5, 1e-6
PAGE = 8


def _paged_setup(seed, seqs, Q, Hq, Hkv, D, npages, quant=False,
                 page=PAGE):
    """numpy inputs for `seqs` = [(ctx_len, q_len), ...]: each sequence's
    pages in random order, the pad entries pointing at page 0."""
    rng = np.random.default_rng(seed)
    S = len(seqs)
    P = S * npages + 3
    k_pages = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    v_pages = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    tables = np.zeros((S, npages), np.int32)
    perm = rng.permutation(P - 1) + 1
    nxt = 0
    for s, (ctx, _) in enumerate(seqs):
        for j in range(-(-ctx // page)):
            tables[s, j] = perm[nxt]
            nxt += 1
    out = dict(q=rng.standard_normal((S, Q, Hq, D)).astype(np.float32),
               k_pages=k_pages, v_pages=v_pages, block_tables=tables,
               context_lens=np.array([c for c, _ in seqs], np.int32),
               q_lens=np.array([n for _, n in seqs], np.int32))
    if quant:
        ks = np.maximum(np.abs(k_pages).max(axis=(2, 3)), 1e-9) / 127.0
        vs = np.maximum(np.abs(v_pages).max(axis=(2, 3)), 1e-9) / 127.0
        out["k_pages"] = np.clip(np.round(k_pages / ks[:, :, None, None]),
                                 -127, 127).astype(np.int8)
        out["v_pages"] = np.clip(np.round(v_pages / vs[:, :, None, None]),
                                 -127, 127).astype(np.int8)
        out["k_scale"] = ks.astype(np.float32)
        out["v_scale"] = vs.astype(np.float32)
    return out


def _call_jax(inp, impl):
    a = {k: jnp.asarray(v) for k, v in inp.items()}
    return np.asarray(jax_rpa(
        a["q"], a["k_pages"], a["v_pages"], a["block_tables"],
        a["context_lens"], a["q_lens"], impl=impl,
        k_scale=a.get("k_scale"), v_scale=a.get("v_scale")))


def _call_port(inp, fn=ragged_paged_attention, **kw):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    return fn(t["q"], t["k_pages"], t["v_pages"], t["block_tables"],
              t["context_lens"], t["q_lens"], k_scale=t.get("k_scale"),
              v_scale=t.get("v_scale"), **kw).numpy()


CASES = {
    # a long prefill, a mid prefill, a decode, a page-straddling decode
    "mixed_prefill_decode": dict(seqs=[(24, 24), (13, 13), (17, 1),
                                       (8, 1)], Q=24, Hq=2, Hkv=2, D=16,
                                 npages=4),
    # decode only, one context exactly filling its last page
    "decode_only": dict(seqs=[(PAGE * 3, 1), (5, 1), (PAGE, 1),
                              (PAGE + 1, 1)], Q=1, Hq=4, Hkv=4, D=8,
                        npages=4),
    "gqa": dict(seqs=[(10, 3), (20, 1)], Q=3, Hq=4, Hkv=2, D=16, npages=3),
    "inactive_slot": dict(seqs=[(12, 1), (0, 0)], Q=1, Hq=2, Hkv=2, D=8,
                          npages=2),
    "int8_pages": dict(seqs=[(16, 2), (5, 4), (32, 1)], Q=4, Hq=4, Hkv=2,
                       D=16, npages=4, quant=True),
    # the card tests' long-context GQA shape (BERT-base head_dim, serving
    # pages of 16): contexts across many 128-position chunks, ending
    # mid-chunk and mid-page, prefill and decode rows, an inactive slot
    "long_context_gqa": dict(seqs=[(1999, 4), (1025, 1), (130, 3),
                                   (2000, 0), (777, 2)], Q=4, Hq=12, Hkv=4,
                             D=64, npages=125, page=16),
}


@pytest.mark.parametrize("jax_impl", ["reference", "kernel"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_jax(case, jax_impl):
    """The port's plain version (what the wrapper runs on the CPU) equals
    JAX's reference and JAX's kernel in interpret mode."""
    spec = dict(CASES[case])
    inp = _paged_setup(sum(map(ord, case)), **spec)
    want = _call_jax(inp, jax_impl)
    got = _call_port(inp)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # rows past q_len (and whole inactive slots) are exact zeros
    for s, (_, n) in enumerate(spec["seqs"]):
        assert not got[s, n:].any()


def test_reference_and_auto_agree_on_cpu():
    """On CPU tensors "auto" runs the plain version, and counts no launch."""
    inp = _paged_setup(7, [(12, 3), (7, 1)], Q=3, Hq=4, Hkv=2, D=16,
                       npages=2)
    before = ragged_paged_attention.launches
    a = _call_port(inp)
    b = _call_port(inp, fn=ragged_paged_attention_reference)
    assert np.array_equal(a, b)
    assert ragged_paged_attention.launches == before


def test_arg_validation():
    """The wrapper rejects what `_check_args` rejects, an unknown impl,
    and the kernel for tensors that are not on the card."""
    inp = _paged_setup(5, [(8, 1)], Q=1, Hq=3, Hkv=2, D=8, npages=2)
    with pytest.raises(ValueError, match="multiple"):
        _call_port(inp)
    good = _paged_setup(5, [(8, 1)], Q=1, Hq=2, Hkv=2, D=8, npages=2)
    bad_ctx = dict(good, context_lens=np.zeros((2,), np.int32))
    with pytest.raises(ValueError, match="context_lens"):
        _call_port(bad_ctx)
    bad_hd = dict(good, q=np.zeros((1, 1, 2, 4), np.float32))
    with pytest.raises(ValueError, match="head_dim"):
        _call_port(bad_hd)
    half_scale = dict(good, k_scale=np.ones((good["k_pages"].shape[0],
                                              PAGE), np.float32))
    with pytest.raises(ValueError, match="k_scale"):
        _call_port(half_scale)
    with pytest.raises(ValueError, match="impl"):
        _call_port(good, impl="nope")
    with pytest.raises(ValueError, match="CUDA"):
        _call_port(good, impl="kernel")


def test_kernel_build_raises_and_caches(tmp_path, monkeypatch):
    """The build is nvcc per source into the build directory: a failing
    compiler raises with its output, a missing one raises, and a built
    library is reused until its source changes."""
    from paddle_tpu_torch.ops.kernels import _build

    assert "ragged_paged_attention" in _build.sources()
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["ragged_paged_attention"])

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no card here' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="no card here"):
        _build.build(["ragged_paged_attention"])

    # a compiler that writes its -o target: built once, then reused
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\n')
    first = _build.build(["ragged_paged_attention"])["ragged_paged_attention"]
    assert not first["cached"] and first["path"].endswith(".so")
    assert first["path"].startswith(str(tmp_path / "build"))
    again = _build.build(["ragged_paged_attention"])["ragged_paged_attention"]
    assert again["cached"] and again["path"] == first["path"]
