"""Strided q/k/v/o in the port's flash attention, on the CPU (the plain
PyTorch versions; the kernels read the same strides on the card, see
tests/test_torch_flash_cuda.py).

- `flash_attention` on the trainer's views (heads of one [B, S, 3, H, D]
  tensor) gives the same output and gradients as on contiguous copies;
- `pad_and_flatten` hands q, k and v on as they are when S needs no
  padding, and pads as before when it does;
- the output is a view of a [B, S, H, D] tensor, so merging the heads
  back copies nothing;
- what the kernels are given: views as they are where TMA can read them,
  contiguous copies where it cannot;
- the trainer's step at S 512 passes q, k, v and the cotangent to the
  flash functions without a copy, and its head merge reads the output in
  place.

Tolerances: exact on the CPU (the same float32 arithmetic on the same
values, whatever the strides), except where noted."""
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention
from paddle_tpu_torch.parallel import transformer as tt

fa = sys.modules[flash_attention.__module__]


def _qkv(seed, B, S, H, D, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    qkv = torch.tensor(rng.standard_normal((B, S, 3, H, D)),
                       dtype=torch.float32).to(dtype).requires_grad_(True)
    return qkv, [qkv[:, :, i].transpose(1, 2) for i in range(3)]


@pytest.mark.parametrize("S", [64, 50])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_views_match_contiguous_copies(S, dtype):
    B, H, D = 2, 3, 16
    qkv, (q, k, v) = _qkv(1, B, S, H, D, dtype)
    w = torch.tensor(np.random.default_rng(2).standard_normal((B, H, S, D)),
                     dtype=torch.float32)
    out = flash_attention(q, k, v, causal=True)
    (out.float() * w).sum().backward()
    copies = [x.detach().contiguous().requires_grad_(True)
              for x in (q, k, v)]
    ref = flash_attention(*copies, causal=True)
    (ref.float() * w).sum().backward()
    assert torch.equal(out, ref)
    for i, c in enumerate(copies):
        assert torch.equal(qkv.grad[:, :, i].transpose(1, 2), c.grad)


def test_pad_and_flatten_passes_views_through():
    qkv, (q, k, v) = _qkv(3, 2, 64, 3, 16)
    qf, kf, vf, bias = fa.pad_and_flatten(q, k, v)
    assert qf is q and kf is k and vf is v and bias is None
    assert qf.data_ptr() == qkv.data_ptr()
    assert kf.untyped_storage().data_ptr() == qkv.untyped_storage().data_ptr()
    # a key bias is flattened to one float32 row per (b, h)
    key_bias = torch.zeros(2, 64)
    key_bias[1, 40:] = -1e4
    _, _, _, bias = fa.pad_and_flatten(q, k, v, key_bias)
    assert bias.shape == (6, 64) and bias.is_contiguous()
    assert torch.equal(bias[3:], key_bias[1].expand(3, 64))


def test_pad_and_flatten_pads_unaligned_s():
    _, (q, k, v) = _qkv(4, 2, 50, 3, 16)
    qf, kf, vf, bias = fa.pad_and_flatten(q, k, v)
    assert qf.shape == kf.shape == vf.shape == (2, 3, 56, 16)
    assert torch.equal(qf[:, :, :50], q) and not qf[:, :, 50:].any()
    assert bias.shape == (6, 56)
    assert not bias[:, :50].any() and bool((bias[:, 50:] == -1e30).all())


@pytest.mark.parametrize("S", [64, 50])
def test_output_is_a_view_of_bshd(S):
    B, H, D = 2, 3, 16
    _, (q, k, v) = _qkv(5, B, S, H, D)
    out = flash_attention(q, k, v, causal=True)
    assert out.shape == (B, H, S, D)
    merged = out.transpose(1, 2).reshape(B, S, H * D)
    assert merged.data_ptr() == out.data_ptr()


def test_kernel_inputs_copy_only_what_tma_cannot_read():
    _, (q, k, v) = _qkv(6, 2, 64, 3, 16, torch.bfloat16)
    ops = fa._kernel_inputs((q, k, v), tensor_cores=True)
    assert all(a is b for a, b in zip(ops, (q, k, v)))
    # a row of 20 bf16 values (40 bytes) is not 16-byte aligned: copied for
    # TMA, read in place by the SIMT kernels
    base = torch.zeros(2, 3, 64, 20, dtype=torch.bfloat16)
    view = base[..., :16]
    (copied,) = fa._kernel_inputs((view,), tensor_cores=True)
    assert copied.is_contiguous() and torch.equal(copied, view)
    (same,) = fa._kernel_inputs((view,), tensor_cores=False)
    assert same is view
    # a strided last dimension is copied for both
    (copied,) = fa._kernel_inputs((base[..., ::2],), tensor_cores=False)
    assert copied.is_contiguous()
    # D not a multiple of 8: zero-padded for the tensor cores
    odd = torch.ones(1, 2, 8, 36, dtype=torch.bfloat16)
    (padded,) = fa._kernel_inputs((odd,), tensor_cores=True)
    assert padded.shape == (1, 2, 8, 40) and not padded[..., 36:].any()


def test_strides_for_the_kernels():
    _, (q, _, _) = _qkv(7, 2, 64, 3, 16, torch.bfloat16)
    # batch, head, row strides of a [B, S, 3, H, D] head view
    assert list(fa._strides(q)) == [64 * 3 * 3 * 16, 16, 3 * 3 * 16]
    # size-1 dimensions get 16 bytes, a valid TMA stride
    one = torch.zeros(1, 1, 64, 16, dtype=torch.bfloat16)
    assert list(fa._strides(one)) == [8, 8, 16]
    out = fa._empty_bshd(q, 64)
    assert out.shape == q.shape and out.transpose(1, 2).is_contiguous()


def test_train_step_passes_views_to_flash(monkeypatch):
    """The trainer at S 512: q, k and v reach the flash functions as views
    of one qkv tensor, the cotangent arrives as a view of the head merge's
    gradient, and the output's head merge is a view."""
    seen = {"fwd": [], "bwd": []}
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_bwd

    def spy_fwd(q, k, v, *args, **kw):
        o, lse = fwd(q, k, v, *args, **kw)
        seen["fwd"].append((q, k, v, o))
        return o, lse

    def spy_bwd(q, k, v, bias, seed, o, lse, do, **kw):
        seen["bwd"].append((q, k, v, do))
        return bwd(q, k, v, bias, seed, o, lse, do, **kw)

    monkeypatch.setattr(fa, "flash_attention_fwd", spy_fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", spy_bwd)
    cfg = tt.SPMDConfig(vocab=64, d_model=32, n_heads=4, d_ff=64,
                        seq_len=512, n_layers=1, dtype="float32",
                        use_flash=True)
    params = tt.init_params(cfg, seed=0, device="cpu")
    step = tt.make_train_step(cfg, device="cpu")
    tokens, labels = tt.demo_batch(cfg, 2, seed=0)
    _, _, loss = step(params, tt.init_opt_state(params), tokens, labels, 0)
    assert np.isfinite(float(loss))
    # remat runs the forward twice
    assert len(seen["fwd"]) == 2 and len(seen["bwd"]) == 1
    for q, k, v, o in seen["fwd"]:
        store = q.untyped_storage().data_ptr()
        assert not q.is_contiguous() and q.shape == (2, 4, 512, 8)
        assert k.untyped_storage().data_ptr() == store
        assert v.untyped_storage().data_ptr() == store
        assert o.transpose(1, 2).is_contiguous()
    q, k, v, do = seen["bwd"][0]
    assert do.shape == q.shape and not do.is_contiguous()
    assert do.transpose(1, 2).is_contiguous()
