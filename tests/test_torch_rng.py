"""The port's device seeds and its stateless dropout hash
(`paddle_tpu_torch.core.rng`, `ops.kernels.dropout`), on the CPU.

The executor writes each step's seed into an int64 tensor and every op
seed is folded from it there with `op_seed`'s arithmetic, so the folds
are held bit for bit against the host's. Dropout's keep mask is a hash of
(op seed, element index): the same seed, op and iteration give the same
mask, another seed another one, and the keep rate is 1 - p within four
standard deviations. A scanned BERT-small with dropout on gives the same
gradients with remat (its recompute redraws the masks from the device
seed) and without, within rtol 1e-6 (the same ops in another order of
gradient accumulation)."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import fluid
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.core.scope import dump_numpy_state, load_numpy_state
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.ops.kernels import dropout, dropout_reference
from paddle_tpu_torch.ops.kernels.dropout import dropout_scale
from paddle_tpu_torch.ops.kernels.flash_attention import dropout_keep_mask

SEEDS = [0, 1, 7, 2**31 - 2, 987654321]


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_on_the_device_equals_the_host(seed):
    s = rng.seed_tensor(seed, "cpu")
    for idx in (0, 1, 17, 4095):
        got = rng.fold(s, idx)
        assert got.dtype == torch.int64
        assert int(got) == rng.op_seed(seed, idx)
        assert int(rng.fold(got, 3)) == rng.op_seed(rng.op_seed(seed, idx),
                                                    3)


def test_step_seed_folds_lazily():
    s = rng.StepSeed(5, rng.seed_tensor(5, "cpu"))
    child = s.fold(3).fold(2)
    assert child.host == rng.op_seed(rng.op_seed(5, 3), 2)
    assert child._dev is None  # nothing folded until asked
    assert int(child.dev) == child.host


def test_flash_seed_is_the_host_formula():
    for seed in SEEDS:
        op = rng.op_seed(seed, 11)
        got = rng.flash_seed(rng.seed_tensor(op, "cpu"))
        assert got.dtype == torch.int32 and got.shape == (1,)
        assert int(got) == (op >> 32) & 0x7FFFFFFF


def _mask(seed, op, it, shape=(64, 33), p=0.25):
    s = rng.fold(rng.fold(rng.seed_tensor(seed, "cpu"), op), it)
    return rng.keep_mask(s, shape, p)


def test_same_seed_op_iteration_same_mask():
    assert torch.equal(_mask(3, 5, 0), _mask(3, 5, 0))
    for other in (_mask(4, 5, 0), _mask(3, 6, 0), _mask(3, 5, 1)):
        assert not torch.equal(_mask(3, 5, 0), other)


@pytest.mark.parametrize("p", [0.05, 0.1, 0.5, 0.9])
def test_keep_rate_within_four_sigma(p):
    n = 1 << 16
    for seed in SEEDS[:3]:
        keep = rng.keep_mask(rng.seed_tensor(rng.op_seed(seed, 2), "cpu"),
                             (n,), p).double().mean().item()
        assert abs(keep - (1 - p)) <= 4 * (p * (1 - p) / n) ** 0.5


def test_keep_hash_matches_its_uint32_definition():
    """`keep_hash` against the hash written out in uint32 numpy
    arithmetic, as csrc/dropout.cu computes it."""
    seed = rng.op_seed(12, 3)
    got = rng.keep_hash(rng.seed_tensor(seed, "cpu"), 1000).numpy()

    def fmix(x):
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x85EBCA6B)
        x ^= x >> np.uint32(13)
        x *= np.uint32(0xC2B2AE35)
        x ^= x >> np.uint32(16)
        return x

    with np.errstate(over="ignore"):
        i = np.arange(1000, dtype=np.uint32)
        x = fmix((i * np.uint32(0x9E3779B1)) ^ np.uint32(seed & 0xFFFFFFFF))
        want = fmix(x ^ np.uint32(seed >> 32))
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("upscale", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_plain_version(dtype, upscale):
    x = torch.randn(5, 301, generator=torch.Generator().manual_seed(0)
                    ).to(dtype)
    seed = rng.seed_tensor(99, "cpu")
    dropout.launches = 0
    out, mask = dropout(x, seed, 0.3, upscale=upscale)
    assert dropout.launches == 0  # the CPU runs the plain version
    keep = rng.keep_mask(seed, x.shape, 0.3)
    assert torch.equal(mask, keep.to(torch.uint8))
    want = x * dropout_scale(0.3) if upscale else x
    assert torch.equal(out, torch.where(keep, want,
                                        torch.zeros((), dtype=dtype)))
    assert torch.equal(out, dropout_reference(x, seed, 0.3, upscale)[0])


def test_dropout_gradient_is_the_masked_scale():
    x = torch.randn(4000, dtype=torch.float64, requires_grad=True)
    out, mask = dropout(x, rng.seed_tensor(5, "cpu"), 0.2)
    (g,) = torch.autograd.grad(out.sum(), x)
    assert torch.equal(g, mask.double() * dropout_scale(0.2))


def test_dropout_op_draws_from_the_device_seed():
    x = torch.randn(8, 16)
    attrs = {"dropout_prob": 0.5, "dropout_implementation":
             "upscale_in_train", "_device": torch.device("cpu")}
    a = registry.run_op("dropout", {"X": [x]},
                        dict(attrs, _rng_seed=rng.seed_tensor(1, "cpu")))
    b = registry.run_op("dropout", {"X": [x]},
                        dict(attrs, _rng_seed=rng.seed_tensor(1, "cpu")))
    c = registry.run_op("dropout", {"X": [x]},
                        dict(attrs, _rng_seed=rng.seed_tensor(2, "cpu")))
    assert torch.equal(a["Mask"][0], b["Mask"][0])
    assert not torch.equal(a["Mask"][0], c["Mask"][0])


def test_flash_mask_takes_a_device_seed():
    """The flash kernels' plain mask from an int32 tensor seed equals the
    one from the same int."""
    t = torch.tensor([-5], dtype=torch.int32)
    want = dropout_keep_mask(-5, 2, 8, 8, 0.1)
    assert torch.equal(dropout_keep_mask(t, 2, 8, 8, 0.1), want)


def _bert_grads(remat, state, feed):
    cfg = bert.BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.1
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        total, _, _, _ = bert.bert_pretrain_loss(cfg, 32, scan_layers=True,
                                                 scan_remat=remat)
        grads = [g.name for _, g in fluid.append_backward(total)]
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    if state is None:
        exe.run(startup, scope=scope)
        state = dump_numpy_state(scope, [v.name for v in main.list_vars()
                                         if v.persistable])
    load_numpy_state(scope, state, "cpu")
    return exe.run(main, feed=feed, fetch_list=[total] + grads,
                   scope=scope), grads, state


def test_scanned_bert_same_gradients_with_and_without_remat():
    feed = bert.bert_feed(bert.BertConfig.tiny(), 4, 32)
    without, names, state = _bert_grads(False, None, feed)
    with_remat, names_r, _ = _bert_grads(True, state, feed)
    assert names == names_r and len(names) > 10
    for name, a, b in zip(["loss"] + names, without, with_remat):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7,
                                   err_msg=name)
