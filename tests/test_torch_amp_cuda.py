"""float16 on the card: the flash kernels in float16 against their plain
PyTorch versions, and dynamic loss scaling's skip inside a replayed CUDA
graph. Every test here needs an NVIDIA GPU (marker ``cuda``) and skips
without one. The file imports neither JAX nor the JAX package, so on a
GPU machine without JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_amp_cuda.py

Tolerances: the float16 kernels round P and dS to float16 before their
second product, both sides compute in float32 from the same float16
inputs: 5e-3 (atol and rtol). The skip: bit for bit."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid.contrib import mixed_precision
from paddle_tpu_torch.ops.kernels import flash_attention

pytestmark = pytest.mark.cuda

TOL = 5e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("B,H,S,D,causal,bias,p", [
    (2, 4, 512, 64, False, True, 0.1),
    (2, 3, 200, 64, True, False, 0.0),
    (1, 2, 256, 128, False, True, 0.2),
])
def test_flash_float16_kernels_match_plain(dev, B, H, S, D, causal, bias, p):
    """Forward and the three gradients, kernels against the plain
    version (`impl="reference"`) on the card; every launch a float16
    tensor-core one."""
    g = torch.Generator().manual_seed(S + D)
    q, k, v, do = (torch.randn(B, H, S, D, generator=g).to(dev, torch.float16)
                   for _ in range(4))
    kb = ((torch.rand(B, S, generator=g) > 0.2).float() - 1.0).to(dev) \
        * 1e4 if bias else None
    before = dict(flash_attention.dtype_launches.get(
        "float16", {"forward": 0, "dkv": 0, "dq": 0}))
    out = {}
    for impl in ("kernel", "reference"):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = flash_attention(*leaves, key_bias=kb, causal=causal,
                            dropout_p=p, dropout_seed=7 if p else None,
                            impl=impl)
        grads = torch.autograd.grad(o, leaves, do)
        out[impl] = (o,) + grads
    for a, b in zip(out["kernel"], out["reference"]):
        assert a.dtype == torch.float16
        torch.testing.assert_close(a.float(), b.float(), atol=TOL, rtol=TOL)
    after = flash_attention.dtype_launches["float16"]
    assert {n: after[n] - before[n] for n in after} == \
        {"forward": 1, "dkv": 1, "dq": 1}


def test_flash_float16_overflow_is_not_clamped(dev):
    """A float16 result past 65504 comes out as inf (the signal loss
    scaling reads), from the kernels as from the plain version: every q
    row attends almost only to key 0 (P about 0.98), so dV of key 0 sums
    64 rows of dO = 2000, about 1.25e5."""
    q = torch.zeros((1, 1, 64, 64), device=dev, dtype=torch.float16)
    q[..., 0] = 8.0
    k = torch.zeros_like(q)
    k[:, :, 0, 0] = 8.0
    v = torch.randn(q.shape, device=dev).to(torch.float16)
    do = torch.full_like(q, 2000.0)
    for impl in ("kernel", "reference"):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = flash_attention(*leaves, impl=impl)
        dv = torch.autograd.grad(o, leaves[2], do)[0]
        assert torch.isinf(dv[:, :, 0]).all(), impl
        assert torch.isfinite(dv[:, :, 1:]).all(), impl


def _program(scale):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        img = fluid.layers.data(name="img", shape=[32], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=img, size=64, act="relu")
        logits = fluid.layers.fc(input=h, size=4)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            logits, label))
        opt = mixed_precision.decorate(
            fluid.optimizer.LambOptimizer(
                0.01, grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0)),
            amp_dtype="float16", init_loss_scaling=scale,
            incr_every_n_steps=2, decr_every_n_nan_or_inf=1,
            decr_ratio=0.5)
        opt.minimize(loss)
    return main, startup, loss, opt._scale_state


def test_overflow_skip_under_replay(dev):
    """Two clean steps (eager, then captured), then a replay at a scale of
    2^40: every param, master and moment bit-equal, the scale halved;
    then two replays from a scale of 1 double it; the same steps run
    eagerly give the same bits."""
    r = np.random.RandomState(0)
    feed = {"img": r.rand(16, 32).astype("float32"),
            "label": r.randint(0, 4, (16, 1)).astype("int64")}
    main, startup, loss, st = _program(256.0)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    scope0 = fluid.Scope()
    fluid.Executor().run(startup, scope=scope0)
    start = {n: scope0.find_var(n).clone() for n in names}
    results = {}
    for graphs in (True, False):
        fluid.set_flags({"FLAGS_cuda_graphs": graphs})
        try:
            exe, scope = fluid.Executor(), fluid.Scope()
            for n, v in start.items():
                scope.set_var(n, v.clone())
            counter = main._seed_counter
            scales, skips = [], []
            for scale in (None, None, 2.0 ** 40, 1.0, None):
                if scale is not None:
                    scope.set_var(st["scale"], torch.full(
                        (1,), scale, dtype=torch.float32, device=dev))
                before = {n: scope.find_var(n).clone() for n in names}
                exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
                scales.append(float(scope.find_var(st["scale"])))
                skips.append(all(torch.equal(before[n], scope.find_var(n))
                                 for n in names if n not in st.values()))
            main._seed_counter = counter
            results[graphs] = (scales, skips, exe.last_entry.phase,
                               {n: scope.find_var(n).clone()
                                for n in names})
        finally:
            fluid.set_flags({"FLAGS_cuda_graphs": True})
    scales, skips, phase, final = results[True]
    assert phase == "captured"
    assert skips == [False, False, True, False, False]
    assert scales == [256.0, 512.0, 2.0 ** 39, 1.0, 2.0]
    assert results[False][:2] == (scales, skips)
    for n in names:
        assert torch.equal(final[n], results[False][3][n]), n
