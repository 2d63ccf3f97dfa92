"""The port's SPMD trainer over a dp x pp x tp mesh of gloo ranks on the
CPU (paddle_tpu_torch.parallel.transformer with a `parallel.env.Mesh`)
against the JAX package's `make_train_step` on the same mesh over the
virtual CPU devices, at the widths of tests/test_parallel.py (vocab 64,
d_model 32, 4 heads, d_ff 64, seq 16, 4 layers, 4 microbatches, fp32,
remat off), from the reference's `init_params(cfg, seed=5)` carried
across and `demo_batch(cfg, 8, seed=5)`.

Meshes (dp·pp·tp): Megatron 2·1·1, 1·2·1, 1·1·2, 2·2·2; Ulysses 1·1·2,
2·2·2; and 1·2·2 Megatron with remat on in bf16. For each: 3 steps'
losses (fp32: rtol 2e-4, atol 1e-5, the reference's own tolerance for
its mesh against one device; bf16: rtol 1e-2), the same on every rank,
and the step-0 gradients gathered to global shapes (fp32: rtol 5e-4,
atol 1e-6; bf16: 2e-2 relative in norm, the single-device trainer's
bf16 gradient tolerance in tests/test_torch_transformer.py: both sides
round every matmul output to bf16, at other places). Then the errors:
a mesh whose size is not the world's, a mesh on the default device
without a card, a batch that does not split over dp.

The ranks of one world size run every case of that size in one spawn
(`tests/torch_spmd_runner.py`), while this process runs the reference;
each reference runs once per module.
"""
import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.parallel import transformer as jt

import torch_spmd_runner as runner

pytestmark = pytest.mark.dist

KW = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, seq_len=16, n_layers=4,
          n_micro=4, dtype="float32", remat=False)
STEPS, BATCH, SEED = 3, 8, 5
#: name -> config changes
CASES = {
    "megatron_2x1x1": dict(dp=2, pp=1, tp=1),
    "megatron_1x2x1": dict(dp=1, pp=2, tp=1),
    "megatron_1x1x2": dict(dp=1, pp=1, tp=2),
    "megatron_2x2x2": dict(dp=2, pp=2, tp=2),
    "ulysses_1x1x2": dict(dp=1, pp=1, tp=2, sp_mode="ulysses"),
    "ulysses_2x2x2": dict(dp=2, pp=2, tp=2, sp_mode="ulysses"),
    "megatron_1x2x2_bf16_remat": dict(dp=1, pp=2, tp=2, dtype="bfloat16",
                                      remat=True),
}
LEAVES = ["embed", "pos", "ln_f/scale", "ln_f/bias"] + [
    "layers/" + k for k in ("ln1_s", "ln1_b", "wqkv", "wo", "ln2_s",
                            "ln2_b", "w1", "b1", "w2", "b2")]
ERRORS_CFG = dict(KW, dp=2)


def _world(name):
    c = CASES[name]
    return c["dp"] * c["pp"] * c["tp"]


def _leaf(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _init_params(pp):
    """The reference's `init_params(cfg, seed=SEED)`: of a case's config
    it reads only the widths, which every case shares, and pp."""
    return jt.init_params(jt.SPMDConfig(**dict(KW, pp=pp)), seed=SEED)


def _reference(name):
    """3 steps of the JAX trainer on the case's mesh: (losses, step-0
    gradients as a flat dict). The jitted step is compiled once, ahead
    of time: called, it would compile again at step 1, whose params
    carry the step's output shardings."""
    cfg = jt.SPMDConfig(**dict(KW, **CASES[name]))
    mesh = cfg.mesh()
    params = jt.shard_params(_init_params(cfg.pp), cfg, mesh)
    opt = jt.init_opt_state(params)
    tokens, labels = jt.demo_batch(cfg, BATCH, seed=SEED)
    step = jt.make_train_step(cfg, mesh, with_grads=True).lower(
        params, opt, tokens, labels, jnp.int32(0)).compile()
    losses, grads = [], None
    for i in range(STEPS):
        params, opt, loss, g = step(params, opt, tokens, labels, jnp.int32(i))
        losses.append(float(loss))
        if grads is None:
            grads = {k: _leaf(g, k) for k in LEAVES}
    return losses, grads


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> (reference (losses, grads), the port's results by rank)."""
    d = str(tmp_path_factory.mktemp("spmd_mesh"))
    by_world = {}
    for name, c in CASES.items():
        cfg = jt.SPMDConfig(**dict(KW, **c))
        path = os.path.join(d, name + ".params.npz")
        np.savez(path, **{k: _leaf(_init_params(cfg.pp), k)
                          for k in LEAVES})
        by_world.setdefault(_world(name), []).append(dict(
            kind="train", name=name, cfg=dict(KW, **c), params=path,
            steps=STEPS, batch=BATCH, seed=SEED))
    by_world[2].append(dict(kind="errors", name="errors", cfg=ERRORS_CFG,
                            batch=3))
    spawns = {n: runner.start(jobs, d, n, "w%d" % n)
              for n, jobs in by_world.items()}
    try:
        # XLA compiles outside the interpreter lock: the references
        # compile side by side
        with ThreadPoolExecutor(3) as pool:
            ref = dict(zip(CASES, pool.map(_reference, CASES)))
    finally:
        for sc in spawns.values():
            sc.join(240)
    port = {name: runner.results(d, name, _world(name)) for name in CASES}
    port["errors"] = runner.results(d, "errors", 2)
    return ref, port


@pytest.mark.parametrize("name", sorted(CASES))
def test_losses_match_jax(runs, name):
    ref, port = runs
    got = port[name][0]["losses"]
    rtol, atol = (1e-2, 0.0) if "bf16" in name else (2e-4, 1e-5)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref[name][0], rtol=rtol, atol=atol)
    assert got[-1] < got[0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_rank_reports_the_loss_and_gradients(runs, name):
    """The loss is summed over the mesh, and the gathered gradients are
    global: every rank has the same."""
    _, port = runs
    for rank in port[name][1:]:
        for k in port[name][0]:
            np.testing.assert_array_equal(rank[k], port[name][0][k],
                                          err_msg=k)


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_step0_grads_match_jax(runs, name, leaf):
    ref, port = runs
    got = port[name][0]["grad/" + leaf]
    want = ref[name][1][leaf]
    assert got.shape == want.shape
    if "bf16" in name:
        assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)
    else:
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-6)


def test_mesh_must_fill_the_world(runs):
    msg = str(runs[1]["errors"][0]["world"])
    assert "needs a world of 8 ranks; this one has 2" in msg


def test_mesh_without_a_card_raises(runs):
    """No silent CPU fallback: the default device is the rank's card."""
    msg = str(runs[1]["errors"][0]["no_card"])
    assert "CUDA device" in msg and "device='cpu'" in msg


def test_batch_must_split_over_dp(runs):
    msg = str(runs[1]["errors"][0]["batch"])
    assert "batch of 3 rows does not split over dp=2" in msg
