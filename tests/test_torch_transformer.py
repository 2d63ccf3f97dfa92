"""The port's transformer trainer (paddle_tpu_torch.parallel.transformer,
on the CPU) against the JAX package's `paddle_tpu.parallel.transformer` at
one device: the JAX parameters carried across with `params_from_numpy`,
the same `demo_batch`, then the losses of 3 steps and the gradients of the
first, with flash attention (the JAX Pallas kernels interpreted; the
port's plain flash version) and with the composite attention. Then the
port's own contracts: remat on == off, no silent CPU fallback, and the
mesh and sequence-parallel modes that are not ported raise.

Each JAX configuration runs once per module (a fixture shares it).

Tolerances: float32 losses rtol 1e-5 and gradients rtol 1e-4 with atol
1e-7 (float32 on both sides, another summation order); bfloat16 losses
rtol 1e-2 and gradients 2e-2 relative in norm (both sides round every
matmul output to bf16, at other places)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.parallel import transformer as jt
from paddle_tpu_torch.parallel import transformer as tt

SMALL = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, seq_len=16,
             n_layers=2)
#: name -> (dtype, use_flash)
CONFIGS = {"f32_flash": ("float32", True), "f32_composite": ("float32", False),
           "bf16_flash": ("bfloat16", True)}
STEPS, BATCH, SEED = 3, 4, 5
LEAVES = ["embed", "pos", "ln_f/scale", "ln_f/bias"] + [
    "layers/" + k for k in ("ln1_s", "ln1_b", "wqkv", "wo", "ln2_s",
                            "ln2_b", "w1", "b1", "w2", "b2")]


def _leaf(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return np.asarray(tree)


def _jax_params():
    cfg = jt.SPMDConfig(dtype="float32", **SMALL)
    return jax.tree.map(np.asarray, jt.init_params(cfg, seed=SEED))


def _run(make_step, params, opt, to_float):
    """Losses of STEPS steps and the first step's gradients."""
    cfg = jt.SPMDConfig(**SMALL)
    tokens, labels = jt.demo_batch(cfg, BATCH, seed=SEED)
    losses, first = [], None
    for i in range(STEPS):
        params, opt, loss, grads = make_step(params, opt, tokens, labels, i)
        losses.append(float(loss))
        if first is None:
            first = to_float(grads)
    return losses, first


@pytest.fixture(scope="module")
def jax_runs():
    params = _jax_params()
    out = {}
    for name, (dtype, flash) in CONFIGS.items():
        cfg = jt.SPMDConfig(dtype=dtype, use_flash=flash, **SMALL)
        step = jt.make_train_step(cfg, cfg.mesh(), with_grads=True)
        out[name] = _run(lambda p, o, t, l, i: step(p, o, t, l, jnp.int32(i)),
                         params, jt.init_opt_state(params),
                         lambda g: jax.tree.map(np.asarray, g))
    return out


def _port_run(dtype, flash, remat=True):
    cfg = tt.SPMDConfig(dtype=dtype, use_flash=flash, remat=remat, **SMALL)
    step = tt.make_train_step(cfg, device="cpu", with_grads=True)
    params = tt.params_from_numpy(_jax_params(), device="cpu")
    return _run(step, params, tt.init_opt_state(params),
                tt.params_to_numpy)


@pytest.fixture(scope="module")
def port_runs():
    return {name: _port_run(*cfg) for name, cfg in CONFIGS.items()}


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_losses_match_jax(jax_runs, port_runs, config, step):
    rtol = 1e-5 if CONFIGS[config][0] == "float32" else 1e-2
    got, want = port_runs[config][0][step], jax_runs[config][0][step]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=rtol)


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("config", ["f32_composite", "f32_flash"])
def test_float32_grads_match_jax(jax_runs, port_runs, config, leaf):
    got = _leaf(port_runs[config][1], leaf)
    want = _leaf(jax_runs[config][1], leaf)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("leaf", LEAVES)
def test_bfloat16_grads_match_jax_in_norm(jax_runs, port_runs, leaf):
    got = _leaf(port_runs["bf16_flash"][1], leaf)
    want = _leaf(jax_runs["bf16_flash"][1], leaf)
    assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)


def test_remat_on_equals_off(port_runs):
    off = _port_run("float32", True, remat=False)
    np.testing.assert_allclose(off[0], port_runs["f32_flash"][0], rtol=1e-6)
    for leaf in LEAVES:
        np.testing.assert_allclose(_leaf(off[1], leaf),
                                   _leaf(port_runs["f32_flash"][1], leaf),
                                   rtol=1e-5, atol=1e-8)


def test_use_flash_auto_is_composite_on_cpu(port_runs):
    auto = _port_run("float32", None)
    assert auto[0] == port_runs["f32_composite"][0]


def test_params_shapes_and_round_trip():
    cfg = tt.SPMDConfig(**SMALL)
    want = jt.init_params(jt.SPMDConfig(**SMALL))
    got = tt.init_params(cfg, seed=0, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), want) == \
        tt._tree_map(lambda t: tuple(t.shape), got)
    assert tt.init_params(cfg, seed=0, device="cpu")["embed"].equal(
        got["embed"])
    back = tt.params_to_numpy(tt.params_from_numpy(
        tt.params_to_numpy(got), device="cpu"))
    for leaf in LEAVES:
        np.testing.assert_array_equal(_leaf(back, leaf),
                                      _leaf(tt.params_to_numpy(got), leaf))
    tokens, labels = tt.demo_batch(cfg, 3, seed=2)
    jtok, jlab = jt.demo_batch(jt.SPMDConfig(**SMALL), 3, seed=2)
    np.testing.assert_array_equal(tokens, jtok)
    np.testing.assert_array_equal(labels, jlab)


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tt.SPMDConfig(**SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.make_train_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.init_params(cfg)


@pytest.mark.parametrize("mesh", [dict(dp=2), dict(pp=2), dict(tp=2),
                                  dict(sp_mode="ulysses")])
def test_unported_modes_raise(mesh):
    cfg = dataclasses.replace(tt.SPMDConfig(**SMALL), **mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 #"):
        tt.make_train_step(cfg, device="cpu")
    with pytest.raises(ValueError, match="sp_mode"):
        tt.SPMDConfig(sp_mode="ring")
