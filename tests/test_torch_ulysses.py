"""Ulysses sequence parallelism in the port (paddle_tpu_torch.parallel.
ulysses) on 2 and 4 gloo ranks on the CPU against the JAX package's
`ulysses_attention_sharded` on as many virtual CPU devices: the cases of
tests/test_ulysses.py. Forward (atol, rtol 2e-5) and the gradients of
sum(output * w) with respect to q, k and v (2e-4), causal or not, with
the plain attention and with the flash function's plain version (held
against the reference's plain path, as tests/test_ulysses.py holds its
flash path), rank by rank (each rank owns its rows); then 3 heads over 2
and 4 ranks raise.

Each world runs its cases in one spawn (`tests/torch_spmd_runner.py`),
while this process runs the reference.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from paddle_tpu.parallel.ulysses import ulysses_attention_sharded

import torch_spmd_runner as runner

pytestmark = pytest.mark.dist

WORLDS = (2, 4)
B, S, H, D = 2, 32, 8, 16   # 8 heads divide over 2 and 4 ranks


def _reference(n, x):
    """(tag -> output [B, S, H, D], tag -> (dq, dk, dv)) for causal and
    full attention on an n-device "sp" mesh."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("sp",))
    q, k, v, w = (jnp.asarray(x[key]) for key in "qkvw")
    out = {}
    for causal in (False, True):
        @jax.jit
        def fwd_bwd(q, k, v):
            y, vjp = jax.vjp(lambda *qkv: ulysses_attention_sharded(
                *qkv, mesh, causal=causal), q, k, v)
            return y, vjp(w)

        y, grads = fwd_bwd(q, k, v)
        out["causal" if causal else "full"] = (
            np.asarray(y), [np.asarray(g) for g in grads])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ulysses"))
    rng = np.random.default_rng(1)
    x = {key: rng.standard_normal((B, S, H, D)).astype(np.float32)
         for key in "qkvw"}
    path = os.path.join(d, "qkvw.npz")
    np.savez(path, **x)
    spawns = {n: runner.start([dict(kind="ulysses", name="u%d" % n,
                                    inputs=path)], d, n, "w%d" % n)
              for n in WORLDS}
    try:
        ref = {n: _reference(n, x) for n in WORLDS}
    finally:
        for sc in spawns.values():
            sc.join(120)
    return ref, {n: runner.results(d, "u%d" % n, n) for n in WORLDS}


@pytest.mark.parametrize("route", ["plain", "flash"])
@pytest.mark.parametrize("causal", ["full", "causal"])
@pytest.mark.parametrize("n", WORLDS)
def test_ulysses_matches_jax(runs, n, causal, route):
    ref, port = runs
    want_y, want_grads = ref[n][causal]
    rows = S // n
    for r in range(n):
        got = port[n][r]
        sl = slice(r * rows, (r + 1) * rows)
        tag = "%s/%s" % (route, causal)
        np.testing.assert_allclose(got[tag + "/y"], want_y[:, sl],
                                   atol=2e-5, rtol=2e-5,
                                   err_msg="%s rank %d" % (tag, r))
        for key, want in zip("qkv", want_grads):
            np.testing.assert_allclose(got["%s/d%s" % (tag, key)],
                                       want[:, sl], atol=2e-4, rtol=2e-4,
                                       err_msg="%s d%s rank %d"
                                       % (tag, key, r))


@pytest.mark.parametrize("n", WORLDS)
def test_ulysses_head_divisibility_enforced(runs, n):
    _, port = runs
    for r in range(n):
        msg = str(port[n][r]["divisibility"])
        assert "3 heads over %d ranks" % n in msg
