"""The port's autograd collectives (paddle_tpu_torch.parallel.
mesh_collectives) on 2 and 4 gloo ranks on the CPU against `jax.vjp` of
the `lax` primitives under `shard_map` on as many virtual CPU devices:
each collective's output and the gradient of sum(output * cotangent),
rank by rank, float32 within 1e-6 (the same sums in another order).

Each world runs every case in one spawn (`tests/torch_spmd_runner.py`),
while this process runs the reference.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.parallel.env import shard_map_compat

import torch_spmd_runner as runner

pytestmark = pytest.mark.dist

WORLDS = (2, 4)


def _cases(n):
    """name -> (local input shape, local output shape, the lax function
    of the local input)."""
    ring = [(i, (i + 1) % n) for i in range(n)]
    chain = [(i, i + 1) for i in range(n - 1)]
    return {
        "all_gather": ((2, 3, 4), (2, 3 * n, 4), lambda x: lax.all_gather(
            x, "x", axis=1, tiled=True)),
        "all_gather_untiled": ((2, 3, 4), (n, 2, 3, 4),
                               lambda x: lax.all_gather(x, "x", axis=0)),
        "psum_scatter": ((2, 2 * n, 4), (2, 2, 4),
                         lambda x: lax.psum_scatter(
                             x, "x", scatter_dimension=1, tiled=True)),
        "ppermute": ((2, 3, 4), (2, 3, 4),
                     lambda x: lax.ppermute(x, "x", ring)),
        "ppermute_partial": ((2, 3, 4), (2, 3, 4),
                             lambda x: lax.ppermute(x, "x", chain)),
        "all_to_all": ((2 * n, 3, 4), (2, 3 * n, 4),
                       lambda x: lax.all_to_all(x, "x", 0, 1, tiled=True)),
    }


def _reference(n, inputs):
    """name -> (outputs [n, ...], input gradients [n, ...]) of the lax
    functions on an n-device mesh, rank r's block at row r."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))
    out = {}
    for name, (_, _, fn) in _cases(n).items():
        f = shard_map_compat(fn, mesh=mesh, in_specs=P("x"),
                             out_specs=P("x"), check_vma=False)
        x, ct = inputs[name + "/x"], inputs[name + "/ct"]
        y, vjp = jax.vjp(f, jnp.asarray(x.reshape((-1,) + x.shape[2:])))
        (dx,) = vjp(jnp.asarray(ct.reshape((-1,) + ct.shape[2:])))
        out[name] = (np.asarray(y).reshape(ct.shape),
                     np.asarray(dx).reshape(x.shape))
    f = shard_map_compat(lambda x: lax.psum(x, "x"), mesh=mesh,
                         in_specs=P("x"), out_specs=P("x"), check_vma=False)
    x = inputs["all_gather/x"]
    out["psum"] = (np.asarray(f(jnp.asarray(x.reshape(
        (-1,) + x.shape[2:])))).reshape(x.shape), None)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh_collectives"))
    rng = np.random.default_rng(0)
    inputs, spawns = {}, {}
    for n in WORLDS:
        arrays = {}
        for name, (shape_in, shape_out, _) in _cases(n).items():
            arrays[name + "/x"] = rng.standard_normal(
                (n,) + shape_in).astype(np.float32)
            arrays[name + "/ct"] = rng.standard_normal(
                (n,) + shape_out).astype(np.float32)
        path = os.path.join(d, "inputs%d.npz" % n)
        np.savez(path, **arrays)
        inputs[n] = arrays
        spawns[n] = runner.start([dict(kind="collectives", name="c%d" % n,
                                       inputs=path)], d, n, "w%d" % n)
    try:
        ref = {n: _reference(n, inputs[n]) for n in WORLDS}
    finally:
        for sc in spawns.values():
            sc.join(120)
    return ref, {n: runner.results(d, "c%d" % n, n) for n in WORLDS}


@pytest.mark.parametrize("name", sorted(_cases(2)))
@pytest.mark.parametrize("n", WORLDS)
def test_forward_and_backward_match_jax_vjp(runs, n, name):
    ref, port = runs
    want_y, want_dx = ref[n][name]
    for r in range(n):
        np.testing.assert_allclose(port[n][r][name + "/y"], want_y[r],
                                   rtol=1e-6, atol=1e-6,
                                   err_msg="%s rank %d" % (name, r))
        np.testing.assert_allclose(port[n][r][name + "/dx"], want_dx[r],
                                   rtol=1e-6, atol=1e-6,
                                   err_msg="d%s rank %d" % (name, r))


@pytest.mark.parametrize("n", WORLDS)
def test_psum_matches_jax(runs, n):
    ref, port = runs
    for r in range(n):
        np.testing.assert_allclose(port[n][r]["psum/y"], ref[n]["psum"][0][r],
                                   rtol=1e-6, atol=1e-6)
