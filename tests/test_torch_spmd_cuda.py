"""The SPMD trainer's mesh path on the card at world size 1 over NCCL.
Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_spmd_cuda.py

The module joins an NCCL world of one rank (`init_parallel_env`) and
leaves it at the end. On a 1·1·1 `Mesh` every collective is an identity
and the GPipe schedule has one stage, so the mesh step must equal the
single-device step bit for bit: 3 steps' losses, every parameter and
moment after them, and the step-0 gradients, in bf16 with the flash
kernels and remat (the default `SPMDConfig`'s choices at small widths)
and in fp32 with the composite attention."""
import dataclasses

import pytest
import torch

from paddle_tpu_torch import distributed
from paddle_tpu_torch.parallel import transformer as tt

pytestmark = pytest.mark.cuda

SMALL = dict(vocab=512, d_model=128, n_heads=2, d_ff=256, seq_len=128,
             n_layers=2, n_micro=2)
STEPS, BATCH = 3, 4


@pytest.fixture(scope="module")
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    distributed.init_parallel_env(backend="nccl")
    yield
    distributed.shutdown_parallel_env()


def _run(cfg, mesh):
    params = tt.init_params(cfg, seed=3, device="cuda")
    if mesh is not None:
        params = tt.shard_params(params, cfg, mesh)
    opt = tt.init_opt_state(params)
    step = tt.make_train_step(cfg, mesh, with_grads=True)
    tokens, labels = tt.demo_batch(cfg, BATCH, seed=3)
    losses, first = [], None
    for i in range(STEPS):
        params, opt, loss, grads = step(params, opt, tokens, labels, i)
        losses.append(float(loss))
        if first is None:
            first = grads
    return losses, _leaves(params, *opt, first)


def _leaves(*trees):
    out = []
    for tree in trees:
        tt._tree_map(out.append, tree)
    return out


@pytest.mark.parametrize("kind", ["bf16_flash_remat", "f32_composite"])
def test_mesh_1x1x1_equals_single_device(world, kind):
    cfg = tt.SPMDConfig(**SMALL)
    if kind == "f32_composite":
        cfg = dataclasses.replace(cfg, dtype="float32", use_flash=False,
                                  remat=False)
    mesh = cfg.mesh(backend="nccl")
    assert mesh.backend == "nccl" and mesh.device.type == "cuda"
    assert all(mesh.ring(a) is None for a in tt.AXES)
    single = _run(cfg, None)
    meshed = _run(cfg, mesh)
    assert single[0] == meshed[0]
    assert len(single[1]) == len(meshed[1]) == 4 * 14
    for a, b in zip(single[1], meshed[1]):
        assert torch.equal(a, b)
