"""Random generators of the port's random ops (counterpart:
`paddle_tpu/core/rng.py`).

The reference derives one stateless JAX key per run from the program's
seed (`fluid/framework.py _global_seed_and_bump`) and folds in each op's
index. The port seeds one `torch.Generator` per random op, on the op's
device, from the same (seed, op index) pair: a program with a fixed
`random_seed` draws the same values on every run. The streams differ
from JAX's threefry, so no test depends on matching them.
"""
from __future__ import annotations

import torch

_MIX = 0x9E3779B97F4A7C15  # golden-ratio constant: spreads the op index
_MASK = (1 << 63) - 1


def op_seed(seed: int, op_idx: int) -> int:
    """The generator seed of op `op_idx` in a run seeded `seed`."""
    return (int(seed) * _MIX + int(op_idx) + 1) & _MASK


def make_generator(seed: int, op_idx: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(op_seed(seed, op_idx))
    return g
