"""Random seeds of the port's random ops (counterpart:
`paddle_tpu/core/rng.py`).

The reference derives one stateless JAX key per run from the program's
seed (`fluid/framework.py _global_seed_and_bump`), passed into the jitted
step as a traced argument, and folds in each op's index. The port keeps
the step's seed on the device too: the executor writes it into an int64
tensor (`seed_tensor`), and `fold` derives an op's seed from it there
with `op_seed`'s arithmetic (the op index, then a scan's or loop's
iteration). Nothing is read back on the host, so a captured CUDA graph
draws new values at every replay from the seed written before it.

Dropout draws its keep mask from `keep_hash`, a stateless counter-based
hash of (op seed, element index), the same in eager runs, in graph
replays and in remat's recompute. The flash kernels keep the reference's
own hash of (row, col, head, seed) and take their int32 seed from
`flash_seed`.

The initializers (`uniform_random`, `gaussian_random`,
`truncated_gaussian_random`) draw from a `torch.Generator` seeded on the
host by `make_generator`; a block holding one is never captured
(`fluid/lowering.py capture_blocker`). The streams differ from JAX's
threefry, so no test depends on matching them.
"""
from __future__ import annotations

import torch

_MIX = 0x9E3779B97F4A7C15  # golden-ratio constant: spreads the op index
_MASK = (1 << 63) - 1
_MASK32 = 0xFFFFFFFF
#: _MIX as an int64 (two's complement): device products wrap mod 2^64,
#: so the low 63 bits equal the host's
_MIX_I64 = _MIX - (1 << 64)


def op_seed(seed: int, op_idx: int) -> int:
    """The seed of op `op_idx` in a run seeded `seed` (host ints)."""
    return (int(seed) * _MIX + int(op_idx) + 1) & _MASK


class StepSeed:
    """The seed of a run, or of one iteration of a loop in it: the host
    int (for the initializers' generators) and the int64 device tensor
    (for dropout and attention), folded from its parent's only when an op
    first asks for it, so a block without random ops launches nothing for
    its seeds."""

    __slots__ = ("host", "_dev", "_parent", "_idx")

    def __init__(self, host: int, dev: torch.Tensor = None, parent=None,
                 idx: int = 0):
        self.host, self._dev, self._parent, self._idx = host, dev, parent, idx

    @property
    def dev(self) -> torch.Tensor:
        if self._dev is None:
            self._dev = fold(self._parent.dev, self._idx)
        return self._dev

    def fold(self, idx: int) -> "StepSeed":
        """The seed of op (or iteration) `idx` under this one."""
        return StepSeed(op_seed(self.host, idx), parent=self, idx=idx)


def make_generator(seed: int, op_idx: int, device) -> torch.Generator:
    """A generator for an initializer op, seeded from host ints."""
    g = torch.Generator(device=device)
    g.manual_seed(op_seed(seed, op_idx))
    return g


def seed_tensor(seed: int, device) -> torch.Tensor:
    """A 0-dim int64 tensor on `device` holding `seed` (masked to 63
    bits), made by a fill: no host-to-device copy."""
    return torch.full((), int(seed) & _MASK, dtype=torch.int64,
                      device=device)


def fold(seed_t: torch.Tensor, idx) -> torch.Tensor:
    """`op_seed(seed, idx)` on the device: `seed_t` an int64 tensor, the
    result an int64 tensor of its shape, bit-equal to the host's."""
    return (seed_t * _MIX_I64 + (int(idx) + 1)) & _MASK


def flash_seed(seed_t: torch.Tensor) -> torch.Tensor:
    """The flash kernels' int32 dropout seed from an op seed: bits 32-62,
    as a [1] int32 tensor on the seed's device."""
    return ((seed_t >> 32) & 0x7FFFFFFF).to(torch.int32).reshape(1)


def keep_threshold(p: float) -> int:
    """The uint32 threshold of a keep decision: an element is kept where
    its hash is at or above it (probability 1 - p)."""
    return min(int(float(p) * 4294967296.0), _MASK32)


def _fmix32(x):
    """murmur3's finalizer over uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _MASK32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _MASK32
    return x ^ (x >> 16)


def keep_hash(seed_t: torch.Tensor, n: int) -> torch.Tensor:
    """The uint32 hash (in int64) of elements 0..n-1 under op seed
    `seed_t`: the index spread by a golden-ratio multiply, xor the seed's
    low word, murmur3's finalizer, xor its high word, the finalizer
    again. `csrc/dropout.cu` computes the same in uint32. Indices repeat
    past 2^32 elements."""
    s = seed_t.reshape(()).to(torch.int64)
    i = torch.arange(int(n), dtype=torch.int64, device=seed_t.device)
    x = _fmix32(((i * 0x9E3779B1) & _MASK32) ^ (s & _MASK32))
    return _fmix32(x ^ ((s >> 32) & _MASK32))


def keep_mask(seed_t: torch.Tensor, shape, p: float) -> torch.Tensor:
    """Bool keep mask of `shape` (row-major element order), kept with
    probability 1 - p, from `keep_hash`."""
    n = 1
    for d in shape:
        n *= int(d)
    return (keep_hash(seed_t, n) >= keep_threshold(p)).reshape(
        tuple(shape))
