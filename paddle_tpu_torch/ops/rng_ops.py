"""Random operators (counterpart: `paddle_tpu/ops/rng_ops.py`): the
initializers `uniform_random`, `gaussian_random` and
`truncated_gaussian_random` (a standard normal truncated to [-2, 2],
then scaled and shifted, as the reference draws it); the samplers
`uniform_random_batch_size_like`, `bernoulli`, `exponential`,
`gumbel_softmax`, `multinomial`, `poisson`, `randint`, `randperm` and
`sampling_id`; and `seed`.

Each draws from `attrs["_rng_generator"]`, a `torch.Generator` seeded on
the host by the lowering from the program's seed and the op's index
(`core/rng.py make_generator`). As in the reference, the op's own `seed`
attr is not read. They are registered ``rng="host"``: a block holding one
runs eagerly, never as a captured CUDA graph. Initializers belong to
startup programs, which run once, so nothing is lost by not capturing
them, and a generator seeded on the host keeps their draws exactly as
they were.

The samplers are registered ``rng="device"``: they draw from the op's
seed as the device folds it (`attrs["_rng_seed"]`, an int64 tensor),
through `core/rng.py keep_hash`, a stateless hash of (stream seed,
element index). Nothing is read on the host and no torch generator is
used, so a captured step draws anew at every replay from the seed
written before it, and the same seed repeats the same draws. Uniforms
take the hash's top 24 bits (open interval (0, 1)); normals are
Box-Muller over two streams; categorical draws are the Gumbel-max of
the logits; `poisson` inverts the CDF below a rate of 10 and uses the
transformed rejection (PTRS, as JAX does) from 10 up, each over a fixed
number of rounds (a draw left unresolved after them, of probability
below 1e-15, takes the rate rounded). The streams differ from JAX's by
design (ROADMAP "Differences by design" 5); the tests hold them by
support, dtype, shape and moments. `seed` is host-side (`no_jit`), a
fresh numpy draw unless its attr is set, as the reference's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .registry import register_op
from ..core.rng import fold, keep_hash
from ..core.types import to_torch_dtype


def _draw(attrs):
    return torch.empty(tuple(int(d) for d in attrs["shape"]),
                       dtype=torch.float32, device=attrs["_device"])


@register_op("uniform_random", rng="host")
def _uniform_random(ins, attrs):
    out = _draw(attrs).uniform_(attrs.get("min", -1.0),
                                attrs.get("max", 1.0),
                                generator=attrs["_rng_generator"])
    return {"Out": out.to(to_torch_dtype(attrs.get("dtype", "float32")))}


@register_op("gaussian_random", rng="host")
def _gaussian_random(ins, attrs):
    out = _draw(attrs).normal_(attrs.get("mean", 0.0), attrs.get("std", 1.0),
                               generator=attrs["_rng_generator"])
    return {"Out": out.to(to_torch_dtype(attrs.get("dtype", "float32")))}


@register_op("truncated_gaussian_random", rng="host")
def _truncated_gaussian_random(ins, attrs):
    out = torch.nn.init.trunc_normal_(
        _draw(attrs), 0.0, 1.0, -2.0, 2.0,
        generator=attrs["_rng_generator"])
    out = out * attrs.get("std", 1.0) + attrs.get("mean", 0.0)
    return {"Out": out.to(to_torch_dtype(attrs.get("dtype", "float32")))}


# -- the samplers: stateless draws from the op's device seed ------------------

def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def device_bits(seed_t, shape, stream=0):
    """uint32 hash values (in int64) of `shape` from stream `stream` of
    op seed `seed_t`."""
    shape = tuple(int(d) for d in shape)
    return keep_hash(fold(seed_t.reshape(()), stream),
                     _numel(shape)).reshape(shape)


def device_uniform(seed_t, shape, stream=0):
    """float32 uniforms in the open interval (0, 1): the hash's top 24
    bits, centred in their cell."""
    return ((device_bits(seed_t, shape, stream) >> 8).to(torch.float32)
            + 0.5) * (1.0 / 16777216.0)


def device_normal(seed_t, shape, stream=0):
    """float32 standard normals: Box-Muller over streams 2s and 2s+1."""
    u1 = device_uniform(seed_t, shape, 2 * stream)
    u2 = device_uniform(seed_t, shape, 2 * stream + 1)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
        (2.0 * math.pi) * u2)


def _gumbel(seed_t, shape, stream=0):
    return -torch.log(-torch.log(device_uniform(seed_t, shape, stream)))


def _categorical(seed_t, probs, num=None):
    """Indices drawn from the last axis of `probs` (log of at least
    1e-30, as the reference takes it), by Gumbel-max; `num` draws a row
    (a new last axis) or one."""
    logits = torch.log(torch.clamp_min(probs.to(torch.float32), 1e-30))
    if num is None:
        g = _gumbel(seed_t, logits.shape)
        return torch.argmax(logits + g, dim=-1)
    shape = tuple(logits.shape[:-1]) + (num, logits.shape[-1])
    g = _gumbel(seed_t, shape)
    return torch.argmax(logits.unsqueeze(-2) + g, dim=-1)


@register_op("uniform_random_batch_size_like", rng="device")
def _uniform_random_bsl(ins, attrs):
    """Uniforms in [min, max) of `shape`, its dim `output_dim_idx` taken
    from Input's dim `input_dim_idx`."""
    ref = ins["Input"][0]
    shape = [int(d) for d in attrs["shape"]]
    shape[attrs.get("output_dim_idx", 0)] = ref.shape[
        attrs.get("input_dim_idx", 0)]
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    out = lo + (hi - lo) * device_uniform(attrs["_rng_seed"], shape)
    return {"Out": out.to(to_torch_dtype(attrs.get("dtype", "float32")))}


@register_op("bernoulli", rng="device")
def _bernoulli(ins, attrs):
    """1 with probability X, else 0, in X's dtype."""
    x = ins["X"][0]
    u = device_uniform(attrs["_rng_seed"], x.shape)
    return {"Out": (u < x).to(x.dtype)}


@register_op("exponential", rng="device")
def _exponential(ins, attrs):
    """Exponential draws of rate `lambda`, X's shape and dtype."""
    x = ins["X"][0]
    u = torch.clamp_min(device_uniform(attrs["_rng_seed"], x.shape), 1e-7)
    return {"Out": (-torch.log(u) / attrs.get("lambda", 1.0)).to(x.dtype)}


@register_op("gumbel_softmax", rng="device")
def _gumbel_softmax(ins, attrs):
    """softmax((X + Gumbel noise) / temperature) along `axis`; `hard`
    gives the one-hot of its argmax with the soft value's gradient."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    g = _gumbel(attrs["_rng_seed"], x.shape).to(x.dtype)
    y = torch.softmax((x + g) / attrs.get("temperature", 1.0), dim=axis)
    if attrs.get("hard", False):
        idx = torch.argmax(y, dim=axis, keepdim=True)
        onehot = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = onehot + y - y.detach()
    return {"Out": y}


@register_op("multinomial", rng="device")
def _multinomial(ins, attrs):
    """`num_samples` category draws a row of the probabilities X (with
    replacement, as the reference draws them)."""
    out = _categorical(attrs["_rng_seed"], ins["X"][0],
                       int(attrs.get("num_samples", 1)))
    return {"Out": out.to(to_torch_dtype("int64"))}


@register_op("sampling_id", rng="device")
def _sampling_id(ins, attrs):
    """One category draw a row of the probabilities X."""
    return {"Out": _categorical(attrs["_rng_seed"], ins["X"][0]).to(
        to_torch_dtype("int64"))}


#: CDF inversion below this rate, PTRS from it
_POISSON_SPLIT = 10.0
_POISSON_INVERSION_STEPS = 48
_POISSON_PTRS_ROUNDS = 16


def _poisson_draw(seed_t, lam):
    """Poisson draws of the float32 rates `lam` (see the module
    docstring)."""
    shape = lam.shape
    small = lam < _POISSON_SPLIT
    # inversion: the least k with CDF(k) >= u
    u = device_uniform(seed_t, shape, 0)
    lam_s = torch.where(small, lam, torch.zeros_like(lam))
    p = torch.exp(-lam_s)
    cdf = p.clone()
    k_small = torch.zeros_like(lam)
    for k in range(1, _POISSON_INVERSION_STEPS + 1):
        more = u > cdf
        k_small = k_small + more.to(lam.dtype)
        p = p * lam_s / k
        cdf = cdf + p
    # PTRS (Hormann 1993), for rates of 10 and up
    lam_l = torch.where(small, torch.full_like(lam, _POISSON_SPLIT), lam)
    log_lam = torch.log(lam_l)
    b = 0.931 + 2.53 * torch.sqrt(lam_l)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    vr = 0.9277 - 3.6224 / (b - 2.0)
    k_large = torch.round(lam_l)
    done = torch.zeros_like(small)
    for r in range(_POISSON_PTRS_ROUNDS):
        uu = device_uniform(seed_t, shape, 1 + 2 * r) - 0.5
        v = device_uniform(seed_t, shape, 2 + 2 * r)
        us = 0.5 - torch.abs(uu)
        k = torch.floor((2.0 * a / us + b) * uu + lam_l + 0.43)
        fast = (us >= 0.07) & (v <= vr)
        reject = (k < 0) | ((us < 0.013) & (v > us))
        log_v = torch.log(v) + torch.log(inv_alpha) \
            - torch.log(a / (us * us) + b)
        slow = ~reject & (log_v <= -lam_l + k * log_lam
                          - torch.lgamma(k + 1.0))
        accept = ~done & (fast | slow)
        k_large = torch.where(accept, k, k_large)
        done = done | accept
    return torch.where(small, k_small, k_large)


@register_op("poisson", rng="device")
def _poisson(ins, attrs):
    """Poisson draws of the rates X, in X's dtype."""
    x = ins["X"][0]
    return {"Out": _poisson_draw(attrs["_rng_seed"],
                                 x.to(torch.float32)).to(x.dtype)}


@register_op("randint", rng="device")
def _randint(ins, attrs):
    """Integers in [low, high) of `shape`: low + (hash * range) >> 32."""
    shape = tuple(int(d) for d in attrs["shape"])
    low, high = int(attrs.get("low", 0)), int(attrs.get("high", 100))
    h = device_bits(attrs["_rng_seed"], shape)
    out = low + ((h * (high - low)) >> 32)
    return {"Out": out.to(to_torch_dtype(attrs.get("dtype", "int64")))}


@register_op("randperm", rng="device")
def _randperm(ins, attrs):
    """A permutation of 0..n-1: the stable argsort of 62-bit hash keys."""
    n = int(attrs["n"])
    seed = attrs["_rng_seed"]
    key = (device_bits(seed, (n,), 0) << 30) ^ device_bits(seed, (n,), 1)
    perm = torch.sort(key, stable=True)[1]
    return {"Out": perm.to(to_torch_dtype(attrs.get("dtype", "int64")))}


@register_op("seed", no_jit=True)
def _seed(ins, attrs):
    """The `seed` attr when nonzero, else a fresh draw of numpy's global
    generator (host-side, as the reference's), as an int32 [1]."""
    user_seed = int(attrs.get("seed", 0))
    val = user_seed if user_seed != 0 \
        else int(np.random.randint(0, 2**31 - 1))
    return {"Out": torch.full((1,), val, dtype=torch.int32,
                              device=attrs["_device"])}
