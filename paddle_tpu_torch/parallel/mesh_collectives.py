"""The collectives of the SPMD trainer over a `Mesh` (counterpart: the
`lax` primitives that `paddle_tpu/parallel/transformer.py` and
`ulysses.py` call inside `shard_map`).

The reference differentiates its step with `jax.vjp`, which transposes
each collective; here each one is a `torch.autograd.Function` whose
backward is that transpose:

- `all_gather(x, ring, dim)` (tiled): backward `psum_scatter`;
- `psum_scatter(x, ring, dim)` (tiled): backward the tiled `all_gather`;
- `ppermute(x, ring, perm)`: backward `ppermute` by the inverse
  permutation;
- `all_to_all(x, ring, split_dim, concat_dim)` (tiled): backward
  `all_to_all` with the two dims swapped;
- `psum(x, rings)`: no backward; the reference runs it only outside the
  function it differentiates.

`ring` is this rank's group on one mesh axis (`Mesh.ring(name)`); None
(an axis of size 1) makes every collective an identity. Ranks are ring
ranks, as the reference's are positions on the axis. NCCL runs them on
the card; gloo runs them on the host (a CUDA tensor goes through a host
copy and back, `ops/collective_ops.py _collective`), has no
reduce-scatter (an all-reduce and a slice stand in) and sends and
receives host tensors. `exchange` posts a rank's sends and receives
together (`batch_isend_irecv`), so a ring of two stages cannot deadlock.
Each call adds to `collective_ops.stats` under "mesh.<name>".
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..ops import collective_ops as co

__all__ = ["all_gather", "psum_scatter", "ppermute", "all_to_all", "psum",
           "exchange"]


def _trivial(ring):
    return ring is None or ring.size == 1


def _all_gather(x, ring, dim):
    def fn(t):
        if ring.backend == "nccl":
            moved = t.movedim(dim, 0).contiguous()
            out = torch.empty((ring.size * moved.shape[0],)
                              + moved.shape[1:], dtype=t.dtype,
                              device=t.device)
            dist.all_gather_into_tensor(out, moved, group=ring.group)
            return out.movedim(0, dim)
        outs = [torch.empty_like(t) for _ in range(ring.size)]
        dist.all_gather(outs, t, group=ring.group)
        return torch.cat(outs, dim)

    return co._collective("mesh.all_gather", ring, x, fn, in_place=False)


def _psum_scatter(x, ring, dim):
    n = ring.size
    if x.shape[dim] % n:
        raise ValueError("psum_scatter: dim %d of %s does not split over %d "
                         "ranks" % (dim, tuple(x.shape), n))
    rows = x.shape[dim] // n

    def fn(t):
        if ring.backend == "nccl":
            moved = t.movedim(dim, 0).contiguous()
            out = torch.empty((rows,) + moved.shape[1:], dtype=t.dtype,
                              device=t.device)
            dist.reduce_scatter_tensor(out, moved, group=ring.group)
            return out.movedim(0, dim)
        dist.all_reduce(t, group=ring.group)
        return t.narrow(dim, ring.rank * rows, rows).contiguous()

    # gloo's stand-in all-reduces `t` in place
    return co._collective("mesh.psum_scatter", ring, x, fn,
                          in_place=ring.backend != "nccl")


def _all_to_all(x, ring, split_dim, concat_dim):
    n = ring.size
    if x.shape[split_dim] % n:
        raise ValueError("all_to_all: dim %d of %s does not split over %d "
                         "ranks" % (split_dim, tuple(x.shape), n))

    def fn(t):
        inp = torch.stack(t.chunk(n, split_dim), 0).contiguous()
        out = torch.empty_like(inp)
        dist.all_to_all_single(out, inp, group=ring.group)
        return torch.cat(out.unbind(0), concat_dim)

    return co._collective("mesh.all_to_all", ring, x, fn, in_place=False)


def exchange(ring, sends, recvs, like):
    """Point to point on `ring`: `sends` is a list of (ring rank, tensor),
    `recvs` of ring ranks, each receiving a tensor shaped like `like`;
    all are posted at once and waited for. Returns the received tensors,
    on `like`'s device, in the order of `recvs`."""
    if not sends and not recvs:
        return []
    t0 = time.perf_counter()
    where = "cpu" if co.staged(ring, like) else like.device
    ops, bufs, nbytes = [], [], 0
    for peer, t in sends:
        t = t.detach().to(where).contiguous()
        nbytes += t.numel() * t.element_size()
        ops.append(dist.P2POp(dist.isend, t, ring.global_rank(peer),
                              group=ring.group))
    for peer in recvs:
        buf = torch.empty(like.shape, dtype=like.dtype, device=where)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, ring.global_rank(peer),
                              group=ring.group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = [b.to(like.device) for b in bufs]
    co.record("mesh.p2p", t0, nbytes)
    return out


def _ppermute(x, ring, perm):
    dst = [d for s, d in perm if s == ring.rank]
    src = [s for s, d in perm if d == ring.rank]
    got = exchange(ring, [(d, x) for d in dst], src, x)
    return got[0] if got else torch.zeros_like(x)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring, dim):
        ctx.ring, ctx.dim = ring, dim
        return _all_gather(x, ring, dim)

    @staticmethod
    def backward(ctx, g):
        return _psum_scatter(g, ctx.ring, ctx.dim), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring, dim):
        ctx.ring, ctx.dim = ring, dim
        return _psum_scatter(x, ring, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.ring, ctx.dim), None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring, perm):
        ctx.ring, ctx.perm = ring, perm
        return _ppermute(x, ring, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _ppermute(g, ctx.ring, inverse), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring, split_dim, concat_dim):
        ctx.ring, ctx.dims = ring, (split_dim, concat_dim)
        return _all_to_all(x, ring, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, ctx.ring, concat_dim, split_dim), None, None, \
            None


def all_gather(x, ring, dim, tiled=True):
    """Every rank's `x` along `dim` in ring order (`lax.all_gather`);
    untiled, stacked on a new axis `dim`."""
    if not tiled:
        x = x.unsqueeze(dim)
    if _trivial(ring):
        return x
    return _AllGather.apply(x, ring, dim)


def psum_scatter(x, ring, dim):
    """The sum over the ring, of which rank r keeps block r of `dim`
    (`lax.psum_scatter(..., tiled=True)`)."""
    if _trivial(ring):
        return x
    return _PsumScatter.apply(x, ring, dim)


def ppermute(x, ring, perm):
    """`x` sent from ring rank s to d for each (s, d) in `perm`; a rank
    that no pair targets gets zeros (`lax.ppermute`)."""
    if _trivial(ring):
        return x if any(s == d == 0 for s, d in perm) else torch.zeros_like(x)
    return _Ppermute.apply(x, ring, [(int(s), int(d)) for s, d in perm])


def all_to_all(x, ring, split_dim, concat_dim):
    """`x` cut into one block a rank along `split_dim`; rank r gets block
    r of every rank's `x`, concatenated along `concat_dim` in ring order
    (`lax.all_to_all(..., tiled=True)`)."""
    if _trivial(ring):
        return x
    return _AllToAll.apply(x, ring, split_dim, concat_dim)


def psum(x, rings):
    """The sum of `x` over every ring in `rings` (None entries skipped).
    Not differentiable: the reference runs its psums outside the
    function it differentiates."""
    for ring in rings:
        if not _trivial(ring):
            x = co.all_reduce(x.detach(), ring)
    return x
