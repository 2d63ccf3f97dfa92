"""Collective operators over `torch.distributed` (counterpart:
`paddle_tpu/ops/collective_ops.py`).

Reference parity: `paddle/fluid/operators/collective/` (c_allreduce_{sum,
max,min,prod}, c_broadcast, c_allgather, c_reducescatter, ...). The
reference maps a `ring_id` to a mesh axis and emits `lax.psum` /
`all_gather` / `psum_scatter` while the axis is live inside `shard_map`.
The port runs one process per device: a live ring is a process group
(`parallel/env.py ring_for`) and each op is a collective over it, NCCL on
the card, gloo on the CPU. Where no ring is live (a program that is not
data-parallel, shape inference) every op is an identity, as the
reference's are outside a mesh. Stream-sync ops are identities: torch
orders a collective after the work that produced its input.

Every op is built from three collectives, `all_reduce`, `broadcast` and
`all_gather`, which both backends have. Gloo's collectives run on the
host: a CUDA tensor goes through a host copy and comes back (the
`stage` of `_collective`). Each collective returns a new tensor and
leaves its input as it was (the executor's environment never changes a
tensor in place). `stats` counts each collective's calls, host seconds
and bytes, under the kind and, for a ring along a hybrid mesh axis, the
axis (``all_reduce.ici``).

On a hybrid (dcn, ici) world the ring-0 sum runs within the pod and then
across pods (`all_reduce` over the ring's `ici`, then its `dcn`); a
gather or broadcast runs over the world's group, whose rank order is the
pair's. `start` launches a collective without waiting for it (the
gradient exchange launched from the backward): its `Pending.wait()`
gives the result.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from .registry import register_op
from ..parallel import env as penv

_REDUCE = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}

#: collective -> {"calls", "seconds" (host clock), "bytes" (sent by this
#: rank's input)}; `reset_stats()` zeroes it
stats = {}


def reset_stats():
    stats.clear()


def staged(ring, x):
    """Whether the ring's backend reads `x` only through a host copy
    (gloo and a tensor on the card)."""
    return ring.backend == "gloo" and x.device.type != "cpu"


def record(kind, t0, nbytes):
    """Add one call of `kind`, begun at host time `t0`, to `stats`."""
    s = stats.setdefault(kind, {"calls": 0, "seconds": 0.0, "bytes": 0})
    s["calls"] += 1
    s["seconds"] += time.perf_counter() - t0
    s["bytes"] += nbytes


def _kind(kind, ring):
    return kind if ring.axis is None else "%s.%s" % (kind, ring.axis)


def _operand(ring, x, in_place):
    """(`t`, staged): a contiguous tensor holding `x` that the ring's
    backend can read (a host copy for gloo), a copy of its own where the
    collective writes it."""
    stage = staged(ring, x)
    if stage:
        return x.detach().to("cpu", memory_format=torch.contiguous_format), \
            True
    if in_place:
        return x.detach().clone(memory_format=torch.contiguous_format), False
    return x.detach().contiguous(), False


def _collective(kind, ring, x, fn, in_place=True):
    """Run `fn(t)` on a contiguous `t` holding `x` where the ring's
    backend can read it (a host copy for gloo); returns what `fn`
    returns, each tensor back on `x`'s device. A `fn` that writes `t`
    (`in_place`) gets a copy; one that only reads it gets `x` itself
    where `x` is contiguous and needs no staging."""
    t0 = time.perf_counter()
    t, stage = _operand(ring, x, in_place)
    out = fn(t)
    if stage:
        out = [o.to(x.device) for o in out] if isinstance(out, list) \
            else out.to(x.device)
    record(_kind(kind, ring), t0, x.numel() * x.element_size())
    return out


class Pending:
    """A collective in flight (`start`). `wait()` returns its result on
    the input's device (over NCCL it only orders the calling stream after
    the collective) and counts the call in `stats`, with the host time of
    its launch and its wait."""

    __slots__ = ("kind", "work", "out", "select", "device", "stage",
                 "seconds", "nbytes")

    def __init__(self, kind, work, out, select, device, stage, seconds,
                 nbytes):
        self.kind, self.work, self.out, self.select = kind, work, out, select
        self.device, self.stage = device, stage
        self.seconds, self.nbytes = seconds, nbytes

    def wait(self):
        t0 = time.perf_counter()
        self.work.wait()
        out = self.out if self.select is None else self.select(self.out)
        if self.stage:
            out = out.to(self.device)
        record(self.kind, t0 - self.seconds, self.nbytes)
        return out


def start(kind, ring, x, fn, in_place=True, select=None) -> Pending:
    """Launch `fn(t)` as `_collective` would, where `fn` issues its
    collective with ``async_op=True`` and returns (work, result); the
    wait gives ``select(result)`` (default: the result)."""
    t0 = time.perf_counter()
    t, stage = _operand(ring, x, in_place)
    work, out = fn(t)
    return Pending(_kind(kind, ring), work, out, select, x.device, stage,
                   time.perf_counter() - t0, x.numel() * x.element_size())


def all_reduce(x, ring, op="sum"):
    """`op` ("sum", "max", "min") of `x` over the ring, on every member;
    on a hybrid world's ring, within the pod and then across pods."""
    if x.device.type == "meta":
        return x.clone()
    if ring.dcn is not None:
        if ring.ici is not None:
            x = all_reduce(x, ring.ici, op)
        return all_reduce(x, ring.dcn, op)

    def fn(t):
        dist.all_reduce(t, op=_REDUCE[op], group=ring.group)
        return t

    return _collective("all_reduce", ring, x, fn)


def all_reduce_start(x, ring, kind="all_reduce") -> Pending:
    """The sum of `x` over the ring, launched (`start`). On a hybrid
    world's ring the sum within the pod runs first and the launch is the
    sum across pods (over NCCL the first wait orders the streams only)."""
    if ring.dcn is not None:
        if ring.ici is not None:
            x = all_reduce_start(x, ring.ici, kind).wait()
        ring = ring.dcn

    def fn(t):
        return dist.all_reduce(t, group=ring.group, async_op=True), t

    return start(kind, ring, x, fn)


def all_reduce_mean(x, ring):
    """The mean of `x` over the ring (the reference's `lax.pmean`: the
    sum, then a division by the ring's size)."""
    return all_reduce(x, ring) / ring.size


def broadcast(x, ring, root=0):
    """The value of the ring's member `root` (a rank in the ring), on
    every member."""
    if x.device.type == "meta":
        return x.clone()

    def fn(t):
        dist.broadcast(t, src=ring.global_rank(root), group=ring.group)
        return t

    return _collective("broadcast", ring, x, fn)


def all_gather(x, ring):
    """Every member's `x`, as a list in ring order."""
    if x.device.type == "meta":
        return [x] * ring.size

    def fn(t):
        outs = [torch.empty_like(t) for _ in range(ring.size)]
        dist.all_gather(outs, t, group=ring.group)
        return outs

    return _collective("all_gather", ring, x, fn, in_place=False)


def _ring(attrs):
    return penv.ring_for(attrs.get("ring_id", 0))


def _register_allreduce(suffix):
    @register_op("c_allreduce_" + suffix)
    def _c_allreduce(ins, attrs, _op=suffix):
        x = ins["X"][0]
        ring = _ring(attrs)
        if ring is None:
            return {"Out": x}
        if _op == "prod":
            # all_gather and a product over the members, as the
            # reference (`:74-79`): exact for zeros and negatives, unlike
            # exp(sum(log))
            return {"Out": torch.stack(all_gather(x, ring)).prod(0)}
        return {"Out": all_reduce(x, ring, _op)}


for _suffix in ("sum", "max", "min", "prod"):
    _register_allreduce(_suffix)


@register_op("c_broadcast")
def _c_broadcast(ins, attrs):
    x = ins["X"][0]
    ring = _ring(attrs)
    if ring is None:
        return {"Out": x}
    return {"Out": broadcast(x, ring, attrs.get("root", 0))}


@register_op("c_allgather")
def _c_allgather(ins, attrs):
    x = ins["X"][0]
    ring = _ring(attrs)
    if ring is None:
        return {"Out": x}
    return {"Out": torch.cat(all_gather(x, ring), 0)}


@register_op("c_reducescatter")
def _c_reducescatter(ins, attrs):
    """The sum over the ring, of which member r keeps block r of axis 0
    (the reference's tiled `psum_scatter`)."""
    x = ins["X"][0]
    ring = _ring(attrs)
    if ring is None:
        return {"Out": x}
    rows = x.shape[0] // ring.size
    return {"Out": all_reduce(x, ring)[ring.rank * rows:
                                       (ring.rank + 1) * rows]}


@register_op("c_reduce_sum")
def _c_reduce_sum(ins, attrs):
    """Reduce to the root: the root keeps the sum, the others their
    input (the reference defines only the root's output)."""
    x = ins["X"][0]
    ring = _ring(attrs)
    if ring is None:
        return {"Out": x}
    total = all_reduce(x, ring)
    return {"Out": total if ring.rank == attrs.get("root_id", 0) else x}


@register_op("alltoall")
def _alltoall(ins, attrs):
    """Axis 0 cut into one block per member; member r gets block r of
    every member's input, in ring order."""
    x = ins["X"][0]
    ring = _ring(attrs)
    if ring is None:
        return {"Out": x}
    n = ring.size
    rows = x.shape[0] // n
    parts = all_gather(x, ring)
    return {"Out": torch.cat([p[ring.rank * rows:(ring.rank + 1) * rows]
                              for p in parts], 0)}


@register_op("c_concat")
def _c_concat(ins, attrs):
    x = ins["X"][0]
    ring = _ring(attrs)
    if ring is None:
        return {"Out": x}
    return {"Out": torch.cat(all_gather(x, ring), x.ndim - 1)}


@register_op("c_split")
def _c_split(ins, attrs):
    """Member r's block of the last axis (no communication)."""
    x = ins["X"][0]
    ring = _ring(attrs)
    if ring is None:
        return {"Out": x}
    piece = x.shape[-1] // ring.size
    return {"Out": x[..., ring.rank * piece:(ring.rank + 1) * piece]}


@register_op("c_embedding")
def _c_embedding(ins, attrs):
    """Vocab-sharded lookup: rows of this member's table [start_index,
    start_index + rows), zeros elsewhere, summed over the ring."""
    w, ids = ins["W"][0], ins["Ids"][0]
    local = ids.to(torch.int64) - attrs.get("start_index", 0)
    valid = (local >= 0) & (local < w.shape[0])
    out = w[local.clamp(0, w.shape[0] - 1)]
    out = torch.where(valid.unsqueeze(-1), out, torch.zeros_like(out))
    ring = _ring(attrs)
    if ring is not None:
        out = all_reduce(out, ring)
    return {"Out": out}


@register_op("c_identity")
def _c_identity(ins, attrs):
    return {"Out": ins["X"][0]}


@register_op("c_sync_calc_stream")
def _c_sync_calc(ins, attrs):
    return {"Out": ins["X"][0]}


@register_op("c_sync_comm_stream")
def _c_sync_comm(ins, attrs):
    return {"Out": list(ins["X"])}


@register_op("allreduce")
def _legacy_allreduce(ins, attrs):
    """The legacy `allreduce` op (operators/distributed_ops): ring 0,
    `reduce_type` 0 sum, 1 max, 2 min, else a product as
    exp(sum(log)), as the reference computes it."""
    x = ins["X"][0]
    ring = penv.ring_for(0)
    if ring is None:
        return {"Out": x}
    red = attrs.get("reduce_type", 0)
    if red in (0, 1, 2):
        return {"Out": all_reduce(x, ring, ("sum", "max", "min")[red])}
    return {"Out": torch.exp(all_reduce(torch.log(x), ring))}


@register_op("broadcast")
def _legacy_broadcast(ins, attrs):
    return _c_broadcast({"X": ins["X"]},
                        {"ring_id": 0, "root": attrs.get("root", 0)})


@register_op("dgc")
def _dgc(ins, attrs):
    raise NotImplementedError(
        "dgc (deep gradient compression) is not ported yet (ROADMAP Queue "
        "1 #10)")
