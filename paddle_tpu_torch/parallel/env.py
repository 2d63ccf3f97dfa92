"""Process groups and rings (counterpart: `paddle_tpu/parallel/env.py`).

The reference runs one process over a device mesh: a `ring_id` names a
mesh axis, and the collective ops emit `lax.psum` over it while a
`collective_scope` marks the axis live inside `shard_map`. The port runs
one process per device: the data-parallel world is a `torch.distributed`
process group (NCCL for CUDA tensors, gloo on the CPU or when asked for),
and a ring maps onto a process group. A ring is live only inside a
`collective_scope`, which the executor enters while it runs a
data-parallel program; outside it every collective op is an identity, as
the reference's are outside a mesh.

The world comes from the launch contract of the reference
(`distributed/utils.py:356-360`): ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ENDPOINTS`` and
``PADDLE_CURRENT_ENDPOINT``.

`Mesh` is the counterpart of the `jax.sharding.Mesh` that the SPMD
trainer runs `shard_map` over (`transformer.py SPMDConfig.mesh`): the
world's ranks laid out row-major over named axes, with one process group
per line of ranks along each axis. The trainer's collectives
(`mesh_collectives.py`) run over this rank's group on an axis.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import os
import threading
from typing import Dict, Optional

import numpy as np

__all__ = [
    "Ring", "set_global_mesh", "global_mesh", "register_ring", "ring_info",
    "collective_scope", "active_ring", "ring_for", "trainer_id",
    "trainer_num", "trainer_endpoints", "current_endpoint", "world_size",
    "Mesh",
]

_tls = threading.local()
_uids = itertools.count(1)


class Ring:
    """One process group as a ring: `group` (a `torch.distributed`
    ProcessGroup), its `backend` ("nccl" or "gloo"), `size`, this
    process's `rank` in it and the global `ranks` it spans in order. `uid`
    is never reused, so a cache keyed on it never mixes two worlds."""

    __slots__ = ("group", "backend", "size", "rank", "ranks", "uid")

    def __init__(self, group, backend, ranks, rank):
        self.group = group
        self.backend = str(backend)
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.rank = int(rank)
        self.uid = next(_uids)

    def global_rank(self, ring_rank: int) -> int:
        """The global rank of the ring's member `ring_rank`."""
        return self.ranks[int(ring_rank)]

    def __repr__(self):
        return "Ring(%s, rank %d of %d)" % (self.backend, self.rank,
                                            self.size)


# ring_id -> Ring (the reference's ring_id -> (axis, size) registry)
_RINGS: Dict[int, Ring] = {}

# the data-parallel world, ring 0 unless another is registered
_GLOBAL: Optional[Ring] = None


def set_global_mesh(ring: Optional[Ring]):
    """Install the world's ring (None: no world)."""
    global _GLOBAL
    _GLOBAL = ring
    if ring is None:
        _RINGS.clear()


def global_mesh() -> Optional[Ring]:
    """The world's ring, or None before `init_parallel_env`."""
    return _GLOBAL


def register_ring(ring_id: int, ring: Ring):
    """Bind `ring_id` to `ring` (the counterpart of CCommInitOp)."""
    _RINGS[int(ring_id)] = ring


def ring_info(ring_id: int) -> Optional[Ring]:
    return _RINGS.get(int(ring_id))


@contextlib.contextmanager
def collective_scope(ring: Optional[Ring]):
    """Mark `ring` (the data-parallel world of the program that runs) as
    live for the collective ops run inside."""
    prev = getattr(_tls, "ring", None)
    _tls.ring = ring
    try:
        yield
    finally:
        _tls.ring = prev


def active_ring() -> Optional[Ring]:
    return getattr(_tls, "ring", None)


def ring_for(ring_id: int) -> Optional[Ring]:
    """The live ring bound to `ring_id`, or None when no ring is live
    (the op is then an identity). Ring 0 is the live world unless another
    group is registered for it."""
    live = active_ring()
    if live is None:
        return None
    ring = _RINGS.get(int(ring_id))
    if ring is not None:
        return ring
    return live if int(ring_id) == 0 else None


# -- launch env contract (reference: distributed/utils.py:356-360) ----------

def trainer_id() -> int:
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def trainer_num() -> int:
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))


def trainer_endpoints():
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    return eps.split(",") if eps else []


def current_endpoint() -> str:
    return os.environ.get("PADDLE_CURRENT_ENDPOINT", "")


def world_size() -> int:
    """The world's size: the installed ring's, else the launch env's."""
    return _GLOBAL.size if _GLOBAL is not None else trainer_num()


class Mesh:
    """The world's ranks over named axes (the reference's
    ``Mesh(np.asarray(devices[:n]).reshape(sizes), names)``), one
    `torch.distributed` group per line of ranks along each axis.

    `axis_names` and `axis_sizes` give the layout; rank r sits at
    ``np.unravel_index(r, axis_sizes)``. Joins the world of the
    ``PADDLE_*`` environment (`distributed.init_parallel_env(backend)`)
    when no world is up; the world's size must be the product of the
    sizes. Every rank creates every group, in the same order (axis by
    axis, line by line), as `torch.distributed.new_group` requires; an
    axis of size 1 has no group and its collectives are identities. Over
    NCCL each of this rank's groups runs one all-reduce here, so its
    communicator is up before a step. `device` defaults to this rank's
    card (`core.place.resolve_device`, which raises without one); pass
    "cpu" to run on the CPU over gloo."""

    def __init__(self, axis_names, axis_sizes, backend=None, device=None):
        import torch
        import torch.distributed as dist

        from .. import distributed
        from ..core.place import resolve_device

        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        if len(self.axis_names) != len(self.axis_sizes) or \
                len(set(self.axis_names)) != len(self.axis_names) or \
                min(self.axis_sizes, default=1) < 1:
            raise ValueError("a mesh needs distinct axis names and sizes >= "
                             "1, got %r x %r"
                             % (self.axis_names, self.axis_sizes))
        n = math.prod(self.axis_sizes)
        world = global_mesh()
        if world is None:
            distributed.init_parallel_env(backend)
            world = global_mesh()
        elif backend is not None and backend != world.backend:
            raise ValueError("the world runs over %s, not %s"
                             % (world.backend, backend))
        if world.size != n:
            raise ValueError(
                "a %s mesh of %s needs a world of %d ranks; this one has %d"
                % ("x".join(map(str, self.axis_sizes)),
                   "/".join(self.axis_names), n, world.size))
        self.backend = world.backend
        self.rank = world.rank
        self.device = resolve_device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an NCCL mesh runs on the card, not %s"
                             % self.device)
        self.coords = tuple(int(c) for c in np.unravel_index(
            self.rank, self.axis_sizes))
        grid = np.arange(n).reshape(self.axis_sizes)
        self._rings: Dict[str, Ring] = {}
        for ax, name in enumerate(self.axis_names):
            size = self.axis_sizes[ax]
            if size == 1:
                continue
            for line in np.moveaxis(grid, ax, -1).reshape(-1, size):
                ranks = [int(r) for r in line]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._rings[name] = Ring(group, self.backend, ranks,
                                             ranks.index(self.rank))
        if self.backend == "nccl":
            for name in self.axis_names:
                ring = self._rings.get(name)
                if ring is None:
                    continue
                one = torch.ones(1, device=self.device)
                dist.all_reduce(one, group=ring.group)
                torch.cuda.synchronize(self.device)
                if int(one.item()) != ring.size:
                    raise RuntimeError("NCCL all_reduce over the %r group "
                                       "of %d ranks gave %s"
                                       % (name, ring.size, one.item()))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def axis_index(self, name) -> int:
        """This rank's coordinate on axis `name` (`lax.axis_index`)."""
        return self.coords[self.axis_names.index(name)]

    def axis_size(self, name) -> int:
        return self.axis_sizes[self.axis_names.index(name)]

    def ring(self, name) -> Optional[Ring]:
        """This rank's group on axis `name` as a `Ring`, or None for an
        axis of size 1."""
        self.axis_names.index(name)  # raises for an unknown axis
        return self._rings.get(name)

    def __repr__(self):
        return "Mesh(%s, %s, rank %d at %s)" % (
            ", ".join("%s=%d" % kv for kv in self.shape.items()),
            self.backend, self.rank, self.coords)
