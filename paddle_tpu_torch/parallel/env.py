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
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
from typing import Dict, Optional

__all__ = [
    "Ring", "set_global_mesh", "global_mesh", "register_ring", "ring_info",
    "collective_scope", "active_ring", "ring_for", "trainer_id",
    "trainer_num", "trainer_endpoints", "current_endpoint", "world_size",
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
