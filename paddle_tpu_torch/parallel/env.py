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

Multi-pod data parallelism (the reference's `:142-363`): with
``FLAGS_tpu_dcn_replicas`` or ``PADDLE_NUM_PODS`` above 1,
`create_hybrid_mesh` factors the world into a ``(dcn, ici)`` `Mesh`, pod
p holding the contiguous ranks [p ici, (p+1) ici). A data-parallel
program then runs over the pair (the mesh's `pair`): the world's ring
with this rank's `ici` and `dcn` rings attached, so a ring-0 sum runs
within the pod and then across pods (the reference's `lax.psum` over
the axis pair), and the sharded update shards over `ici` and sums each
shard over `dcn`. A gather or broadcast over the pair is the world's,
whose rank order is the pair's, dcn-major.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import os
import threading
import warnings
from typing import Dict, Optional

import numpy as np

__all__ = [
    "Ring", "set_global_mesh", "global_mesh", "register_ring", "ring_info",
    "collective_scope", "active_ring", "ring_for", "trainer_id",
    "trainer_num", "trainer_endpoints", "current_endpoint", "world_size",
    "Mesh", "DCN_AXIS", "ICI_AXIS", "MODEL_AXIS", "dcn_replicas",
    "hybrid_shape", "create_hybrid_mesh", "program_ring",
    "MeshHierarchy", "mesh_hierarchy",
]

_tls = threading.local()
_uids = itertools.count(1)


class Ring:
    """One process group as a ring: `group` (a `torch.distributed`
    ProcessGroup), its `backend` ("nccl" or "gloo"), `size`, this
    process's `rank` in it and the global `ranks` it spans in order. `uid`
    is never reused, so a cache keyed on it never mixes two worlds.
    `axis` names the hybrid mesh axis the ring runs along ("ici" or
    "dcn"; `collective_ops.stats` counts its calls under that suffix).
    The ring of a hybrid world (`Mesh.pair`) also carries this rank's
    `ici` and `dcn` rings (None for an axis of size 1) and its `mesh`;
    a flat ring has none."""

    __slots__ = ("group", "backend", "size", "rank", "ranks", "uid", "axis",
                 "ici", "dcn", "mesh")

    def __init__(self, group, backend, ranks, rank, axis=None, ici=None,
                 dcn=None, mesh=None):
        self.group = group
        self.backend = str(backend)
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.rank = int(rank)
        self.uid = next(_uids)
        self.axis = axis
        self.ici, self.dcn, self.mesh = ici, dcn, mesh

    @property
    def hierarchy(self):
        """The `MeshHierarchy` of a hybrid world's ring, else None."""
        return mesh_hierarchy(self.mesh)

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
        _HYBRID.clear()


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
    group is registered for it; a hybrid world's ring 0 is always its
    (dcn, ici) pair (the reference's `axis_name_for_ring`)."""
    live = active_ring()
    if live is None:
        return None
    if int(ring_id) == 0 and live.dcn is not None:
        return live
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
        #: a hybrid mesh's ring of the (dcn, ici) pair: the world's ring
        #: with this rank's ici and dcn rings (`create_hybrid_mesh`)
        self.pair: Optional[Ring] = None
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


# -- hybrid (dcn, ici) world: multi-pod data parallelism ---------------------
#
# A job that spans pods, or hosts of several cards, has a slow link
# between them (DCN, or the network between hosts) and a fast one within
# (ICI, or NVLink). Factoring the data-parallel world into (dcn, ici)
# lets a gradient sum run within the pod first, so only 1/ici of its
# bytes cross the slow link in the sharded update.

#: the axes of the hybrid factorization: DCN_AXIS the major (slow,
#: cross-pod) one, ICI_AXIS the minor (fast, within the pod);
#: MODEL_AXIS is tensor parallelism's, not ported (ROADMAP Queue 1 #10)
DCN_AXIS = "dcn"
ICI_AXIS = "ici"
MODEL_AXIS = "model"

# (world uid, dcn, ici) -> the hybrid Mesh built over that world
_HYBRID: Dict[tuple, "Mesh"] = {}


def dcn_replicas(default=1) -> int:
    """The number of pods asked for: ``FLAGS_tpu_dcn_replicas`` when set
    (> 0), else the ``PADDLE_NUM_PODS`` launch env, else `default` (1:
    a flat world)."""
    from ..utils.flags import get_flag

    try:
        v = int(get_flag("FLAGS_tpu_dcn_replicas", 0) or 0)
    except (TypeError, ValueError):
        v = 0
    if v > 0:
        return v
    try:
        return int(os.environ.get("PADDLE_NUM_PODS", "") or default)
    except ValueError:
        return default


def hybrid_shape(nranks, dcn=None):
    """(dcn, ici) for a world of `nranks` ranks in `dcn` pods (default
    `dcn_replicas()`), or None for a flat world: one rank, one pod, or a
    pod count that does not divide the world (which warns, as the
    reference does: never a wrong mesh)."""
    n = int(nranks)
    dcn = max(int(dcn if dcn is not None else dcn_replicas()), 1)
    if n <= 1 or dcn <= 1:
        return None
    if n % dcn:
        warnings.warn(
            "hybrid mesh: %d rank(s) not divisible by "
            "FLAGS_tpu_dcn_replicas=%d; falling back to the flat dp world"
            % (n, dcn))
        return None
    return dcn, n // dcn


def create_hybrid_mesh(nranks=None, dcn=None, mp=None, device=None):
    """The hybrid ``Mesh(("dcn", "ici"), (dcn, ici))`` over the live
    world of `nranks` ranks (default: the world's size), pods in
    contiguous blocks of ranks, or None where no factorization applies
    (`hybrid_shape`: the caller runs the flat world). Built once a world
    and kept (every rank must ask alike: its groups are created
    collectively). `device` is the card of an NCCL world (default: this
    rank's) and unused over gloo. Tensor parallelism (`mp` > 1) is not
    ported (ROADMAP Queue 1 #10) and raises."""
    if int(mp or 1) > 1:
        raise NotImplementedError(
            "a hybrid mesh with a model axis (mp %d) is not ported (ROADMAP "
            "Queue 1 #10)" % int(mp))
    shape = hybrid_shape(nranks if nranks is not None else world_size(),
                         dcn)
    if shape is None:
        return None
    world = global_mesh()
    if world is None:
        from .. import distributed

        distributed.init_parallel_env()
        world = global_mesh()
    key = (world.uid,) + shape
    mesh = _HYBRID.get(key)
    if mesh is None:
        if device is None and world.backend == "gloo":
            device = "cpu"
        mesh = Mesh((DCN_AXIS, ICI_AXIS), shape, device=device)
        for name in (DCN_AXIS, ICI_AXIS):
            ring = mesh.ring(name)
            if ring is not None:
                ring.axis = name
        mesh.pair = Ring(world.group, world.backend, world.ranks,
                         world.rank, ici=mesh.ring(ICI_AXIS),
                         dcn=mesh.ring(DCN_AXIS), mesh=mesh)
        _HYBRID[key] = mesh
    return mesh


def program_ring(program) -> Optional[Ring]:
    """The ring data-parallel `program` runs over in the live world (None
    without one): the world's, or its hybrid pair's where
    `create_hybrid_mesh` gives a mesh. Decided at the first call in a
    world and kept on the program (``program._mesh``, the reference's
    choice at its first compile), with its axes: ``_dp_axis`` "ici" and
    ``_dcn_axis`` "dcn" on a hybrid mesh."""
    world = global_mesh()
    if world is None:
        return None
    if program._mesh_world != world.uid:
        mesh = create_hybrid_mesh(world.size)
        program._mesh, program._mesh_world = mesh, world.uid
        if mesh is not None:
            program._dp_axis, program._dcn_axis = ICI_AXIS, DCN_AXIS
        else:
            program._dcn_axis = None
    return world if program._mesh is None else program._mesh.pair


class MeshHierarchy(tuple):
    """`mesh_hierarchy`'s result: the tuple ``(dcn_axis, dp_axis,
    dcn_size, dp_size)`` with those names as attributes. `model_axis` and
    `mp_size` are tensor parallelism's (None and 1: not ported, ROADMAP
    Queue 1 #10)."""

    __slots__ = ()
    model_axis = None
    mp_size = 1

    def __new__(cls, dcn_axis, dp_axis, dcn_size, dp_size):
        return tuple.__new__(cls, (dcn_axis, dp_axis, int(dcn_size),
                                   int(dp_size)))

    @property
    def dcn_axis(self):
        return self[0]

    @property
    def dp_axis(self):
        return self[1]

    @property
    def dcn_size(self):
        return self[2]

    @property
    def dp_size(self):
        return self[3]


def mesh_hierarchy(mesh):
    """`MeshHierarchy` of a hybrid (dcn, ici) mesh with more than one
    pod, else None (no mesh, a flat mesh, one pod): the one predicate
    that decides hierarchical against flat collectives."""
    if mesh is None:
        return None
    names = tuple(getattr(mesh, "axis_names", ()) or ())
    if DCN_AXIS not in names or ICI_AXIS not in names:
        return None
    shape = mesh.shape
    if int(shape[DCN_AXIS]) <= 1:
        return None
    return MeshHierarchy(DCN_AXIS, ICI_AXIS, shape[DCN_AXIS], shape[ICI_AXIS])
