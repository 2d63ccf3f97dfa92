"""paddle_tpu_torch.distributed — the process group and the eager
collectives (counterpart: `paddle_tpu/distributed/__init__.py`).

The reference runs one process over a device mesh and brings hosts up
with `jax.distributed.initialize`. The port runs one process per device:
`init_parallel_env` joins the `torch.distributed` world that the
``PADDLE_*`` launch contract describes (`launch.py` sets it; `spawn`
starts such a world on this machine) and installs it as ring 0 of
`parallel/env.py`. NCCL runs on the card and needs one card per rank;
gloo runs on the CPU, and also takes CUDA tensors through host copies,
so several ranks can share one card over it. `ShardedCheckpointManager`
saves and restores a mesh's sharded state (`sharded_checkpoint.py`).
"""
from __future__ import annotations

import atexit
import datetime
import multiprocessing
import os
import time

import torch

from ..core.place import resolve_device
from ..parallel import env as penv

__all__ = ["init_parallel_env", "shutdown_parallel_env", "get_rank",
           "get_world_size", "all_reduce", "broadcast", "all_gather",
           "reduce_scatter", "barrier", "spawn", "ParallelEnv",
           "ShardedCheckpointManager"]


class ParallelEnv:
    """This process's place in the world: `rank`, `world_size`, its
    `device` and endpoints (the dygraph `ParallelEnv` comes with ROADMAP
    Queue 1 #8)."""

    def __init__(self):
        ring = penv.global_mesh()
        self.rank = ring.rank if ring is not None else penv.trainer_id()
        self.world_size = penv.world_size()
        self.current_endpoint = penv.current_endpoint()
        self.trainer_endpoints = penv.trainer_endpoints()
        self.backend = ring.backend if ring is not None else None
        #: the card this rank uses by default (None without a card)
        self.device = resolve_device(None) if torch.cuda.is_available() \
            else None

    @property
    def nranks(self):
        return self.world_size

    @property
    def local_rank(self):
        return self.rank

    @property
    def dev_id(self):
        return self.device.index if self.device is not None else 0


def _single_host(endpoints):
    return len({e.rsplit(":", 1)[0] for e in endpoints}) <= 1


def init_parallel_env(backend=None, timeout_s=None):
    """Join the world of the ``PADDLE_*`` environment (a world of one
    without it) over `backend`: "nccl", "gloo", or None for the
    launcher's ``PADDLE_DISTRI_BACKEND``, else NCCL where a card is and
    gloo where none is. The rendezvous is on trainer 0's endpoint.
    NCCL's communicator is brought up here, so a failure raises now (and
    a CUDA graph may then capture collectives); it never falls back to
    gloo. `timeout_s` bounds every collective (``PADDLE_DIST_TIMEOUT_S``,
    default 600). Returns a `ParallelEnv`."""
    import torch.distributed as dist

    from .launch import free_port_base

    if penv.global_mesh() is not None:
        return ParallelEnv()
    backend = backend or os.environ.get("PADDLE_DISTRI_BACKEND") or (
        "nccl" if torch.cuda.is_available() else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError("backend must be 'nccl' or 'gloo', got %r"
                         % (backend,))
    n, rank = penv.trainer_num(), penv.trainer_id()
    endpoints = penv.trainer_endpoints()
    if n > 1 and len(endpoints) != n:
        raise ValueError(
            "PADDLE_TRAINERS_NUM is %d but PADDLE_TRAINER_ENDPOINTS names "
            "%d endpoint(s)" % (n, len(endpoints)))
    device = None
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs a CUDA device")
        if _single_host(endpoints) and n > torch.cuda.device_count():
            raise RuntimeError(
                "NCCL needs one card per rank: %d ranks on a host with %d "
                "card(s); run them over gloo (--backend gloo)"
                % (n, torch.cuda.device_count()))
        device = resolve_device(None)
        torch.cuda.set_device(device)
        if _single_host(endpoints):
            # NCCL's bootstrap connects the ranks over a socket interface
            # it picks; on one host the loopback one always reaches the
            # peers (the data itself moves over NVLink or PCIe)
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    addr = endpoints[0] if endpoints else \
        "127.0.0.1:%d" % free_port_base(1)
    timeout = datetime.timedelta(seconds=float(
        timeout_s or os.environ.get("PADDLE_DIST_TIMEOUT_S", 600)))
    dist.init_process_group(backend, init_method="tcp://" + addr,
                            world_size=n, rank=rank, timeout=timeout)
    ring = penv.Ring(dist.group.WORLD, backend, range(n), rank)
    if device is not None:
        one = torch.ones(1, device=device)
        dist.all_reduce(one)
        torch.cuda.synchronize(device)
        if int(one.item()) != n:
            raise RuntimeError("NCCL all_reduce over %d ranks gave %s"
                               % (n, one.item()))
    penv.set_global_mesh(ring)
    penv.register_ring(0, ring)
    if device is not None:
        # a script that never leaves the world still exits: NCCL's
        # communicators go after every graph that captured them
        from ..core import graphs

        atexit.register(graphs.release_collective_graphs)
    return ParallelEnv()


def shutdown_parallel_env():
    """Leave the world (after `init_parallel_env`). The CUDA graphs that
    captured its collectives are released first, once the card has run
    every replay queued: NCCL's destroy of a communicator waits for
    them."""
    import torch.distributed as dist

    from ..core import graphs

    if penv.global_mesh() is not None:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        graphs.release_collective_graphs()
        penv.set_global_mesh(None)
        dist.destroy_process_group()


def get_rank():
    ring = penv.global_mesh()
    return ring.rank if ring is not None else penv.trainer_id()


def get_world_size():
    return penv.world_size()


def _eager(tensor, op_type, group=0, **attrs):
    """Run a collective op on `tensor` over ring `group` of the world
    (an identity before `init_parallel_env`)."""
    from .. import ops

    ring = penv.global_mesh()
    if ring is None:
        return tensor
    with penv.collective_scope(ring):
        return ops.run_op(op_type, {"X": [tensor]},
                          dict(attrs, ring_id=group))["Out"][0]


def all_reduce(tensor, op="sum", group=0):
    """In place: `tensor` becomes its `op` ("sum", "max", "min", "prod")
    over the ring. Returns it."""
    out = _eager(tensor, "c_allreduce_" + op, group)
    if out is not tensor:
        tensor.copy_(out)
    return tensor


def broadcast(tensor, src=0, group=0):
    """In place: `tensor` becomes the value of the ring's member `src`."""
    out = _eager(tensor, "c_broadcast", group, root=src)
    if out is not tensor:
        tensor.copy_(out)
    return tensor


def all_gather(tensor_list, tensor, group=0):
    """Appends every member's `tensor`, concatenated along axis 0 in ring
    order, to `tensor_list` (the reference's contract)."""
    tensor_list.append(_eager(tensor, "c_allgather", group))
    return tensor_list


def reduce_scatter(tensor, group=0):
    """The sum over the ring, member r keeping block r of axis 0."""
    return _eager(tensor, "c_reducescatter", group)


def barrier(group=0):
    import torch.distributed as dist

    ring = penv.ring_info(group)
    if ring is not None:
        dist.barrier(group=ring.group)


# -- spawn --------------------------------------------------------------------

def _spawn_entry(env, backend, func, args):
    os.environ.update(env)
    init_parallel_env(backend)
    try:
        func(*args)
    finally:
        shutdown_parallel_env()


class SpawnContext:
    """The processes of one `spawn`; `join` waits for them."""

    def __init__(self, processes):
        self.processes = processes

    def join(self, timeout=None, grace_s=10.0):
        """Wait until every rank exits. The first rank that fails (or the
        `timeout`, in seconds) stops the others and raises; every process
        is gone when this returns or raises."""
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while True:
                bad = [(r, p.exitcode) for r, p in enumerate(self.processes)
                       if p.exitcode not in (None, 0)]
                if bad:
                    raise RuntimeError("spawn: rank %d exited with code %d"
                                       % bad[0])
                if all(p.exitcode == 0 for p in self.processes):
                    return True
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError("spawn: ranks still running after "
                                       "%.0f s" % timeout)
                time.sleep(0.05)
        finally:
            for p in self.processes:
                if p.exitcode is None:
                    p.terminate()
            for p in self.processes:
                p.join(grace_s)
                if p.exitcode is None:
                    p.kill()
                    p.join()


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Start `nprocs` ranks on this machine (-1: one a card, else one),
    each in a fresh interpreter with the ``PADDLE_*`` contract of
    `launch`, which calls `init_parallel_env(backend)` and then
    `func(*args)`; `func` must be importable from its module. Options:
    ``backend`` ("nccl" or "gloo"), ``started_port`` (default: free
    ports), ``timeout`` (seconds for `join`). With `join` this waits (a
    failing rank fails the whole run: see `SpawnContext.join`); returns
    the `SpawnContext`."""
    from .launch import _worker_env, free_port_base

    if nprocs == -1:
        nprocs = torch.cuda.device_count() or 1
    base = options.get("started_port") or free_port_base(nprocs + 1)
    endpoints = ["127.0.0.1:%d" % (base + i) for i in range(nprocs)]
    backend = options.get("backend")
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        env = _worker_env(endpoints, rank, 0, base_env={}, backend=backend)
        p = ctx.Process(target=_spawn_entry, args=(env, backend, func, args),
                        daemon=daemon)
        p.start()
        procs.append(p)
    sc = SpawnContext(procs)
    if join:
        sc.join(options.get("timeout"))
    return sc


from .sharded_checkpoint import ShardedCheckpointManager  # noqa: E402,F401
