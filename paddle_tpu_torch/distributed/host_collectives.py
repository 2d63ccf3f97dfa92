"""Host collectives of numpy arrays (counterpart:
`paddle_tpu/distributed/host_collectives.py`, what `fleet/util.py` and
`fleet/metrics.py` use).

Reference parity: `paddle/fluid/framework/fleet/gloo_wrapper.h:106`
(GlooWrapper's Barrier and AllReduce). The reference runs its own store
protocol over TCP; the port runs a gloo process group of its own over a
`torch.distributed` TCPStore on trainer 0's endpoint port + 1, apart from
the device world of `init_parallel_env`. Liveness, heartbeats and the
flight trace are not ported (ROADMAP Queue 1 #10).
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}

#: the most dimensions an `all_gather` array may have
_MAX_DIMS = 8


class HostCollectiveGroup:
    """A gloo group of `world_size` ranks; rank 0 hosts its store at
    `store_endpoint` ("host:port")."""

    def __init__(self, rank, world_size, store_endpoint, timeout_s=None):
        self.rank = int(rank)
        self.world = int(world_size)
        host, port = store_endpoint.rsplit(":", 1)
        timeout = datetime.timedelta(seconds=float(
            timeout_s if timeout_s is not None
            else os.environ.get("PADDLE_HC_TIMEOUT_S", 600)))
        self._store = dist.TCPStore(host, int(port), self.world,
                                    self.rank == 0, timeout=timeout)
        self._pg = dist.ProcessGroupGloo(self._store, self.rank, self.world,
                                         timeout)

    def barrier(self):
        self._pg.barrier().wait()

    def all_reduce(self, array, op="sum"):
        """`op` ("sum", "max", "min", "mean"/"avg") of `array` over the
        ranks, elementwise."""
        t = torch.from_numpy(np.array(array, copy=True))
        opts = dist.AllreduceOptions()
        opts.reduceOp = _OPS["sum" if op in ("mean", "avg") else op]
        self._pg.allreduce([t], opts).wait()
        out = t.numpy()
        return out / self.world if op in ("mean", "avg") else out

    def all_gather(self, array) -> List[np.ndarray]:
        """Every rank's `array` (shapes may differ, the dtype may not), in
        rank order."""
        a = np.ascontiguousarray(array)
        if a.ndim > _MAX_DIMS:
            raise ValueError("all_gather takes at most %d dims" % _MAX_DIMS)
        head = torch.tensor([a.ndim] + list(a.shape)
                            + [0] * (_MAX_DIMS - a.ndim), dtype=torch.int64)
        heads = self._gather(head)
        shapes = [tuple(int(d) for d in h[1:1 + int(h[0])]) for h in heads]
        size = max(int(np.prod(s)) for s in shapes)
        flat = torch.zeros(size, dtype=torch.from_numpy(a[:0]).dtype)
        flat[:a.size] = torch.from_numpy(a.reshape(-1))
        return [p[:int(np.prod(s))].numpy().reshape(s)
                for p, s in zip(self._gather(flat), shapes)]

    def _gather(self, t):
        outs = [[torch.empty_like(t) for _ in range(self.world)]]
        self._pg.allgather(outs, [t]).wait()
        return outs[0]

    def broadcast(self, array, root=0):
        t = torch.from_numpy(np.array(array, copy=True))
        opts = dist.BroadcastOptions()
        opts.rootRank = int(root)
        self._pg.broadcast([t], opts).wait()
        return t.numpy()

    def shutdown(self):
        self._pg = None
        self._store = None


_env_group = {}


def group_from_env() -> Optional[HostCollectiveGroup]:
    """The group of the ``PADDLE_*`` launch env (None for one trainer),
    made once a process: its store binds on trainer 0's endpoint port
    + 1."""
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    n = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    if n <= 1 or not eps:
        return None
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    key = (eps, rank, n)
    if key not in _env_group:
        host, port = eps.split(",")[0].rsplit(":", 1)
        _env_group[key] = HostCollectiveGroup(
            rank, n, "%s:%d" % (host, int(port) + 1))
    return _env_group[key]
