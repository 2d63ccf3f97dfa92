"""fleet.util — cross-worker utility collectives (counterpart:
`paddle_tpu/fleet/util.py`; reference:
`python/paddle/fleet/base/util_factory.py:31` UtilBase) over the host
gloo group of `distributed/host_collectives.py` when several trainers
run, identities on a single process."""
from __future__ import annotations

from typing import List

import numpy as np


class UtilBase:
    def __init__(self):
        self.role_maker = None
        self.dist_strategy = None

    def _set_strategy(self, dist_strategy):
        self.dist_strategy = dist_strategy

    def _set_role_maker(self, role_maker):
        self.role_maker = role_maker

    # -- collectives over the host tier --------------------------------
    def _group(self):
        from ..distributed.host_collectives import group_from_env

        return group_from_env()

    def barrier(self):
        g = self._group()
        if g is not None:
            g.barrier()

    def all_reduce(self, input, mode="sum"):
        """Elementwise allreduce of a numpy array across workers
        (sum/max/min); identity on a single process."""
        a = np.asarray(input)
        g = self._group()
        if g is None:
            return a
        return g.all_reduce(a, op=mode)

    def all_gather(self, input) -> List[np.ndarray]:
        a = np.asarray(input)
        g = self._group()
        if g is None:
            return [a]
        return g.all_gather(a)

    def broadcast(self, input, root=0):
        a = np.asarray(input)
        g = self._group()
        if g is None:
            return a
        return g.broadcast(a, root=root)

    # -- sharding helpers ----------------------------------------------
    def get_file_shard(self, files) -> List[str]:
        """This worker's contiguous slice of `files` (reference
        contract: remainder spread over the first workers)."""
        if not isinstance(files, list):
            raise TypeError("files should be a list of file names")
        rm = self.role_maker
        n = rm.worker_num() if rm is not None else 1
        idx = rm.worker_index() if rm is not None else 0
        per, rem = divmod(len(files), n)
        start = per * idx + min(idx, rem)
        return files[start:start + per + (1 if idx < rem else 0)]

    def print_on_rank(self, message, rank_id=0):
        rm = self.role_maker
        myrank = rm.worker_index() if rm is not None else 0
        if myrank == int(rank_id):
            print(message, flush=True)


_util = UtilBase()


def __getattr__(name):  # pragma: no cover - module-attr convenience
    return getattr(_util, name)
