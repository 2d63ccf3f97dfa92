"""The parallel planner (counterpart: `paddle_tpu/parallel/planner.py`).

The reference's `plan_parallel` runs its three sharding planners in
their one valid order for a program on a mesh: sparse tables, then
tensor parallelism, then ZeRO. The port has the ZeRO planner
(`sharded_update.plan_sharded_update`) over the data-parallel world's
`Ring`; the sparse-table and tensor-parallel plans are None until
ROADMAP Queue 1 #10 ports those engines (and `param_tp_dims` with
them).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

from . import sharded_update as _su

__all__ = ["ParallelPlan", "plan_parallel"]


class ParallelPlan(NamedTuple):
    """The planner's verdict for one program on one world."""

    sparse_plan: Optional[object]   # None until Queue 1 #10
    tp_plan: Optional[object]       # None until Queue 1 #10
    shard_plan: Optional[object]    # sharded_update.ShardedUpdatePlan
    hier: Optional[object]          # None: the port's worlds are flat


def plan_parallel(program, block, ring) -> ParallelPlan:
    """Plan `program`'s block on `ring` (the data-parallel world). The
    fallback trail (`program._sharded_update_fallback`) is reset here,
    once a compile."""
    program._sharded_update_fallback = []
    ndev = ring.size if ring is not None else 1
    shard_plan = _su.plan_sharded_update(program, block, ndev, ring)
    return ParallelPlan(None, None, shard_plan, None)
