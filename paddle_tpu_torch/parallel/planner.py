"""The parallel planner (counterpart: `paddle_tpu/parallel/planner.py`).

The reference's `plan_parallel` runs its three sharding planners in
their one valid order for a program on a mesh: sparse tables, then
tensor parallelism, then ZeRO, each with its axis read from the mesh
hierarchy. The port has the ZeRO planner
(`sharded_update.plan_sharded_update`) over the data-parallel world's
`Ring`: on a hybrid (dcn, ici) world it shards over the ring's ici ring
and sums across pods over its dcn ring. The sparse-table and
tensor-parallel plans are None until ROADMAP Queue 1 #10 ports those
engines (and `param_tp_dims` with them).
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
    hier: Optional[object]          # env.MeshHierarchy (None: flat)


def plan_parallel(program, block, ring) -> ParallelPlan:
    """Plan `program`'s block on `ring` (the data-parallel world). The
    fallback trail (`program._sharded_update_fallback`) is reset here,
    once a compile."""
    program._sharded_update_fallback = []
    hier = getattr(ring, "hierarchy", None)
    if hier is None:
        shard_plan = _su.plan_sharded_update(
            program, block, ring.size if ring is not None else 1, ring)
    else:
        shard_plan = _su.plan_sharded_update(
            program, block, hier.dp_size, ring.ici, dcn_axis=hier.dcn_axis,
            dcn_size=hier.dcn_size, dcn_ring=ring.dcn)
    return ParallelPlan(None, None, shard_plan, hier)
