"""Elastic per-rank sample assignment (counterpart:
`paddle_tpu/reader/resharding.py`, the port's own copy of its six pure
functions).

A data-parallel cohort at world size N consumes one GLOBAL batch per
step, each rank training on a deterministic slice of it. When a restart
comes back at N' != N, the assignment is recomputed from the same global
sample stream, so no sample is dropped or trained twice across the seam:

- the resume point is a GLOBAL step count, world-size independent
  because every world consumes `global_batch` samples a step;
  `resume_sample_offset` converts it to the global sample cursor;
- `rank_slice` / `shard_batch` derive each rank's slice of every global
  batch for the new (rank, world): contiguous and balanced (the
  remainder spreads over the first ranks), so for divisible batches the
  mean of per-rank means is the global-batch mean;
- `shard_batches` applies it to a global-batch iterator, and
  `skip_steps` drops the already-trained prefix on the host, before any
  copy to the card;
- `survivor_rank` renumbers the ranks that stay after a shrink.

The state half of the same seam (re-laying the sharded moments and
masters out for N') is `parallel/sharded_update.py to_sharded_local`.
"""
from __future__ import annotations

import itertools
from typing import Dict, Iterable, Iterator, Tuple

import numpy as np

__all__ = ["rank_slice", "shard_batch", "shard_batches",
           "resume_sample_offset", "skip_steps", "survivor_rank"]


def survivor_rank(old_rank: int, doomed) -> int:
    """This rank's NEW contiguous rank after the doomed ranks leave a
    live resize (distributed/preemption.ElasticWorld), or -1 for a
    doomed rank. Survivors keep their relative order — the same
    reassignment rule as the launch supervisor's restart shrink, so
    `shard_batch(batch, survivor_rank(r, doomed), world - len(doomed))`
    continues the global sample stream with no sample dropped or
    double-trained across the seam (mid-epoch data continuity: the
    resume cursor is a GLOBAL step count, unchanged by the seam)."""
    old_rank = int(old_rank)
    doomed = {int(r) for r in doomed}
    if old_rank in doomed:
        return -1
    return old_rank - sum(1 for r in doomed if r < old_rank)


def rank_slice(n: int, rank: int, world: int) -> Tuple[int, int]:
    """[lo, hi) of global-batch rows assigned to `rank` of `world`:
    contiguous, balanced, remainder on the first ranks. Every row is
    assigned to exactly one rank for ANY world size — the invariant an
    elastic re-shard relies on."""
    n, rank, world = int(n), int(rank), int(world)
    if world <= 0:
        raise ValueError("world must be positive, got %d" % world)
    if not 0 <= rank < world:
        raise ValueError("rank %d outside [0, %d)" % (rank, world))
    base, rem = divmod(n, world)
    lo = rank * base + min(rank, rem)
    return lo, lo + base + (1 if rank < rem else 0)


def shard_batch(batch, rank: int, world: int):
    """This rank's slice of one GLOBAL batch (dict of arrays, sequence
    of arrays, or one array — sliced along axis 0). Dict/sequence
    entries must share the leading (batch) dimension."""
    if isinstance(batch, dict):
        sizes = {k: len(v) for k, v in batch.items()}
        if len(set(sizes.values())) > 1:
            raise ValueError(
                "global batch entries disagree on the batch dim: %s"
                % sizes)
        n = next(iter(sizes.values())) if sizes else 0
        lo, hi = rank_slice(n, rank, world)
        return {k: v[lo:hi] for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        ns = {len(v) for v in batch}
        if len(ns) > 1:
            raise ValueError(
                "global batch entries disagree on the batch dim: %s"
                % sorted(ns))
        n = ns.pop() if ns else 0
        lo, hi = rank_slice(n, rank, world)
        return type(batch)(v[lo:hi] for v in batch)
    arr = np.asarray(batch)
    lo, hi = rank_slice(arr.shape[0], rank, world)
    return arr[lo:hi]


def shard_batches(batches: Iterable, rank: int,
                  world: int) -> Iterator:
    """Per-rank view of a GLOBAL batch iterator (the elastic-safe
    feeder: rebuild with the new (rank, world) after a shrink and the
    sample->rank map recomputes itself)."""
    for b in batches:
        yield shard_batch(b, rank, world)


def resume_sample_offset(step_no: int, global_batch: int) -> int:
    """Global sample cursor after `step_no` completed GLOBAL steps.
    World-size independent: a cohort at any N consumes global_batch
    samples per step, so a checkpoint taken at N resumes at the same
    cursor when restored at N'."""
    return max(int(step_no), 0) * int(global_batch)


def skip_steps(batches: Iterable, start_step: int) -> Iterator:
    """Drop the first `start_step` GLOBAL batches host-side (before the
    prefetcher — paying an H2D transfer per discarded batch would be
    pure waste; same rule as trainer.train_from_dataset's resume)."""
    return itertools.islice(iter(batches), max(int(start_step), 0),
                            None)
