"""Cross-replica sharded weight update, ZeRO-1 (counterpart:
`paddle_tpu/parallel/sharded_update.py`).

"Automatic Cross-Replica Sharding of Weight Update in Data-Parallel
Training" (Xu et al., 2020): a data-parallel step's update is the same
on every replica, so each rank can do 1/N of it:

    reduce-scatter the gradients  ->  update this rank's 1/N shard of
    the params and moments        ->  all-gather the updated params.

An all-reduce is a reduce-scatter and an all-gather, so the bytes on the
wire stay the same while the optimizer's work and the moments' and AMP
masters' memory drop to 1/N a rank.

The reference runs the update inside `shard_map` over a mesh axis; the
port runs one process a rank, and each collective here runs over the
world's `parallel.env.Ring` (NCCL on the card, gloo through host copies,
where a reduce-scatter is an all-reduce and a slice). The planning is
the reference's, rule for rule:

- `plan_sharded_update` scans the post-backward section. If every
  optimizer op is a supported type and every op that touches an
  optimizer-bound gradient is shard-aware (the elementwise ops, the
  global-norm plumbing, fleet's `c_allreduce_sum`), it returns a plan;
  anything else returns None with the reason recorded on
  ``program._sharded_update_fallback``, and the program keeps the
  replicated update.
- Values are sharded as flat buffers: each tensor is flattened,
  zero-padded to a multiple of N, and rank r owns the contiguous slice r.
  `ShardVal` carries that slice and the logical shape.
- Optimizer state (moments, velocities) and AMP fp32 masters stay
  sharded across steps: the executor keeps this rank's flat slice of
  each in the scope (`to_sharded_local`), and `Executor.read_logical`
  gathers one back at its logical shape.
- Elementwise optimizers run their registered compute on the flat
  shards unchanged. LAMB and LARS need norms over the whole parameter:
  an all-reduce of the shards' partial sums (`_sharded_norm_opt`; their
  ops come with ROADMAP Queue 1 #5).
- Gradients travel in buckets (`FLAGS_tpu_comm_bucket_mb`) in backward
  order, one reduce-scatter a bucket over a replica-major buffer, so each
  rank's share is its own per-variable slices; the deferred parameter
  all-gathers run at the end of the step in forward order, one a bucket.
  Each bucket's reduce-scatter can be launched without waiting
  (`bucket_reduce_scatter_start`): the lowering launches it from inside
  the backward once the bucket's last gradient exists.
- On a hybrid (dcn, ici) world the shards are laid out within the pod:
  the plan's `ring` is this rank's ici ring and `ndev` the pod's size,
  so a rank holds 1/ici of the state, the same in every pod. Each
  reduce-scatter over ici is followed by the sum of its shard across
  pods over `dcn_ring` (`_cross_pod_sum`, 1/ici of the bytes crossing
  pods), a mean divides by the whole world (`world`), and the
  all-gathers stay within the pod.

Left for later items, each raising with its name: tensor-parallel vars
with mp > 1 and the sparse-table plan (#10), and
`eager_accumulator_sharding`, which is dygraph (#8). The reference turns
bucketing off for AMP at a world that is not a power of two on the JAX
CPU backend, where XLA's fusion drifts one bf16 step off the
per-variable lowering; the port has no such fusion, so it keeps its
buckets.
"""
from __future__ import annotations

import logging
from typing import Dict, FrozenSet, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.types import to_torch_dtype
from ..ops import collective_ops as co

_log = logging.getLogger(__name__)

# Optimizer ops whose update is elementwise over the flattened group:
# their compute on a contiguous flat shard of every operand is the shard
# of the full update. Per-parameter scalars (beta pows, LearningRate)
# stay replicated.
_ELEMENTWISE_OPT = frozenset({
    "sgd", "momentum", "adam", "adamw", "adamax", "adagrad",
    "decayed_adagrad", "adadelta", "rmsprop", "ftrl",
    "fused_sgd", "fused_momentum", "fused_adam",
})
# Norm-coupled optimizers: the update needs ||param|| / ||update|| over
# the whole tensor, an all-reduce of the shards' partial sums.
_NORM_OPT = frozenset({"lamb", "lars_momentum"})
SUPPORTED_OPT = _ELEMENTWISE_OPT | _NORM_OPT

# Input slots that carry param-shaped tensors and so live in shard space
# inside the update (LearningRate, beta pows and counters pass whole).
# Slot identity, not size, decides: a one-element bias is still a param
# whose gradient arrives as a shard on every rank.
_TENSOR_IN_SLOTS = frozenset({
    "Param", "Grad", "Velocity", "Moment", "Moment1", "Moment2",
    "InfNorm", "AvgSquaredGrad", "AvgSquaredUpdate", "MeanSquare",
    "MeanGrad", "SquaredAccumulator", "LinearAccumulator",
})
_TENSOR_OUT_SLOTS = frozenset({
    "ParamOut", "VelocityOut", "MomentOut", "Moment1Out", "Moment2Out",
    "InfNormOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut",
    "MeanSquareOut", "MeanGradOut", "SquaredAccumOut", "LinearAccumOut",
})

# param-shaped state slots per optimizer type: these become sharded
# scope state (flat 1/N buffers a rank across steps)
_OPT_STATE_SLOTS: Dict[str, Tuple[str, ...]] = {
    "sgd": (), "fused_sgd": (),
    "momentum": ("Velocity",), "fused_momentum": ("Velocity",),
    "lars_momentum": ("Velocity",),
    "adam": ("Moment1", "Moment2"), "adamw": ("Moment1", "Moment2"),
    "lamb": ("Moment1", "Moment2"), "fused_adam": ("Moment1", "Moment2"),
    "adamax": ("Moment", "InfNorm"),
    "adagrad": ("Moment",), "decayed_adagrad": ("Moment",),
    "adadelta": ("AvgSquaredGrad", "AvgSquaredUpdate"),
    "rmsprop": ("MeanSquare", "Moment", "MeanGrad"),
    "ftrl": ("SquaredAccumulator", "LinearAccumulator"),
}

# shard-aware non-optimizer ops: elementwise ops run on the flat shards;
# full reductions all-reduce their local partial sums
_EW_UNARY = frozenset({"scale", "clip", "cast", "sign", "abs", "square",
                       "sqrt"})
_EW_BINARY = frozenset({"elementwise_add", "elementwise_sub",
                        "elementwise_mul", "elementwise_div",
                        "elementwise_max", "elementwise_min"})
_NORM_REDUCE = frozenset({"squared_l2_norm"})


def _itemsize(dtype: str) -> int:
    return to_torch_dtype(dtype).itemsize


def _padded(numel: int, ndev: int) -> int:
    return -(-numel // ndev) * ndev


class ShardVal:
    """A value sharded as a flat buffer: `vec` is this rank's contiguous
    1/N slice of the zero-padded flattened value; `shape` is the logical
    shape."""

    __slots__ = ("vec", "shape")

    def __init__(self, vec, shape):
        self.vec = vec
        self.shape = tuple(shape)

    def __repr__(self):
        return "ShardVal(shape=%s, shard=%s, dtype=%s)" % (
            self.shape, tuple(self.vec.shape), self.vec.dtype)


class ShardInfo:
    """The layout of one sharded state var: its logical `shape`, `dtype`
    (a dtype name), `numel` and `padded` (numel rounded up to a multiple
    of N; a rank holds padded / N elements). Tensor-parallel vars (mp >
    1) are not ported (ROADMAP Queue 1 #10)."""

    __slots__ = ("name", "shape", "dtype", "numel", "padded")

    def __init__(self, name, shape, dtype, ndev, tp_dim=None, mp=1):
        if int(mp or 1) > 1:
            raise NotImplementedError(
                "sharded update of tensor-parallel var %r (mp %d) is not "
                "ported (ROADMAP Queue 1 #10)" % (name, mp))
        self.name = name
        self.shape = tuple(int(d) for d in shape)
        self.dtype = str(dtype)
        self.numel = int(np.prod(self.shape)) if self.shape else 1
        self.padded = _padded(self.numel, ndev)

    @property
    def itemsize(self) -> int:
        return _itemsize(self.dtype)

    def unshard(self, value):
        """A whole flat buffer (every rank's slice, in rank order) ->
        the logical-shape value (numpy or tensor, as given). The padding
        is read from the value, so a buffer padded for another world
        unshards too."""
        if tuple(value.shape) == self.shape:
            return value
        return value.reshape(-1)[:self.numel].reshape(self.shape)


class BucketEntry:
    """One gradient's slot inside a bucket."""

    __slots__ = ("grad", "param", "param_out", "shape", "dtype", "numel",
                 "padded", "topo")

    def __init__(self, grad, param, param_out, shape, dtype, ndev, topo):
        self.grad = grad
        self.param = param
        self.param_out = param_out
        self.shape = tuple(int(d) for d in shape)
        self.dtype = str(dtype)
        self.numel = int(np.prod(self.shape)) if self.shape else 1
        self.padded = _padded(self.numel, ndev)
        self.topo = topo  # last forward use index (production order key)

    @property
    def nbytes(self):
        return self.padded * _itemsize(self.dtype)


class GradBucket:
    """A size-bounded group of optimizer-bound gradients reduce-scattered
    by one collective. The bucket buffer is replica-major: the
    concatenation over ranks d of [entry_0 slice d, entry_1 slice d,
    ...], so each rank receives exactly the concatenation of its own
    per-entry slices, the per-variable layout."""

    __slots__ = ("index", "entries")

    def __init__(self, index, entries):
        self.index = index
        self.entries = tuple(entries)

    @property
    def dtype(self):
        return self.entries[0].dtype

    @property
    def nbytes(self):  # the whole (pre-scatter) collective input
        return sum(e.nbytes for e in self.entries)

    def __repr__(self):
        return "GradBucket(%d: %d grads, %.2f MB %s)" % (
            self.index, len(self.entries), self.nbytes / 1e6, self.dtype)


def bucket_cap_bytes() -> int:
    """FLAGS_tpu_comm_bucket_mb as a byte cap; 0 turns bucketing off (one
    collective a variable)."""
    from ..utils.flags import get_flag

    mb = float(get_flag("FLAGS_tpu_comm_bucket_mb", 0.0) or 0.0)
    return int(mb * (1 << 20)) if mb > 0 else 0


def plan_buckets(opt_ops, block, ndev, grad_topo, cap_bytes,
                 out_alias=None, tp_local=None):
    """Partition the optimizer-bound gradients into buckets in backward
    production order: a gradient whose param is used later in the
    forward materializes earlier, so entries sort by descending last
    forward use (ties: reversed appearance). Greedy fill up to
    `cap_bytes` (an oversize param gets a bucket of its own); gradients
    of different dtypes never share a bucket; each entry keeps its own
    zero padding, so a rank's layout is the per-variable one.

    `out_alias` (AMP masters): {master name: live param name}. The
    optimizer op's Param/ParamOut name the fp32 master, but the gradient
    has the live param's 16-bit dtype and the gathered output is the
    live param, so shape, dtype and param_out resolve through it."""
    if tp_local:
        raise NotImplementedError(
            "gradient buckets of tensor-parallel vars are not ported "
            "(ROADMAP Queue 1 #10)")
    alias = out_alias or {}
    entries = []
    seen = set()
    for op in opt_ops:
        grads = op.input_names.get("Grad", [])
        params = op.input_names.get("Param", [])
        pouts = op.output_names.get("ParamOut", [])
        for i, g in enumerate(grads):
            if g in seen:
                continue
            seen.add(g)
            p = params[i] if i < len(params) else g
            po = pouts[i] if i < len(pouts) else p
            live = alias.get(p, p)
            v = block._find_var_recursive(live)
            shape = tuple(getattr(v, "shape", ()) or ())
            dtype = str(getattr(v, "dtype", "float32"))
            entries.append(BucketEntry(
                g, p, alias.get(po, po), shape, dtype, ndev,
                int(grad_topo.get(live, -1))))
    order = sorted(range(len(entries)),
                   key=lambda i: (-entries[i].topo, -i))
    buckets = []
    cur, cur_bytes = [], 0
    for i in order:
        e = entries[i]
        if cur and (e.dtype != cur[0].dtype
                    or cur_bytes + e.nbytes > cap_bytes):
            buckets.append(GradBucket(len(buckets), cur))
            cur, cur_bytes = [], 0
        cur.append(e)
        cur_bytes += e.nbytes
    if cur:
        buckets.append(GradBucket(len(buckets), cur))
    return tuple(buckets)


class ShardedUpdatePlan:
    """The plan of one program on one world. `ring` (a
    `parallel.env.Ring`, None when only planning) takes the place of the
    reference's shard axis; `ndev` is its size: the world's, or on a
    hybrid world the pod's (ici). `dcn_axis`, `dcn_size` and `dcn_ring`
    (this rank's ring across pods) name the hierarchy; None, 1 and None
    on a flat world."""

    __slots__ = ("ring", "ndev", "grad_names", "rs_targets",
                 "sharded_state", "explicit_sync", "opt_op_ids",
                 "buckets", "bucket_of", "defer_gather", "bucket_cap",
                 "master_of", "dcn_axis", "dcn_size", "dcn_ring")

    def __init__(self, ring, ndev, grad_names, rs_targets, sharded_state,
                 explicit_sync, opt_op_ids, buckets=(), defer_gather=(),
                 bucket_cap=0, master_of=None, dcn_axis=None, dcn_size=1,
                 dcn_ring=None):
        self.ring = ring
        self.ndev = int(ndev)
        self.dcn_axis = dcn_axis
        self.dcn_size = int(dcn_size or 1)
        self.dcn_ring = dcn_ring
        # grads reduce-scattered right after the backward (implicit DP)
        self.grad_names: FrozenSet[str] = frozenset(grad_names)
        # grads whose explicit c_allreduce_sum lowers to a reduce-scatter
        self.rs_targets: FrozenSet[str] = frozenset(rs_targets)
        self.sharded_state: Dict[str, ShardInfo] = dict(sharded_state)
        self.explicit_sync = explicit_sync
        self.opt_op_ids = frozenset(opt_op_ids)
        # bucketed collectives; empty = one collective a variable
        self.buckets: Tuple[GradBucket, ...] = tuple(buckets)
        self.bucket_of: Dict[str, GradBucket] = {
            e.grad: b for b in self.buckets for e in b.entries}
        # ParamOut names whose all-gather waits for the end of the post
        # section, where it runs one a bucket
        self.defer_gather: FrozenSet[str] = frozenset(defer_gather)
        # the byte cap the buckets were planned under
        self.bucket_cap = int(bucket_cap)
        # AMP fp32 masters sharded by this plan: {live param: master}
        self.master_of: Dict[str, str] = dict(master_of or {})

    @property
    def world(self) -> int:
        """The replica count a mean divides by: the shard count times the
        pods."""
        return self.ndev * self.dcn_size

    @property
    def rank(self) -> int:
        return self.ring.rank if self.ring is not None else 0


def enabled() -> bool:
    from ..utils.flags import get_flag

    return bool(get_flag("FLAGS_tpu_sharded_weight_update", True))


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

def broadcast_mismatch(op, block):
    """True when an elementwise binary op broadcasts mismatched
    non-scalar operands, which has no flat-shard analogue."""
    numels = []
    for slot in ("X", "Y"):
        for n in op.input_names.get(slot, []):
            v = block._find_var_recursive(n)
            shp = tuple(getattr(v, "shape", ()) or ())
            if shp:
                numels.append(int(np.prod(shp)))
    return (len(numels) == 2 and numels[0] != numels[1]
            and 1 not in numels)


def _record_fallback(program, reason, var=None, op_type=None,
                     kind="declined"):
    """The program's fallback trail: why the planner declined (kind
    'declined': the whole program keeps the replicated update) or kept
    one var replicated (kind 'state_degraded')."""
    lst = getattr(program, "_sharded_update_fallback", None)
    if lst is None:
        lst = []
        program._sharded_update_fallback = lst
    lst.append({"kind": kind, "reason": reason, "var": var,
                "op": op_type})
    _log.debug("sharded update %s: %s (var=%s op=%s)", kind, reason,
               var, op_type)


def plan_sharded_update(program, block, ndev, ring=None, dcn_axis=None,
                        dcn_size=1, tp_plan=None, sparse_plan=None,
                        dcn_ring=None) -> Optional[ShardedUpdatePlan]:
    """The feasibility scan over the post-backward section (the
    reference's, rule for rule). Returns a plan, or None when the program
    keeps the replicated update (flag off, one rank a shard, an
    unsupported op on an optimizer-bound gradient or a would-be-sharded
    state var); each decline or degrade is recorded (`_record_fallback`).
    `ndev` and `ring` are the shard axis (the pod's on a hybrid world),
    `dcn_axis`, `dcn_size` and `dcn_ring` the axis across pods.

    AMP masters (`mixed_precision.decorate` at O2): the optimizer ops'
    Param/ParamOut name fp32 ``@MASTER`` vars; those become sharded
    state, their one reader outside the optimizer op, the trailing
    ``__amp_param_cast__`` cast, runs in shard space, and the 16-bit
    live param shard it gives is what the (deferred) all-gather
    carries."""
    if tp_plan is not None and int(getattr(tp_plan, "mp", 1)) > 1:
        raise NotImplementedError(
            "the sharded update with tensor parallelism is not ported "
            "(ROADMAP Queue 1 #10)")
    if sparse_plan is not None:
        raise NotImplementedError(
            "the sparse-table plan is not ported (ROADMAP Queue 1 #10)")
    from ..fluid import lowering

    program._sharded_update_fallback = [
        e for e in (getattr(program, "_sharded_update_fallback", None)
                    or []) if str(e.get("kind", "")).startswith("tp_")]
    if not enabled() or ndev <= 1:
        return None
    ops = list(block.ops)
    bwd_idx = next((i for i, op in enumerate(ops)
                    if op.type == "backward"), None)
    if bwd_idx is None:
        return None
    bop = ops[bwd_idx]
    post = ops[bwd_idx + 1:]

    opt_ops = []
    for op in post:
        if "ParamOut" not in op.output_names:
            continue
        if op.type not in SUPPORTED_OPT:
            _record_fallback(program, "optimizer op is not shard-aware",
                             op_type=op.type)
            return None
        opt_ops.append(op)
    if not opt_ops:
        return None

    opt_grads = set()
    for op in opt_ops:
        gs = op.input_names.get("Grad", [])
        if not gs:
            _record_fallback(program,
                             "optimizer op without a Grad slot",
                             op_type=op.type)
            return None
        opt_grads.update(gs)

    # AMP fp32 masters: {master: live param}; the trailing
    # __amp_param_cast__ ops are each master's one reader outside its
    # optimizer op
    amp_masters = dict(getattr(program, "_amp_master_of", None) or {})
    param_of = {m: p for p, m in amp_masters.items()}
    cast_of: Dict[str, tuple] = {}  # master -> (cast op, live param out)
    for op in post:
        if op.type == "cast" and op.attrs.get("__amp_param_cast__"):
            xs = op.input_names.get("X", [])
            outs = op.output_names.get("Out", [])
            if len(xs) == 1 and xs[0] in param_of and outs:
                cast_of[xs[0]] = (op, outs[0])

    # explicit sync (fleet's c_allreduce_sum after the backward): the
    # gradients are not averaged after the backward, and each
    # c_allreduce_sum becomes the reduce-scatter
    explicit = any(
        (op.type.startswith("c_allreduce") or op.type == "allreduce")
        and any(n.endswith("@GRAD") for n in op.input_arg_names)
        for op in post)
    rs_targets = set()
    if explicit:
        for op in post:
            if op.type == "c_allreduce_sum" and \
                    set(op.input_names.get("X", [])) & opt_grads:
                xs = op.input_names["X"]
                outs = op.output_names.get("Out", [])
                if len(xs) != 1 or outs != xs:
                    _record_fallback(
                        program, "c_allreduce_sum is not a single "
                        "in-place grad sync", op_type=op.type,
                        var=(xs or [None])[0])
                    return None
                rs_targets.add(xs[0])
            elif (op.type.startswith("c_allreduce")
                  or op.type == "allreduce") and \
                    set(op.input_arg_names) & opt_grads:
                _record_fallback(
                    program, "non-sum reduction on an optimizer "
                    "gradient", op_type=op.type)
                return None
        if rs_targets != opt_grads:
            _record_fallback(
                program, "optimizer grad(s) never allreduced by the "
                "explicit sync",
                var=",".join(sorted(opt_grads - rs_targets)[:3]))
            return None

    # candidate sharded state: param-shaped optimizer accumulators (and
    # AMP fp32 masters), owned by exactly one optimizer op
    owner: Dict[str, object] = {}
    sharded_state: Dict[str, ShardInfo] = {}

    def consider(n, op):
        v = block._find_var_recursive(n)
        shape = tuple(getattr(v, "shape", ()) or ())
        if not shape or any(int(d) <= 0 for d in shape) or \
                int(np.prod(shape)) <= 1:
            return  # scalar-ish state stays replicated
        if n in owner and owner[n] is not op:
            owner[n] = None
            sharded_state.pop(n, None)
            _record_fallback(program, "state shared across optimizer "
                             "ops", var=n, op_type=op.type,
                             kind="state_degraded")
            return
        owner[n] = op
        dtype = str(getattr(v, "dtype", "float32"))
        sharded_state[n] = ShardInfo(n, shape, dtype, ndev)

    for op in opt_ops:
        for slot in _OPT_STATE_SLOTS.get(op.type, ()):
            for n in op.input_names.get(slot, []):
                consider(n, op)
        for n in op.input_names.get("Param", []):
            if n in param_of and n in cast_of:
                consider(n, op)  # fp32 master: sharded across steps
    # a candidate read or written outside its owning optimizer op (or,
    # for a master, its own cast) stays replicated
    if sharded_state:
        allowed_extra = {m: id(cop) for m, (cop, _) in cast_of.items()}
        for op in ops:
            reads, writes = lowering._op_reads_writes(op)
            for n in set(reads) | set(writes):
                if n in sharded_state and owner.get(n) is not op \
                        and allowed_extra.get(n) != id(op):
                    del sharded_state[n]
                    owner[n] = None
                    _record_fallback(
                        program, "state read/written outside its "
                        "owning optimizer op", var=n, op_type=op.type,
                        kind="state_degraded")
    # taint walk: every op consuming a sharded gradient must be
    # shard-aware
    tainted = set(opt_grads) if not explicit else set()
    opt_ids = {id(op) for op in opt_ops}
    for op in post:
        reads, writes = lowering._op_reads_writes(op)
        reads, writes = set(reads), set(writes)
        if id(op) in opt_ids:
            if not set(op.input_names.get("Grad", [])) <= tainted:
                return None
            tainted -= writes  # ParamOut/state outs leave shard space
            continue
        if op.type == "c_allreduce_sum" and \
                set(op.input_names.get("X", [])) & rs_targets:
            tainted |= set(op.output_names.get("Out", []))
            continue
        tin = reads & tainted
        if not tin:
            tainted -= writes  # a full overwrite of a tainted name
            continue
        if op.type in _EW_BINARY and broadcast_mismatch(op, block):
            _record_fallback(
                program, "broadcast over sharded grads has no "
                "flat-shard analogue", op_type=op.type,
                var=sorted(tin)[0])
            return None
        if op.type in _EW_UNARY or op.type in _EW_BINARY \
                or op.type == "sum":
            tainted |= writes  # elementwise: outputs stay sharded
        elif op.type in _NORM_REDUCE or op.type == "clip_by_norm":
            tainted -= writes
            if op.type == "clip_by_norm":
                tainted |= writes
        else:
            _record_fallback(
                program, "op reads sharded grads without a shard-aware "
                "rule", op_type=op.type, var=sorted(tin)[0])
            return None
    out_alias = {m: live for m, (_, live) in cast_of.items()}
    cap = bucket_cap_bytes()
    buckets = ()
    if cap > 0:
        buckets = plan_buckets(opt_ops, block, ndev,
                               bop.attrs.get("grad_topo", {}) or {}, cap,
                               out_alias=out_alias)
    # params whose all-gather waits for the end of the post section: no
    # op after the optimizer op (for an AMP master, after the live
    # param's cast) reads them
    defer = set()
    if buckets:
        last_read = {}
        pos_of = {}
        for i, op in enumerate(post):
            pos_of[id(op)] = i
            for n in lowering._op_reads_writes(op)[0]:
                last_read[n] = i
        for op in opt_ops:
            for po in op.output_names.get("ParamOut", []):
                target, produced_at = po, pos_of[id(op)]
                if po in cast_of:
                    cop, live = cast_of[po]
                    target, produced_at = live, pos_of[id(cop)]
                if last_read.get(target, -1) <= produced_at:
                    defer.add(target)
    master_of = {live: m for m, (_, live) in cast_of.items()
                 if m in sharded_state}
    return ShardedUpdatePlan(
        ring, ndev,
        grad_names=(set() if explicit else opt_grads),
        rs_targets=rs_targets, sharded_state=sharded_state,
        explicit_sync=explicit, opt_op_ids=opt_ids,
        buckets=buckets, defer_gather=defer, bucket_cap=cap,
        master_of=master_of, dcn_axis=dcn_axis, dcn_size=dcn_size,
        dcn_ring=dcn_ring)


# ---------------------------------------------------------------------------
# shard-space collectives over the ring
# ---------------------------------------------------------------------------

def _flat_pad(x, ndev):
    v = x.reshape(-1)
    padded = _padded(v.shape[0], ndev)
    if padded != v.shape[0]:
        v = torch.cat([v, v.new_zeros(padded - v.shape[0])])
    return v


def shard_slice(x_full, plan):
    """This rank's contiguous slice of the padded flat buffer of a
    replicated tensor (a param entering the optimizer)."""
    vec = _flat_pad(x_full, plan.ndev)
    size = vec.shape[0] // plan.ndev
    return vec[plan.rank * size:(plan.rank + 1) * size]


def _reduce_scatter_start(vec, plan):
    """Launch the ring's sum of the flat `vec` scattered over the shard
    ring (NCCL's reduce-scatter; over gloo an all-reduce and a slice),
    followed on a hybrid world by the sum of this rank's shard across
    pods (`_cross_pod_sum`). Returns a function that waits and gives
    this rank's 1/N slice."""
    ring = plan.ring
    size = vec.shape[0] // plan.ndev
    lo = plan.rank * size

    def fn(t):
        if ring.backend == "nccl":
            out = torch.empty(size, dtype=t.dtype, device=t.device)
            return dist.reduce_scatter_tensor(out, t, group=ring.group,
                                              async_op=True), out
        return dist.all_reduce(t, group=ring.group, async_op=True), t

    # gloo's stand-in all-reduces `t` in place
    pending = co.start("zero.reduce_scatter", ring, vec, fn,
                       in_place=ring.backend != "nccl",
                       select=None if ring.backend == "nccl"
                       else (lambda t: t[lo:lo + size]))
    if plan.dcn_ring is None:
        return pending.wait
    return _cross_pod_sum(pending.wait(), plan).wait


def _cross_pod_sum(vec, plan):
    """The second step of a hierarchical reduce-scatter, launched: the
    sum of this rank's shard over the pods (the one collective that
    crosses them, 1/ici of the gradient's bytes)."""
    return co.all_reduce_start(vec, plan.dcn_ring, "zero.all_reduce")


def _all_gather(vec, plan):
    """Every rank's flat `vec`, concatenated in rank order."""
    ring = plan.ring

    def fn(t):
        if ring.backend == "nccl":
            out = torch.empty(plan.ndev * t.shape[0], dtype=t.dtype,
                              device=t.device)
            dist.all_gather_into_tensor(out, t, group=ring.group)
            return out
        outs = [torch.empty_like(t) for _ in range(plan.ndev)]
        dist.all_gather(outs, t, group=ring.group)
        return torch.cat(outs)

    return co._collective("zero.all_gather", ring, vec, fn,
                          in_place=False)


def reduce_scatter_start(g, plan, mean):
    """Launch the reduce-scatter of one gradient; returns a function that
    waits and gives its `ShardVal` (the sum, or with `mean` the sum over
    `plan.world`)."""
    wait = _reduce_scatter_start(_flat_pad(g, plan.ndev), plan)
    shape = tuple(g.shape)

    def done():
        vec = wait()
        return ShardVal(vec / plan.world if mean else vec, shape)

    return done


def reduce_scatter_sum(g, plan):
    """The world's sum of this rank's 1/N slice of the padded flat
    gradient: half the bytes of the all-reduce it replaces (the
    all-gather half moves to the params)."""
    return reduce_scatter_start(g, plan, False)()


def _bucket_replica_major(vecs, ndev):
    """Concatenate per-entry padded flat vecs replica-major: each as
    (N, padded_i / N), joined along axis 1, so a rank's slice of the
    result is the concatenation of its own per-entry slices."""
    return torch.cat([v.reshape(ndev, -1) for v in vecs], dim=1)


def bucket_reduce_scatter_start(bucket, grads, plan, mean):
    """Launch one reduce-scatter for a whole bucket (`grads`: grad name ->
    the full gradient; the bucket's entries it lacks are left out).
    Entries whose dtype differs from the run before them start a new
    collective. Returns a function that waits and gives {grad name:
    ShardVal}; each element is summed (and divided) as in the
    per-variable scatter."""
    runs = []
    for e in bucket.entries:
        if e.grad not in grads:
            continue
        if runs and grads[e.grad].dtype == grads[runs[-1][0].grad].dtype:
            runs[-1].append(e)
        else:
            runs.append([e])
    launched = []
    for run in runs:
        buf = _bucket_replica_major(
            [_flat_pad(grads[e.grad], plan.ndev) for e in run],
            plan.ndev).reshape(-1)
        launched.append((run, [tuple(grads[e.grad].shape) for e in run],
                         _reduce_scatter_start(buf, plan)))

    def done():
        out = {}
        for run, shapes, wait in launched:
            sc = wait()
            if mean:
                sc = sc / plan.world
            off = 0
            for e, shape in zip(run, shapes):
                size = e.padded // plan.ndev
                out[e.grad] = ShardVal(sc[off:off + size], shape)
                off += size
        return out

    return done


def bucket_reduce_scatter(bucket, grads, plan, mean):
    """`bucket_reduce_scatter_start`, waited for."""
    return bucket_reduce_scatter_start(bucket, grads, plan, mean)()


def gather_full(sv: ShardVal, plan):
    """All-gather a ShardVal back to its logical form (an updated
    param; any sharded value that is fetched)."""
    full = _all_gather(sv.vec, plan)
    numel = int(np.prod(sv.shape)) if sv.shape else 1
    return full[:numel].reshape(sv.shape)


def bucketed_gather_deferred(env, plan):
    """The deferred params' all-gathers at the end of the post section,
    in forward order (buckets and their entries reversed), so the next
    step's leading layers come first: one collective a bucket (a dtype
    run within it), whose result each entry takes its columns of."""
    for bucket in reversed(plan.buckets):
        run = []

        def flush():
            if not run:
                return
            full = _all_gather(torch.cat([env[e.param_out].vec
                                          for e in run]), plan)
            full = full.reshape(plan.ndev, -1)
            off = 0
            for e in run:
                size = e.padded // plan.ndev
                env[e.param_out] = full[:, off:off + size].reshape(-1)[
                    :e.numel].reshape(env[e.param_out].shape)
                off += size
            del run[:]

        for e in reversed(bucket.entries):
            v = env.get(e.param_out)
            if e.param_out not in plan.defer_gather or \
                    not isinstance(v, ShardVal):
                continue
            if run and v.vec.dtype != env[run[0].param_out].vec.dtype:
                flush()
            run.append(e)
        flush()


def wrap_sharded_state(env, plan):
    """Wrap the incoming sharded state (this rank's flat slices) into
    ShardVals with their logical shapes."""
    for n, info in plan.sharded_state.items():
        v = env.get(n)
        if v is not None and not isinstance(v, ShardVal):
            env[n] = ShardVal(v, info.shape)


def unwrap_out(name, v, plan):
    """At the step's exit: sharded state leaves as its flat slice; any
    other ShardVal is gathered."""
    if not isinstance(v, ShardVal):
        return v
    if name in plan.sharded_state:
        return v.vec
    return gather_full(v, plan)


# ---------------------------------------------------------------------------
# shard-aware op execution
# ---------------------------------------------------------------------------

def _psum(x, plan):
    """The shard ring's sum of `x` (a plan without a ring is a world of
    one). On a hybrid world the pods hold the same shards, so the sum
    within the pod is the whole tensor's, as the reference's psum over
    its shard axis."""
    return x if plan.ring is None else co.all_reduce(x, plan.ring)


def _zero_pad_slots(vec, shape, plan):
    """Re-zero this shard's padding slots: an elementwise op with a
    broadcast scalar operand would write into the padding, which feeds
    the all-reduced norm partial sums and persists in sharded state."""
    numel = int(np.prod(shape)) if shape else 1
    size = int(vec.shape[0])
    if size * plan.ndev == numel:
        return vec  # no padding anywhere
    pos = plan.rank * size + torch.arange(size, device=vec.device)
    return torch.where(pos < numel, vec, torch.zeros_like(vec))


def _operand(v, like_shape, plan):
    """Align one operand with a sharded partner: a ShardVal gives its
    vec, a scalar stays a scalar, a replicated tensor of the partner's
    logical size gives the matching slice."""
    if isinstance(v, ShardVal):
        return v.vec
    if v.numel() <= 1:
        return v.reshape(())
    if tuple(v.shape) == tuple(like_shape) or \
            v.numel() == int(np.prod(like_shape)):
        return shard_slice(v, plan)
    raise RuntimeError(
        "sharded update: operand of shape %s cannot align with sharded "
        "value of logical shape %s" % (tuple(v.shape), like_shape))


def _compute(t, ins, attrs, device):
    from .. import ops as ops_lib

    attrs = dict(attrs)
    attrs["_device"] = device
    return ops_lib.normalize_outs(ops_lib.get_op(t).compute(ins, attrs))


def _exec_optimizer_op(op, env, plan, block, device):
    ins = {}
    for slot, names in op.input_names.items():
        if not names:
            continue
        vals = []
        for n in names:
            v = env[n]
            if isinstance(v, ShardVal):
                vals.append(v.vec)
            elif slot in _TENSOR_IN_SLOTS:
                vals.append(shard_slice(v, plan))
            else:
                vals.append(v)  # replicated hyper-state (lr, beta pows)
        ins[slot] = vals
    if op.type in _NORM_OPT:
        outs = _sharded_norm_opt(op.type, ins, dict(op.attrs), plan)
    else:
        outs = _compute(op.type, ins, op.attrs, device)
    for slot, names in op.output_names.items():
        vals = outs.get(slot, [])
        for n, v in zip(names, vals):
            if slot not in _TENSOR_OUT_SLOTS:
                env[n] = v  # replicated scalar state (beta pows, ...)
                continue
            if n in plan.sharded_state:
                env[n] = ShardVal(v, plan.sharded_state[n].shape)
                continue
            var = block._find_var_recursive(n)
            shape = tuple(getattr(var, "shape", ()) or ())
            if n in plan.defer_gather:
                # stays a shard until bucketed_gather_deferred
                env[n] = ShardVal(v, shape)
                continue
            # an updated param shard (or a state var kept replicated):
            # gathered back to the logical form the next forward reads
            env[n] = gather_full(ShardVal(v, shape), plan)


def _sharded_norm_opt(op_type, ins, attrs, plan):
    """LAMB and LARS on flat shards: the reference's math, with the
    trust-ratio and local-lr norms all-reduced over the ring (the zero
    padding adds nothing to a norm)."""
    f32 = torch.float32
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0].reshape(()).to(f32)
    if op_type == "lamb":
        m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
        b1p_in, b2p_in = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
        b1p = b1p_in.reshape(()).to(f32)
        b2p = b2p_in.reshape(()).to(f32)
        b1 = attrs.get("beta1", 0.9)
        b2 = attrs.get("beta2", 0.999)
        eps = attrs.get("epsilon", 1e-6)
        wd = attrs.get("weight_decay", 0.01)
        gf, pf = g.to(f32), p.to(f32)
        m1o = b1 * m1 + (1 - b1) * gf
        m2o = b2 * m2 + (1 - b2) * torch.square(gf)
        m1hat = m1o / (1 - b1p * b1)
        m2hat = m2o / (1 - b2p * b2)
        r = m1hat / (torch.sqrt(m2hat) + eps) + wd * pf
        # whole-tensor norms from the shards' partial sums
        p_norm = torch.sqrt(_psum(torch.sum(torch.square(pf)), plan))
        r_norm = torch.sqrt(_psum(torch.sum(torch.square(r)), plan))
        trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                            torch.ones_like(p_norm))
        p_out = pf - lr * trust * r
        return {"ParamOut": [p_out.to(p.dtype)],
                "Moment1Out": [m1o], "Moment2Out": [m2o],
                "Beta1PowOut": [b1p_in * b1],
                "Beta2PowOut": [b2p_in * b2]}
    # lars_momentum
    v = ins["Velocity"][0]
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    wd = attrs.get("lars_weight_decay", 0.0005)
    eps = attrs.get("epsilon", 0.0)
    pf, gf = p.to(f32), g.to(f32)
    p_norm = torch.sqrt(_psum(torch.sum(torch.square(pf)), plan))
    g_norm = torch.sqrt(_psum(torch.sum(torch.square(gf)), plan))
    local_lr = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lr * coeff * p_norm / (g_norm + wd * p_norm + eps), lr)
    v_out = mu * v.to(f32) + local_lr * (gf + wd * pf)
    p_out = pf - v_out
    return {"ParamOut": [p_out.to(p.dtype)],
            "VelocityOut": [v_out.to(v.dtype)]}


def exec_sharded_op(op, env, plan, block, device) -> bool:
    """Run `op` in shard space when it involves sharded values. Returns
    False when it has none (the caller runs it as usual)."""
    t = op.type
    if id(op) in plan.opt_op_ids:
        _exec_optimizer_op(op, env, plan, block, device)
        return True
    if t == "c_allreduce_sum":
        xs = op.input_names.get("X", [])
        if len(xs) == 1 and xs[0] in plan.rs_targets and \
                not isinstance(env[xs[0]], ShardVal):
            env[op.output_names["Out"][0]] = \
                reduce_scatter_sum(env[xs[0]], plan)
            return True
        return False

    in_vals = {slot: [env[n] for n in names]
               for slot, names in op.input_names.items() if names}
    sharded_ins = [v for vs in in_vals.values() for v in vs
                   if isinstance(v, ShardVal)]
    if not sharded_ins:
        return False
    shape = sharded_ins[0].shape

    def out(vec):
        env[op.output_names["Out"][0]] = ShardVal(
            _zero_pad_slots(vec, shape, plan), shape)
        return True

    if t in _EW_UNARY:
        vec = _operand(in_vals["X"][0], shape, plan)
        return out(_compute(t, {"X": [vec]}, op.attrs, device)["Out"][0])
    if t in _EW_BINARY:
        xv = _operand(in_vals["X"][0], shape, plan)
        yv = _operand(in_vals["Y"][0], shape, plan)
        return out(_compute(t, {"X": [xv], "Y": [yv]}, op.attrs,
                            device)["Out"][0])
    if t == "sum":
        vecs = [_operand(v, shape, plan) for v in in_vals["X"]]
        acc = vecs[0]
        for v in vecs[1:]:
            acc = acc + v
        return out(acc)
    if t in _NORM_REDUCE:  # squared_l2_norm -> a replicated (1,) value
        vec = _operand(in_vals["X"][0], shape, plan)
        sq = _psum(torch.sum(torch.square(vec.to(torch.float32))), plan)
        env[op.output_names["Out"][0]] = sq.reshape(1)
        return True
    if t == "clip_by_norm":
        vec = _operand(in_vals["X"][0], shape, plan)
        max_norm = op.attrs.get("max_norm", 1.0)
        sq = _psum(torch.sum(torch.square(vec.to(torch.float32))), plan)
        norm = torch.sqrt(sq)
        scale = torch.where(norm > max_norm, max_norm / norm,
                            torch.ones_like(norm))
        env[op.output_names["Out"][0]] = ShardVal(
            vec * scale.to(vec.dtype), shape)
        return True
    raise RuntimeError(
        "sharded update: op %r reached execution with sharded operands "
        "but no shard-aware rule; plan_sharded_update should have "
        "declined this program" % t)


def run_sharded_post_ops(post_ops, env, seed, base_idx, amp, plan, block,
                         device, skip=frozenset()):
    """The post-backward section in shard space: shard-aware ops run on
    the flat slices, everything else (learning-rate schedules, counters)
    through the lowering's interpreter on replicated values; the ops
    whose ids are in `skip` (explicit syncs the backward already ran) do
    not run.

    An explicit-sync program with buckets holds each c_allreduce_sum on
    a bucketed gradient until the bucket's last member arrives, then
    reduce-scatters the bucket as one collective; an op that reads a
    held gradient flushes its bucket first. The deferred param
    all-gathers run at the end, one a bucket."""
    from ..fluid import lowering

    pending: Dict[int, Dict[str, object]] = {}

    def _flush(bidx):
        vals = pending.pop(bidx, None)
        if vals:
            env.update(bucket_reduce_scatter(
                plan.buckets[bidx], vals, plan, mean=False))

    for i, op in enumerate(post_ops):
        if id(op) in skip:
            continue
        if pending or (plan.explicit_sync and plan.buckets):
            if op.type == "c_allreduce_sum":
                xs = op.input_names.get("X", [])
                if len(xs) == 1 and xs[0] in plan.rs_targets \
                        and xs[0] in plan.bucket_of \
                        and not isinstance(env[xs[0]], ShardVal):
                    b = plan.bucket_of[xs[0]]
                    pending.setdefault(b.index, {})[xs[0]] = env[xs[0]]
                    if len(pending[b.index]) == len(b.entries):
                        _flush(b.index)
                    continue
            if pending:
                reads = set(lowering._op_reads_writes(op)[0])
                for bidx in [bi for bi, vals in pending.items()
                             if reads & set(vals)]:
                    _flush(bidx)
        if exec_sharded_op(op, env, plan, block, device):
            continue
        lowering._exec_op(op, env, seed, base_idx + i, device, amp)
    for bidx in list(pending):
        _flush(bidx)
    if plan.buckets and plan.defer_gather:
        bucketed_gather_deferred(env, plan)


# ---------------------------------------------------------------------------
# host-side layout
# ---------------------------------------------------------------------------

def to_sharded_local(value, info: ShardInfo, rank: int, ndev: int):
    """This rank's flat slice of one state value (the counterpart of the
    reference's `to_sharded_global`): flattened, zero-padded to
    `info.padded` and sliced, a tensor of its own. A 1-D value longer
    than the logical size is a flat buffer padded for another world and
    loses that padding first."""
    flat = value.reshape(-1)
    if value.dim() == 1 and flat.shape[0] > info.numel:
        flat = flat[:info.numel]
    if flat.shape[0] != info.numel:
        raise ValueError("sharded state %r: a value of %d elements for a "
                         "var of %d" % (info.name, flat.shape[0],
                                        info.numel))
    flat = _flat_pad(flat, ndev)
    size = info.padded // ndev
    return flat[rank * size:(rank + 1) * size].clone()


def gather_logical(value, info: ShardInfo, plan):
    """A scope's flat slice of `info`'s var gathered over the plan's
    ring and unsharded to the logical shape (every rank must call it)."""
    return info.unshard(_all_gather(value.reshape(-1), plan))


def logical_value(program, name, value):
    """`value` of `name` at its logical shape: a flat slice that
    `program`'s last plan keeps sharded is gathered over the plan's ring
    (a collective: every rank calls this alike); any other value as it
    is."""
    plan = getattr(program, "_shard_plan", None)
    info = plan.sharded_state.get(name) if plan is not None else None
    if info is None or tuple(value.shape) == info.shape:
        return value
    return gather_logical(value, info, plan)


def unshard_scope_value(program, name, value):
    """If `name` is sharded state of `program`, `value` (the whole flat
    buffer, every rank's slice in rank order) at its logical shape;
    otherwise `value` unchanged."""
    plan = getattr(program, "_shard_plan", None)
    if plan is not None:
        info = plan.sharded_state.get(name)
        if info is not None:
            return info.unshard(value)
    return value


def reshard_scope_to_logical(program, scope) -> int:
    """Rewrite every sharded state var of `program` in `scope` back to
    its logical shape, gathered over the plan's ring (every rank must
    call it); the next run lays them out again for the world it runs in.
    Returns the number of vars rewritten."""
    n = 0
    plan = getattr(program, "_shard_plan", None)
    if plan is None:
        return 0
    for name, info in plan.sharded_state.items():
        v = scope.find_var(name)
        if v is None or tuple(v.shape) == info.shape:
            continue
        scope.set_var(name, gather_logical(v, info, plan))
        n += 1
    return n


def eager_accumulator_sharding(shape):
    """The reference's dygraph layout hint for an optimizer accumulator.
    Dygraph is not ported (ROADMAP Queue 1 #8)."""
    raise NotImplementedError(
        "eager_accumulator_sharding is the dygraph path of the sharded "
        "update, not ported (ROADMAP Queue 1 #8)")
