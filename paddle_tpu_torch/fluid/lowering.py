"""Block execution: a Program block -> one Python function that runs its
ops op by op, and the compiled entry the executor keeps for it
(counterpart: `paddle_tpu/fluid/lowering.py`, its core with the
control-flow ops, the AMP cast policy, float16 loss scaling, recompute,
gradient merge and the data-parallel gradient sync, without the sparse
and fp8 branches).

The reference traces the op list into one jitted XLA computation
(`compile_block`, with the state donated). The port issues each op's
torch compute function in order on the executor's device, and
`compile_block` wraps that function in a `CompiledBlock`: on the card its
first run is eager, its second is captured as a CUDA graph
(`core/graphs.py`, the state donated), and every later run replays the
graph. A block runs eagerly by design where the reference would not jit
it or where the port decides on the host (`capture_blocker`): an op
flagged `no_jit` or `dynamic_shape`, an initializer (its generator is
seeded on the host), or `while`, `cond`, `conditional_block` and
`switch_case`, which read their predicate on the host. The CPU runs
every block eagerly, and `FLAGS_cuda_graphs` off (the counterpart of
`jax.disable_jit`) does so on the card.

Autodiff: `append_backward` plants a single `backward` pseudo-op. The
function runs the forward segment on leaf tensors that require grad,
then takes `torch.autograd.grad` of the loss and binds each `X@GRAD`
(replacing the reference's `jax.vjp`). With recompute checkpoints on
that op the forward runs as segments under non-reentrant
`torch.utils.checkpoint` (`_remat_segments`, the reference's
`jax.checkpoint` segments). Under gradient merge (`_gradient_merge`)
the compiled entry holds two functions, an accumulating step and an
applying one, and picks on the host (`CompiledBlock`).

Control flow: `while` is a Python loop that reads its condition on the
host before each iteration, the counterpart of `lax.while_loop` (and,
like it, not reverse-differentiable: a gradient through it raises);
`cond`, `switch_case` and `conditional_block` read their predicate or
index on the host and run only the branch it picks (autograd
differentiates it, as JAX does the taken branch of `lax.cond`). The
carry of a loop, and what a branch sets, are the sub-block's writes to
vars that pre-exist in the enclosing environment.

`scan` (`layers.Scan`) runs its sub-block once per iteration over
per-layer slices of stacked [n, ...] inputs, taken with one `unbind` each
(so autograd stacks their gradients once), with its iteration var (if
the body asked for one) bound to the index as an int32 [1] tensor on the
device; with `remat` each iteration runs under
`torch.utils.checkpoint`. Random ops get their seed from the run's seed
and the op's index (`core/rng.py`: dropout and attention an int64 tensor
folded on the device, never read on the host; the initializers a
generator seeded on the host); inside a scan or loop the seed is folded
with its op's index and the iteration first, as the reference folds its
key, so every layer draws its own dropout mask and a recomputed
iteration draws the same one.

AMP (`fluid.contrib.mixed_precision`): the program's white-list ops get
their float32 inputs cast to the compute dtype (bf16 or float16) and its
black-list ops their 16-bit inputs cast to float32, op by op as they run
(the reference applies the same casts while tracing). float16 loss
scaling (the reference's `_run_loss_scaled_post`): the loss's cotangent
is multiplied by the scale, read from its scope tensor on the device (so
a replay uses the scale of that step, not the capture's), the gradients
are exchanged, checked for non-finite values (the count all-reduced over
the data-parallel ring, within the pod and across pods on a hybrid
world) and unscaled in float32. The reference skips the post-backward
section with `lax.cond`; a captured block cannot branch on the host, so
the port runs the section on every step and rank (every collective runs
everywhere, as the reference's psum'd predicate ensures) and then
selects, with `torch.where` on the device, every var the section wrote
back to its value before the section on an overflow (params, masters,
moments, counters, the lr: bit for bit; a var the section created reads
zeros). The scale state machine updates after that, outside the
selection (`_loss_scaled_post`). Static loss scaling multiplies and
divides by a constant and never skips.

Data parallelism (`CompiledProgram.with_data_parallel`, fleet): the
reference lowers a data-parallel block under `shard_map` over the mesh;
the port runs it as one rank of a `torch.distributed` world, its ring
live for the block's collective ops (`parallel/env.py`). By default the
block runs the reference's sharded weight update (ZeRO-1,
`parallel/sharded_update.py`, planned once a compile by
`parallel/planner.py` and kept as ``program._shard_plan``): the
optimizer-bound gradients are reduce-scattered over the ring in buckets
of backward order (fleet's `c_allreduce_sum` on them becomes the
reduce-scatter), the post-backward section runs on this rank's flat 1/N
shards, the moments and AMP masters enter and leave the step as this
rank's shards, and the updated params are all-gathered (the deferred
ones at the end of the step, a bucket at a time, in forward order).
Where there is no plan (one rank, `FLAGS_tpu_sharded_weight_update` off,
a program the planner declines) and the program does not sync its
gradients itself, every gradient is averaged over the ring, one
all-reduce each (the reference's `_dp_pmean`; on a hybrid (dcn, ici)
world a sum within the pod, then across pods, then a division by the
world). The gradient exchange starts inside the backward
(`_GradExchange`): each bucket's reduce-scatter, each gradient's
all-reduce in backward order, and fleet's in-place `c_allreduce_sum`
sums (which then do not run as ops) are launched by autograd hooks as
soon as their last gradient exists, in one order on every rank, and
waited for before the post-backward section; with
`FLAGS_tpu_comm_bucket_mb` 0 everything is exchanged after the backward
instead. The values are the same either way. `Executor.overlap_report`
reads what the last run (or the capture) launched when. A collective
that fails raises; nothing falls back to the replicated path mid-step.
Gloo
collectives run on the host, so a data-parallel block over gloo runs
eagerly; over NCCL it is captured with its collectives at any number of
ranks (with `FLAGS_cudnn_deterministic` a captured 4-card job equals an
eager one bit for bit: ROADMAP Queue 3).

Scope semantics: the function is pure over a name -> tensor environment.
Scope state (params, optimizer moments) enters as inputs and leaves as
outputs; an op that writes a var (ParamOut is Param) rebinds the name to
a new tensor and never changes the old one in place, so autograd's saved
tensors stay valid.
"""
from __future__ import annotations

import functools
import logging
import warnings
from typing import Dict, List, Optional

import torch
import torch.utils.checkpoint

from . import framework
from .. import ops as ops_lib
from ..core import graphs
from ..core.errors import NotFoundError, attach_op_callstack
from ..core.rng import StepSeed, make_generator, seed_tensor
from ..core.types import to_torch_dtype
from ..ops import collective_ops
from ..ops.registry import meta_rng_attrs
from ..parallel import env as penv
from ..parallel import planner
from ..parallel import sharded_update as _su
from ..utils.flags import get_flag

_log = logging.getLogger(__name__)

# Ops that exist only for runtime bookkeeping in the reference
_SKIP_OPS = frozenset({"feed", "fetch", "nop"})


def _sub_block_idxs(op):
    """The sub-blocks of a control-flow op: a scan's or while's body, a
    cond's two branches, a switch_case's branches."""
    idxs = [op.attrs[a] for a in ("sub_block", "sub_block_t", "sub_block_f")
            if a in op.attrs]
    idxs.extend(op.attrs.get("sub_blocks", []))
    return idxs


def _op_reads_writes(op):
    """(reads, writes) of an op, looking through a control-flow op's
    sub-blocks (a var read only inside a loop body or a branch, however
    deeply nested, is still block-level state). Sub-block writes to
    persistable vars also count as reads: the carry needs their incoming
    value."""
    reads = list(op.input_arg_names)
    writes = list(op.output_arg_names)
    prog = op.block.program
    for bi in _sub_block_idxs(op):
        blk = prog.block(bi)
        # the scan's slices and its iteration var are made by the loop
        # itself
        produced_local = set(op.attrs.get("xs_slice", []))
        if op.attrs.get("iter_var"):
            produced_local.add(op.attrs["iter_var"])
        for sop in blk.ops:
            sr, sw = _op_reads_writes(sop)
            reads.extend(n for n in sr if n not in produced_local)
            for n in sw:
                v = blk._find_var_recursive(n)
                if v is not None and v.persistable \
                        and n not in produced_local:
                    reads.append(n)
                produced_local.add(n)
                writes.append(n)
    return reads, writes


def analyze_block(block, feed_names, fetch_names):
    """Dataflow analysis: which names are scope state in/out."""
    produced = set(feed_names)
    state_in: List[str] = []
    state_in_set = set()
    for op in block.ops:
        op_reads, op_writes = _op_reads_writes(op)
        for name in op_reads:
            if name not in produced and name not in state_in_set:
                state_in.append(name)
                state_in_set.add(name)
        for name in op_writes:
            produced.add(name)
    for name in fetch_names:
        if name not in produced and name not in state_in_set:
            state_in.append(name)
            state_in_set.add(name)

    # state outputs: names written by ops that are persistable vars or
    # rebind scope-resident inputs (param updates, moments, ...)
    state_out: List[str] = []
    seen = set()
    for op in block.ops:
        for name in _op_reads_writes(op)[1]:
            if name in seen:
                continue
            v = block._find_var_recursive(name)
            if (v is not None and v.persistable) or name in state_in_set:
                seen.add(name)
                state_out.append(name)
    return state_in, state_out


def _exec_op(op, env, seed, op_idx, device, amp=None):
    t = op.type
    if t in _SKIP_OPS:
        return
    if t in _CONTROL_FLOW:
        return _CONTROL_FLOW[t](op, env, seed, op_idx, device, amp)
    opdef = ops_lib.get_op(t)
    ins = {}
    for slot, names in op.input_names.items():
        if not names:
            continue
        try:
            ins[slot] = [env[n] for n in names]
        except KeyError as e:
            attach_op_callstack(NotFoundError(
                "op %s: input var %s not materialized (feed it or run "
                "the startup program)" % (t, e)), op)
    if amp is not None:
        ins = _apply_amp_casts(t, op, ins, amp)
    attrs = dict(op.attrs)
    attrs["_device"] = device
    if opdef.rng == "device":
        attrs["_rng_seed"] = seed.fold(op_idx).dev
    elif opdef.rng == "host":
        attrs["_rng_generator"] = make_generator(seed.host, op_idx, device)
    try:
        outs = ops_lib.normalize_outs(opdef.compute(ins, attrs))
    except Exception as e:  # noqa: BLE001 - attach the op's creation site
        attach_op_callstack(e, op)
    for slot, names in op.output_names.items():
        for n, v in zip(names, outs.get(slot, [])):
            env[n] = v


def _run_ops(ops, env, seed, device, base_idx=0, amp=None, skip=()):
    for i, op in enumerate(ops):
        if id(op) not in skip:
            _exec_op(op, env, seed, base_idx + i, device, amp)


def _sub_block_carry(sub_block, env):
    """Loop carry: the sub-block's writes that pre-exist in the enclosing
    env (loop vars are created and initialized before the loop)."""
    carry = []
    for sop in sub_block.ops:
        for n in _op_reads_writes(sop)[1]:
            if n in env and n not in carry:
                carry.append(n)
    return carry


def _exec_scan(op, env, seed, op_idx, device, amp):
    """`scan` op (reference: `_exec_scan`, a `lax.scan`): `n` runs of the
    sub-block, each over the iteration's slices of the stacked inputs,
    threading the carry (the sub-block's writes to pre-existing vars)."""
    sub = op.block.program.block(op.attrs["sub_block"])
    carry_names = _sub_block_carry(sub, env)
    if not carry_names:
        raise RuntimeError(
            "scan: the body never rebinds a pre-existing var — every "
            "iteration's results would be discarded. Rebind the carry "
            "with layers.assign(new_val, output=carried_var).")
    base = seed.fold(op_idx)
    xs_slice = list(op.attrs.get("xs_slice", []))
    iter_name = op.attrs.get("iter_var")
    n = int(op.attrs["n"])
    iters = torch.arange(n, dtype=torch.int32, device=device).reshape(n, 1) \
        if iter_name else None
    outer = dict(env)

    def body(it, carry, slices):
        e = dict(outer)
        e.update(zip(carry_names, carry))
        e.update(zip(xs_slice, slices))
        if iter_name:
            e[iter_name] = iters[it]
        _run_ops(sub.ops, e, base.fold(it), device, amp=amp)
        return tuple(e[n] for n in carry_names)

    stacked = [env[n].unbind(0) for n in op.attrs.get("xs_stacked", [])]
    remat = op.attrs.get("remat") and torch.is_grad_enabled()
    carry = tuple(env[n] for n in carry_names)
    for it in range(n):
        slices = [x[it] for x in stacked]
        if remat:
            # the recompute runs every op of the iteration again (no
            # early stop: it would surface inside an op as an error)
            with torch.utils.checkpoint.set_checkpoint_early_stop(False):
                carry = torch.utils.checkpoint.checkpoint(
                    functools.partial(body, it), carry, slices,
                    use_reentrant=False, preserve_rng_state=False)
        else:
            carry = body(it, carry, slices)
    env.update(zip(carry_names, carry))


class _NoReverseThroughWhile(torch.autograd.Function):
    """Identity on a while loop's carried tensors whose backward raises:
    the reference's `lax.while_loop` is not reverse-differentiable, so a
    gradient that would flow back through the loop is an error there, and
    here, rather than a silent zero."""

    @staticmethod
    def forward(ctx, *xs):
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        raise ValueError(
            "Reverse-mode differentiation does not work for a fluid While "
            "loop (the reference lowers it to lax.while_loop); use "
            "layers.Scan for a differentiable fixed-trip loop")


def _exec_while(op, env, seed, op_idx, device, amp):
    """`while` op (reference: `_exec_while`, a `lax.while_loop`): a
    Python loop that reads the condition on the host before every
    iteration (one synchronization each), runs the body over the carry
    (the body's writes to pre-existing vars), and folds the iteration
    into the random seed so each iteration draws its own dropout masks.
    Carried float tensors that take part in autograd come out through
    `_NoReverseThroughWhile`."""
    sub = op.block.program.block(op.attrs["sub_block"])
    cond_name = op.attrs["cond_name"]
    carry_names = _sub_block_carry(sub, env)
    if cond_name not in carry_names:
        raise RuntimeError(
            "while: the loop body never rebinds condition var %r — the "
            "loop would not terminate" % cond_name)
    base = seed.fold(op_idx)
    cond_pos = carry_names.index(cond_name)
    carry = [env[n] for n in carry_names]
    it = 0
    while bool(carry[cond_pos].all()):
        e = dict(env)
        e.update(zip(carry_names, carry))
        _run_ops(sub.ops, e, base.fold(it), device, amp=amp)
        carry = [e[n] for n in carry_names]
        it += 1
    tracked = [i for i, v in enumerate(carry)
               if torch.is_grad_enabled() and v.requires_grad]
    if tracked:
        outs = _NoReverseThroughWhile.apply(*(carry[i] for i in tracked))
        for i, v in zip(tracked, outs):
            carry[i] = v
    env.update(zip(carry_names, carry))


def _branch_out_names(op, env, blocks):
    """The names a branch op sets: its declared outputs, then every
    write (nested ones too) of any of its branches to a var that
    pre-exists in `env` (a branch that assigns an enclosing loop's var).
    A branch that does not write such a name leaves env's value."""
    names = list(op.attrs["out_names"])
    seen = set(names)
    for blk in blocks:
        for sop in blk.ops:
            for n in _op_reads_writes(sop)[1]:
                if n in env and n not in seen:
                    names.append(n)
                    seen.add(n)
    return names


def _run_branch(block, env, seed, out_names, device, amp):
    """Run one branch over a copy of `env`; its values of `out_names`."""
    e = dict(env)
    _run_ops(block.ops, e, seed, device, amp=amp)
    return [e[n] for n in out_names]


def _pred(env, name):
    """A branch or loop predicate, read on the host: all of it true."""
    return bool(env[name].all())


def _exec_cond(op, env, seed, op_idx, device, amp):
    """`cond` op (reference: `_exec_cond`, a `lax.cond`): the predicate
    is read on the host and only the branch it picks runs; autograd
    differentiates that branch, as JAX differentiates the taken one."""
    prog = op.block.program
    blk_t = prog.block(op.attrs["sub_block_t"])
    blk_f = prog.block(op.attrs["sub_block_f"])
    out_names = _branch_out_names(op, env, [blk_t, blk_f])
    blk = blk_t if _pred(env, op.attrs["cond_name"]) else blk_f
    env.update(zip(out_names, _run_branch(
        blk, env, seed.fold(op_idx), out_names, device, amp)))


def _meta_outputs(block, env, names):
    """Shape and dtype of `names` after `block` ran over `env`, found by
    running its ops on meta tensors (no data, no device work)."""
    meta = torch.device("meta")
    e = {n: v.to(meta) if isinstance(v, torch.Tensor) else v
         for n, v in env.items()}
    for op in block.ops:
        if op.type in _SKIP_OPS:
            continue
        ins = {slot: [e[n] for n in names_] for slot, names_
               in op.input_names.items() if names_}
        attrs = dict(op.attrs, _device=meta, **meta_rng_attrs())
        outs = ops_lib.normalize_outs(ops_lib.get_op(op.type).compute(
            ins, attrs))
        for slot, names_ in op.output_names.items():
            e.update(zip(names_, outs.get(slot, [])))
    return [e[n] for n in names]


def _exec_conditional_block(op, env, seed, op_idx, device, amp):
    """`conditional_block` op (reference: `_exec_conditional_block`): the
    sub-block runs iff Cond holds (read on the host; no Cond input means
    true). On the skip path every output keeps env's value, and an output
    first created inside the block is zeros of its shape and dtype, like
    the reference's unexecuted branch."""
    blk = op.block.program.block(op.attrs["sub_block"])
    out_names = _branch_out_names(op, env, [blk]) \
        if "out_names" in op.attrs else _sub_block_carry(blk, env)
    conds = op.input_names.get("Cond", [])
    if not conds or _pred(env, conds[0]):
        outs = _run_branch(blk, env, seed.fold(op_idx), out_names,
                           device, amp)
    else:
        new = [n for n in out_names if n not in env]
        shapes = dict(zip(new, _meta_outputs(blk, env, new)))
        outs = [env[n] if n in env else torch.zeros(
            shapes[n].shape, dtype=shapes[n].dtype, device=device)
            for n in out_names]
    env.update(zip(out_names, outs))


def _exec_switch_case(op, env, seed, op_idx, device, amp):
    """`switch_case` op (reference: `_exec_switch_case`, a `lax.switch`):
    the index is read on the host; the branch whose key it equals runs,
    the default (the last block) when none does."""
    prog = op.block.program
    blocks = [prog.block(b) for b in op.attrs["sub_blocks"]]
    out_names = _branch_out_names(op, env, blocks)
    index = env[op.attrs["index_name"]]
    if index.numel() != 1:
        raise ValueError("switch_case: the index must hold one value, got "
                         "shape %s" % (tuple(index.shape),))
    idx = int(index.reshape(()))
    keys = list(op.attrs["keys"])
    blk = blocks[keys.index(idx)] if idx in keys else blocks[-1]
    env.update(zip(out_names, _run_branch(
        blk, env, seed.fold(op_idx), out_names, device, amp)))


_CONTROL_FLOW = {
    "scan": _exec_scan,
    "while": _exec_while,
    "cond": _exec_cond,
    "conditional_block": _exec_conditional_block,
    "switch_case": _exec_switch_case,
}


class _AmpTracePolicy:
    """The AMP cast policy of a decorated program: white-list ops take
    their float32 inputs in the compute dtype `low` (bf16), black-list
    ops their `low` inputs in float32; gray-list and unlisted ops follow
    their inputs. Vars named in the lists' `black_varnames` keep their
    dtype."""

    __slots__ = ("lists", "low")

    def __init__(self, lists, dtype_name):
        self.lists = lists
        self.low = to_torch_dtype(dtype_name)


def _amp_trace_policy(program):
    """program -> _AmpTracePolicy, or None when AMP is off."""
    lists = getattr(program, "_amp_lists", None)
    if not getattr(program, "_amp", False) or lists is None:
        return None
    return _AmpTracePolicy(lists, getattr(program, "_amp_dtype",
                                          "bfloat16"))


def _apply_amp_casts(t, op, ins, amp):
    """The list-boundary casts of one op's inputs (see _AmpTracePolicy)."""
    if t in amp.lists.white_list:
        src, dst = torch.float32, amp.low
    elif t in amp.lists.black_list:
        src, dst = amp.low, torch.float32
    else:
        return ins
    black_vars = getattr(amp.lists, "black_varnames", None) or ()
    out = {}
    for slot, vs in ins.items():
        names = op.input_names.get(slot, [])
        out[slot] = [
            v.to(dst) if v.dtype == src and (
                i >= len(names) or names[i] not in black_vars) else v
            for i, v in enumerate(vs)]
    return out


def _diffable(block, name, env):
    v = block._find_var_recursive(name)
    if v is None or v.stop_gradient:
        return False
    val = env.get(name)
    return isinstance(val, torch.Tensor) and val.is_floating_point()


class _GradExchange:
    """The data-parallel gradient exchange of one backward: `units`, each
    one collective over some gradients (a bucket's reduce-scatter, one
    gradient's reduce-scatter or all-reduce), launched in the units'
    order on every rank. With `hooks` a unit launches from inside the
    backward as soon as its last gradient exists (a multi-grad hook on
    the `views` through which the forward reads the leaves) and after
    every unit before it (ready ones queue); `finish` launches the rest
    once the backward returned and waits for all.

    `records` says, for each launch, its kind, bucket, gradients and
    bytes, and how many leaf gradients the backward produced after it
    (`backward_after`, counted by hooks on the same views): the
    counterpart of the reference's `collective_overlap_audit`.

    A unit is (kind, bucket index or None, diff var names, launch), where
    ``launch({name: gradient})`` starts the collective and returns a
    function that waits and gives {grad var name: exchanged value}."""

    def __init__(self, units, views, hooks):
        from torch.autograd.graph import register_multi_grad_hook

        self.units = units
        self.views = views
        self.ready = [None] * len(units)
        self.waits = []
        self.next = 0
        self.produced = 0
        self.records = []
        for v in views.values():
            v.register_hook(self._count)
        if hooks:
            for i, unit in enumerate(units):
                register_multi_grad_hook(
                    [views[n] for n in unit[2]],
                    functools.partial(self._ready, i), mode="all")

    def _count(self, grad):
        self.produced += 1

    def _ready(self, i, grads):
        # a gradient the backward never produced is zeros, as jax.vjp
        # gives (every rank leaves out the same ones)
        self.ready[i] = {
            n: torch.zeros_like(self.views[n]) if g is None else g
            for n, g in zip(self.units[i][2], grads)}
        self._drain()

    def _drain(self):
        while self.next < len(self.units) and \
                self.ready[self.next] is not None:
            kind, bucket, names, launch = self.units[self.next]
            grads = self.ready[self.next]
            self.records.append({
                "kind": kind, "bucket": bucket, "grads": len(names),
                "bytes": sum(g.numel() * g.element_size()
                             for g in grads.values()),
                "launched_after": self.produced})
            self.waits.append(launch(grads))
            self.ready[self.next] = True
            self.next += 1

    def finish(self, grads):
        """Launch the units the backward did not, with `grads` (diff var
        name -> gradient, zeros for the unused), wait for every unit and
        return {grad var name: exchanged value}."""
        for i in range(self.next, len(self.units)):
            if self.ready[i] is None:
                self.ready[i] = {n: grads[n] for n in self.units[i][2]}
        self._drain()
        out = {}
        for wait in self.waits:
            out.update(wait())
        for r in self.records:
            r["backward_after"] = self.produced - r.pop("launched_after")
            r["starts_before_final_backward"] = r["backward_after"] > 0
        return out


def _exchange_units(diff_names, grad_topo, ring, plan, mean):
    """The units of a data-parallel step's gradient exchange over `ring`
    (see `_GradExchange`), in launch order: with a sharded-update `plan`
    its buckets in backward order (without buckets its gradients one by
    one), then every other gradient's all-reduce in backward order
    (descending last forward use, `grad_topo`). `mean` divides each sum
    by the world (the implicit sync); fleet's explicit sync sums."""
    gname = {framework.grad_var_name(n): n for n in diff_names}
    units, taken = [], set()
    if plan is not None:
        for b in plan.buckets:
            names = [gname[e.grad] for e in b.entries if e.grad in gname]
            if names:
                units.append(("reduce_scatter", b.index, names,
                              functools.partial(_launch_bucket, b, plan,
                                                mean)))
                taken.update(names)
        for n in diff_names:
            if framework.grad_var_name(n) in plan.grad_names | \
                    plan.rs_targets and n not in taken:
                units.append(("reduce_scatter", None, [n],
                              functools.partial(_launch_scatter, plan, mean)))
                taken.add(n)
    rest = [(i, n) for i, n in enumerate(diff_names) if n not in taken]
    rest.sort(key=lambda p: (-int(grad_topo.get(p[1], -1)), -p[0]))
    units.extend(("all_reduce", None, [n],
                  functools.partial(_launch_sum, ring, mean))
                 for _, n in rest)
    return units


def _launch_bucket(bucket, plan, mean, grads):
    return _su.bucket_reduce_scatter_start(
        bucket, {framework.grad_var_name(n): g for n, g in grads.items()},
        plan, mean)


def _launch_scatter(plan, mean, grads):
    (n, g), = grads.items()
    wait = _su.reduce_scatter_start(g, plan, mean)
    return lambda: {framework.grad_var_name(n): wait()}


def _launch_sum(ring, mean, grads):
    (n, g), = grads.items()
    pending = collective_ops.all_reduce_start(g, ring)
    if mean:
        return lambda: {framework.grad_var_name(n):
                        pending.wait() / ring.size}
    return lambda: {framework.grad_var_name(n): pending.wait()}


def _early_syncs(ops, bwd_idx):
    """Fleet's explicit sync: the ids of the in-place single-gradient
    `c_allreduce_sum` ops on ring 0 after the backward that no post op
    before them touches, by gradient. Their sums are launched from the
    backward instead (`_GradExchange`), and the ops are skipped."""
    out, touched = {}, set()
    for op in ops[bwd_idx + 1:] if bwd_idx is not None else []:
        xs = op.input_names.get("X", [])
        if op.type == "c_allreduce_sum" and len(xs) == 1 \
                and op.output_names.get("Out", []) == xs \
                and xs[0].endswith(framework.GRAD_SUFFIX) \
                and int(op.attrs.get("ring_id", 0)) == 0 \
                and xs[0] not in touched and xs[0] not in out:
            out[xs[0]] = id(op)
            continue
        touched.update(op.input_arg_names)
        touched.update(op.output_arg_names)
    return out


def _has_explicit_sync(ops, bwd_idx):
    """Whether an op after the backward all-reduces a `@GRAD` var (fleet's
    transpiled program syncs its own gradients; a forward collective such
    as a globally averaged metric does not count)."""
    post = ops[bwd_idx + 1:] if bwd_idx is not None else []
    return any(
        (op.type.startswith("c_allreduce") or op.type == "allreduce")
        and any(n.endswith(framework.GRAD_SUFFIX)
                for n in op.input_arg_names)
        for op in post)


def _full(like, value, dtype):
    """A 0-d `dtype` tensor of `value` on `like`'s device (a fill, which
    a CUDA graph can capture)."""
    return torch.full((), value, dtype=dtype, device=like.device)


def _amp_found_inf(grads, ring):
    """Whether any value of this step's exchanged gradients is not finite,
    a 0-d bool on the device: the non-finite count of each rank's own
    values (under the sharded update its 1/N shards), summed over the
    data-parallel `ring` (within the pod, then across pods), so that every
    rank decides alike."""
    total = None
    for g in grads:
        v = g.vec if isinstance(g, _su.ShardVal) else g
        c = torch.sum(~torch.isfinite(v), dtype=torch.float32)
        total = c if total is None else total + c
    if ring is not None:
        total = collective_ops.all_reduce(total, ring)
    return total > 0


def _amp_unscale(g, scale):
    """grad / loss scale, computed in float32 (a float16 division would
    lose again the low bits the scaling kept), in the grad's dtype."""
    if isinstance(g, _su.ShardVal):
        return _su.ShardVal(_amp_unscale(g.vec, scale), g.shape)
    return (g.to(torch.float32) / scale).to(g.dtype)


def _select_old(found, old, new, plan):
    """`old` where `found`, else `new`, in old's dtype. Where either is a
    ShardVal (an AMP param the section re-derived from its sharded
    master, gathered at the step's exit) the shards are selected, the
    whole value taken as this rank's slice of it."""
    if isinstance(old, _su.ShardVal) or isinstance(new, _su.ShardVal):
        shape = (old if isinstance(old, _su.ShardVal) else new).shape
        o, n = (v.vec if isinstance(v, _su.ShardVal)
                else _su.shard_slice(v, plan) for v in (old, new))
        return _su.ShardVal(_select_old(found, o, n, plan), shape)
    return torch.where(found, old, new.to(old.dtype))


def _loss_scaled_post(run_post, dls, env, found_inf, plan=None):
    """float16 dynamic loss scaling around the post-backward section
    (`run_post(env)`): the section runs, then every var it wrote takes
    back its value from before the section where `found_inf` (a var it
    created: zeros), and the scale state machine advances:

      clean step:    good += 1; good == incr_every_n_steps
                     -> scale *= incr_ratio, good = 0
      overflow step: bad += 1, good = 0; bad == decr_every_n_nan_or_inf
                     -> scale *= decr_ratio, bad = 0
    """
    before = dict(env)
    run_post(env)
    for n, v in list(env.items()):
        old = before.get(n)
        if old is v or not isinstance(v, (torch.Tensor, _su.ShardVal)):
            continue
        if old is None:
            env[n] = _select_old(found_inf, torch.zeros_like(v), v, plan) \
                if isinstance(v, torch.Tensor) else v
        else:
            env[n] = _select_old(found_inf, old, v, plan)
    scale_n, good_n, bad_n = dls["scale"], dls["good"], dls["bad"]
    f32, i32 = torch.float32, torch.int32
    scale = env[scale_n].reshape(()).to(f32)
    good = env[good_n].reshape(()).to(i32)
    bad = env[bad_n].reshape(()).to(i32)
    zero = _full(good, 0, i32)
    new_good = torch.where(found_inf, zero, good + 1)
    new_bad = torch.where(found_inf, bad + 1, zero)
    grow = ~found_inf & (new_good >= int(dls.get("incr_every_n_steps",
                                                 1000)))
    shrink = found_inf & (new_bad >= int(dls.get("decr_every_n_nan_or_inf",
                                                 2)))
    new_scale = torch.where(
        shrink, scale * _full(scale, dls.get("decr_ratio", 0.8), f32),
        torch.where(grow, scale * _full(scale, dls.get("incr_ratio", 2.0),
                                        f32), scale))
    for name, val in ((scale_n, new_scale),
                      (good_n, torch.where(grow, zero, new_good)),
                      (bad_n, torch.where(shrink, zero, new_bad))):
        env[name] = val.reshape(env[name].shape).to(env[name].dtype)


def _split_at_checkpoints(ops, ckpt_names):
    """Recompute segment bounds: a segment ends right after the last op
    that writes each checkpoint var. (start, stop) pairs covering
    `ops`."""
    cuts = set()
    for cn in ckpt_names:
        last = None
        for i, op in enumerate(ops):
            if cn in op.output_arg_names:
                last = i
        if last is not None and last + 1 < len(ops):
            cuts.add(last + 1)
    bounds, prev = [], 0
    for c in sorted(cuts):
        bounds.append((prev, c))
        prev = c
    bounds.append((prev, len(ops)))
    return bounds


def _remat_segments(fwd_ops, ckpt_names, live_out):
    """The recompute segments of a forward (reference: `_remat_segments`):
    (start, stop, needed) for each, `needed` the names the segment writes
    that a later segment reads or that outlive the forward (`live_out`:
    the loss, the post-backward section's reads, fetches and state
    outputs). Only those leave a segment; its interior is recomputed in
    the backward. None for a single segment."""
    bounds = _split_at_checkpoints(fwd_ops, ckpt_names)
    if len(bounds) <= 1:
        return None
    out = []
    needed = set(live_out)
    for start, stop in reversed(bounds):
        written = set()
        for op in fwd_ops[start:stop]:
            written.update(_op_reads_writes(op)[1])
        out.append((start, stop, frozenset(needed & written)))
        for op in fwd_ops[start:stop]:
            needed.update(_op_reads_writes(op)[0])
    out.reverse()
    return out


def _run_segment(seg_ops, start, needed, env, seed, device, amp):
    """One recompute segment under non-reentrant
    `torch.utils.checkpoint`: the forward keeps only what leaves the
    segment (`needed`); the backward runs the segment's ops again from
    its inputs, with the same op indices, so the same seeds (dropout's
    and the flash kernels' are stateless hashes of them) and the same
    AMP casts, and nothing drawn from a torch generator. It needs no
    host synchronization, so it runs inside a captured step, and the
    recomputed graph's gradients reach the views that the data-parallel
    exchange hooks."""

    def body(carry):
        e = dict(carry)
        _run_ops(seg_ops, e, seed, device, base_idx=start, amp=amp)
        return {n: e[n] for n in needed if n in e}

    # every op of the segment runs again (no early stop: it would
    # surface inside an op as an error)
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        return torch.utils.checkpoint.checkpoint(
            body, dict(env), use_reentrant=False, preserve_rng_state=False)


def _gradient_merge(env, gm, apply, post_ops, run_post, sync, plan=None):
    """k-step gradient accumulation (reference: `_run_gradient_merge`).
    Every step adds the fresh gradients into the float32 accumulators and
    advances the counter, (counter + 1) % k, on the device. `apply` (the
    host's choice: the counter's k-th step) then runs the post-backward
    section (`run_post`) once on the merged gradients (divided by k where
    `avg`; `sync` exchanges them over the data-parallel ring first, once
    a window), resets the accumulators, and takes back what the section
    wrote to vars that existed before it, as the reference's `lax.cond`
    does; otherwise the section does not run, and parameters, moments and
    the learning rate stay bit-equal. Under the sharded update a sharded
    state leaves as its shard and any other shard-space value gathers."""
    k = int(gm["k_steps"])
    avg = bool(gm.get("avg", True))
    acc_map = dict(gm["acc_map"])
    counter = gm["counter"]
    new_cnt = (env[counter] + 1) % k
    for g, acc in acc_map.items():
        env[acc] = env[acc] + env[g].to(env[acc].dtype)
    if apply:
        out_names, seen = [], set()
        for op in post_ops:
            for n in _op_reads_writes(op)[1]:
                if n in env and n not in seen:
                    out_names.append(n)
                    seen.add(n)
        out_names.extend(a for a in acc_map.values() if a not in seen)
        e = dict(env)
        merged = {g: e[acc] / k if avg else e[acc]
                  for g, acc in acc_map.items()}
        if sync is not None:
            merged = sync(merged)
        for g in acc_map:
            v = merged[g]
            e[g] = _su.ShardVal(v.vec.to(e[g].dtype), v.shape) \
                if isinstance(v, _su.ShardVal) else v.to(e[g].dtype)
        run_post(e)
        for acc in acc_map.values():
            e[acc] = torch.zeros_like(e[acc])
        for n in out_names:
            v = e[n]
            if plan is not None and isinstance(v, _su.ShardVal) \
                    and n not in plan.sharded_state:
                v = _su.gather_full(v, plan)
            env[n] = v
    env[counter] = new_cnt.to(env[counter].dtype)


def gradient_merge_attr(block) -> Optional[dict]:
    """The backward op's ``gradient_merge`` attr (GradientMergeOptimizer),
    or None."""
    for op in block.ops:
        if op.type == "backward":
            return op.attrs.get("gradient_merge")
    return None


def build_block_fn(program, block, feed_names, fetch_names,
                   state_in, state_out, device, ring=None, shard_plan=None,
                   gm_apply=False):
    """The function `fn(feeds, states, seed, keep=None) -> (fetches,
    new_states)` that runs `block` on `device`: feeds and states map
    names to tensors on it; `seed` is the run's `core.rng.StepSeed`;
    fetches are detached tensors in `fetch_names` order, new_states maps
    each name of `state_out` the block computed to its new tensor. A
    `keep` list gets every tensor the run bound to a name (what a
    captured graph must keep alive). With a `ring` (a data-parallel
    program's world) the ring is live while the block runs, and the
    gradients are averaged over it after the backward unless the program
    syncs them itself. With a `shard_plan` (a
    `parallel.sharded_update.ShardedUpdatePlan` on that ring) the update
    is sharded: the optimizer-bound gradients are reduce-scattered, the
    post-backward section runs in shard space, the plan's sharded state
    comes in and goes out as this rank's flat slices, and a fetched
    shard is gathered. Under gradient merge (the backward op's
    ``gradient_merge`` attr) the function is one of the two steps of a
    window: the accumulating one, or with `gm_apply` the one that applies
    the merged gradients (`_gradient_merge`); the exchange then runs
    there, once a window, on the merged gradients."""
    ops = list(block.ops)
    bwd_indices = [i for i, op in enumerate(ops) if op.type == "backward"]
    if len(bwd_indices) > 1:
        raise NotImplementedError("multiple backward sections in one block")
    bwd_idx = bwd_indices[0] if bwd_indices else None
    amp = _amp_trace_policy(program)
    dp_ring = ring if ring is not None and getattr(
        program, "_data_parallel", False) else None
    sync_ring = dp_ring if dp_ring is not None and dp_ring.size > 1 \
        else None
    bop = ops[bwd_idx] if bwd_idx is not None else None
    gm = bop.attrs.get("gradient_merge") if bop is not None else None
    explicit = _has_explicit_sync(ops, bwd_idx)
    # fleet's programs sum their own gradients after the backward: those
    # in-place sums move into the exchange (`_early_syncs`), the rest
    # stay ops; otherwise every gradient is averaged. Under gradient
    # merge the sums stay ops of the post-backward section, which runs
    # once a window on the merged gradients.
    early = _early_syncs(ops, bwd_idx) if explicit and gm is None else None
    skip = frozenset(early.values()) if early else frozenset()
    # the exchange starts inside the backward unless buckets are off
    hooks = (shard_plan.bucket_cap if shard_plan is not None
             else _su.bucket_cap_bytes()) > 0
    # the merged-gradient window owns the update's cadence, so loss
    # scaling never combines with it (the decorator warned)
    dls = bop.attrs.get("dynamic_loss_scaling") \
        if bop is not None and gm is None else None
    static_ls = bop.attrs.get("static_loss_scaling") \
        if bop is not None and gm is None else None
    if (dls is not None or static_ls) and early is not None:
        # fleet's transpiled program sums its gradients with ops after the
        # backward: a finite check here would see the local values and
        # the unscale would flush small gradients before the sum
        warnings.warn(
            "fp16 loss scaling is not wired for explicit-sync "
            "(fleet-transpiled) gradient programs; training "
            "proceeds UNSCALED — expect fp16 gradient "
            "underflow. Use bfloat16 (no scaling needed) or "
            "implicit DP sync.")
        dls = static_ls = None

    segments = None
    if bop is not None and bop.attrs.get("checkpoints"):
        live_out = set(fetch_names) | set(state_out) | {bop.attrs[
            "loss_name"]}
        for post_op in ops[bwd_idx + 1:]:
            live_out.update(_op_reads_writes(post_op)[0])
        segments = _remat_segments(ops[:bwd_idx],
                                   list(bop.attrs["checkpoints"]), live_out)

    def _run_forward(env, seed):
        if segments is None:
            _run_ops(ops[:bwd_idx], env, seed, device, amp=amp)
            return
        for start, stop, needed in segments:
            env.update(_run_segment(ops[start:stop], start, needed, env,
                                    seed, device, amp))

    def _merged_sync(merged):
        """The once-a-window exchange of the merged gradients ({grad var
        name: value}) over the ring, as the exchange of a step without
        gradient merge would run it (bucketed reduce-scatters under the
        sharded update, else all-reduces), launched after the
        backward."""
        gname = {framework.grad_var_name(n): n
                 for n in bop.attrs.get("diff_names", [])}
        by_diff = {gname[g]: v for g, v in merged.items() if g in gname}
        exchange = _GradExchange(
            _exchange_units(list(by_diff), bop.attrs.get("grad_topo", {})
                            or {}, sync_ring, shard_plan, True), {}, False)
        out = dict(merged)
        out.update(exchange.finish(by_diff))
        fn.overlap = {
            "collectives": exchange.records, "n_backward": 0,
            "n_buckets": len(shard_plan.buckets)
            if shard_plan is not None else 0,
            "launched_in_backward": False,
            "captured": device.type == "cuda"
            and torch.cuda.is_current_stream_capturing()}
        return out

    def _run_post(env, seed):
        if shard_plan is not None:
            _su.run_sharded_post_ops(ops[bwd_idx + 1:], env, seed,
                                     bwd_idx + 1, amp, shard_plan, block,
                                     device, skip)
        else:
            _run_ops(ops[bwd_idx + 1:], env, seed, device,
                     base_idx=bwd_idx + 1, amp=amp, skip=skip)

    def _backward_section(env, seed):
        loss_name = bop.attrs["loss_name"]
        loss_scale = bop.attrs.get("loss_scale", 1.0)
        diff_names = [n for n in bop.attrs.get("diff_names", [])
                      if n in env and _diffable(block, n, env)]
        leaves = {n: env[n].detach().requires_grad_(True)
                  for n in diff_names}
        exchange = None
        env.update(leaves)
        synced = diff_names if early is None else [
            n for n in diff_names if framework.grad_var_name(n) in early]
        if sync_ring is not None and synced and gm is None:
            # the forward reads each leaf through a view, whose gradient
            # hooks see it (hooks on the leaves of torch.autograd.grad
            # cannot tell an unused one)
            with torch.enable_grad():
                views = {n: leaves[n].view_as(leaves[n]) for n in synced}
            exchange = _GradExchange(
                _exchange_units(synced, bop.attrs.get("grad_topo", {})
                                or {}, sync_ring, shard_plan, early is None),
                views, hooks)
            env.update(views)
        with torch.enable_grad():
            _run_forward(env, seed)
            loss = env[loss_name]
            loss_sum = torch.sum(loss.to(torch.float32))
        amp_scale = None
        if dls is not None:
            # the live scale, read on the device at every step or replay
            amp_scale = env[dls["scale"]].reshape(()).to(torch.float32)
        elif static_ls:
            amp_scale = _full(loss_sum, float(static_ls), torch.float32)
        grads = [None] * len(diff_names)
        if diff_names and loss_sum.requires_grad:
            ct = torch.full_like(loss_sum, loss_scale)
            if amp_scale is not None:
                ct = ct * amp_scale
            grads = torch.autograd.grad(
                loss_sum, [leaves[n] for n in diff_names], grad_outputs=ct,
                allow_unused=True)
        # an unused diff var gets zeros, as jax.vjp gives
        grads = {n: torch.zeros_like(leaves[n]) if g is None
                 else g.to(leaves[n].dtype) for n, g in zip(diff_names, grads)}
        env.update((framework.grad_var_name(n), g)
                   for n, g in grads.items())
        if exchange is not None:
            env.update(exchange.finish(grads))
            fn.overlap = {
                "collectives": exchange.records,
                "n_backward": exchange.produced,
                "n_buckets": len(shard_plan.buckets)
                if shard_plan is not None else 0,
                "launched_in_backward": hooks,
                "captured": device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()}
        found_inf = None
        if dls is not None:
            # summed over the data-parallel ring even at one rank, so a
            # captured step holds the collective it runs at any world
            found_inf = _amp_found_inf(
                [env[framework.grad_var_name(n)] for n in diff_names],
                dp_ring)
        if amp_scale is not None:
            for n in diff_names:
                gn = framework.grad_var_name(n)
                env[gn] = _amp_unscale(env[gn], amp_scale)
        env[framework.grad_var_name(loss_name)] = torch.full(
            tuple(loss.shape), loss_scale, dtype=loss.dtype, device=device)
        if gm is not None:
            _gradient_merge(
                env, gm, gm_apply, ops[bwd_idx + 1:],
                lambda e: _run_post(e, seed),
                _merged_sync if sync_ring is not None and not explicit
                else None, shard_plan)
        elif dls is not None:
            _loss_scaled_post(lambda e: _run_post(e, seed), dls, env,
                              found_inf, shard_plan)
        else:
            _run_post(env, seed)

    def unshard(n, v):
        return _su.unwrap_out(n, v, shard_plan) if shard_plan is not None \
            else v

    def fn(feeds: Dict, states: Dict, seed: StepSeed, keep=None):
        env = {}
        env.update(states)
        env.update(feeds)
        if shard_plan is not None:
            _su.wrap_sharded_state(env, shard_plan)
        with torch.no_grad(), penv.collective_scope(ring):
            if bwd_idx is None:
                _run_ops(ops, env, seed, device, amp=amp)
            else:
                _backward_section(env, seed)
            fetches = []
            for n in fetch_names:
                if n not in env:
                    raise RuntimeError("fetch var %r was never computed"
                                       % n)
                v = env[n]
                if isinstance(v, _su.ShardVal):
                    v = _su.gather_full(v, shard_plan)
                fetches.append(v.detach())
            new_states = {n: unshard(n, env[n]).detach() for n in state_out
                          if n in env}
        if keep is not None:
            keep.extend(v.vec if isinstance(v, _su.ShardVal) else v
                        for v in env.values()
                        if isinstance(v, (torch.Tensor, _su.ShardVal)))
        return fetches, new_states

    #: the gradient exchange of the last run that had one (see
    #: `Executor.overlap_report`)
    fn.overlap = None
    return fn


# ---------------------------------------------------------------------------
# Compiled entries: the capture analysis, then warm -> capture -> replay.
# ---------------------------------------------------------------------------

#: control-flow ops that read their predicate or index on the host
_HOST_DECIDING = frozenset({"while", "cond", "conditional_block",
                            "switch_case"})


def capture_blocker(program, block, ring=None) -> Optional[str]:
    """Why `block` cannot be captured as a CUDA graph, or None (the
    counterpart of the reference's `_block_host_op_kinds`, decided from
    the program before any step). Looks through every sub-block. The
    reasons, each naming the first op that gives it: control flow that
    decides on the host, an op flagged `no_jit` or `dynamic_shape`, an
    initializer whose generator is seeded on the host; and a
    data-parallel block whose `ring` is a gloo group (NCCL collectives
    are captured with the block)."""
    reasons = {}
    if ring is not None and ring.backend == "gloo":
        reasons["gloo"] = ("data-parallel over %r: gloo collectives run "
                           "on the host" % (ring,))

    def scan(blk):
        for op in blk.ops:
            t = op.type
            where = "op %r (block %d)" % (t, blk.idx)
            if t in _HOST_DECIDING:
                reasons.setdefault(
                    "host control flow", "%s reads its predicate on the "
                    "host" % where)
            elif ops_lib.has_op(t):
                od = ops_lib.get_op(t)
                if od.no_jit:
                    reasons.setdefault("no_jit", "%s runs on the host "
                                       "(no_jit)" % where)
                if od.dynamic_shape:
                    reasons.setdefault(
                        "dynamic_shape", "%s has a value-dependent output "
                        "shape (dynamic_shape)" % where)
                if od.rng == "host":
                    reasons.setdefault(
                        "host rng", "%s draws from a generator seeded on "
                        "the host (an initializer)" % where)
            for bi in _sub_block_idxs(op):
                scan(block.program.block(bi))

    scan(block)
    return "; ".join(reasons.values()) or None


def entry_mode(program, block, device, ring=None, graph_runner=None):
    """(mode, reason) of `block`'s entry on `device`: ("graph", None), or
    ("eager", why): the CPU without a `graph_runner`, `FLAGS_cuda_graphs`
    off, or `capture_blocker`'s reason."""
    reason = None
    if graph_runner is None:
        if torch.device(device).type != "cuda":
            reason = "the CPU runs blocks eagerly (no CUDA graphs)"
        elif not get_flag("FLAGS_cuda_graphs", True):
            reason = "FLAGS_cuda_graphs is off"
    reason = reason or capture_blocker(program, block, ring)
    return ("eager" if reason else "graph"), reason


class CompiledBlock:
    """The executor's cache entry for one (program, block, feed shapes,
    fetches): the block's state analysis and function, run in `mode`
    "graph" (first run eager, second captured as a CUDA graph with the
    state donated, then replays) or "eager" (every run op by op), with
    `reason` saying why a block runs eagerly. See `compile_block`.

    Under gradient merge the entry holds two functions and, in graph
    mode, two captured steps over one set of static state buffers: the
    accumulating step and the applying one (a CUDA graph cannot branch
    on the device, where the reference uses `lax.cond`). The host picks
    one from its mirror of the window's counter, read from the scope at
    the first run and again whenever the scope's counter tensor is not
    the one the last run left there or was written since (a
    `fluid.load`, a checkpoint restore, a warmup on copies); both steps
    write the counter on the device, so saved state matches the
    reference's."""

    def __init__(self, program, block, feed_names, fetch_names, device,
                 graph_runner=None, ring=None):
        self.device = torch.device(device)
        self.state_in, self.state_out = analyze_block(
            block, list(feed_names), list(fetch_names))
        self.shard_plan = None
        if ring is not None and program._data_parallel:
            self.shard_plan = planner.plan_parallel(program, block,
                                                    ring).shard_plan
            program._shard_plan = self.shard_plan
        if self.shard_plan is not None:
            # a would-be-sharded state var must flow in and out of the
            # step; anything else keeps the replicated layout
            mut = set(self.state_in) & set(self.state_out)
            for n in list(self.shard_plan.sharded_state):
                if n not in mut:
                    del self.shard_plan.sharded_state[n]
        self.gm = gradient_merge_attr(block)
        self._fns = [build_block_fn(program, block, list(feed_names),
                                    list(fetch_names), self.state_in,
                                    self.state_out, self.device, ring,
                                    shard_plan=self.shard_plan,
                                    gm_apply=apply)
                     for apply in ((False, True) if self.gm is not None
                                   else (False,))]
        self.fn = self._fns[0]
        self.mode, self.reason = entry_mode(program, block, self.device,
                                            ring, graph_runner)
        buffers = {}
        self._steps = [None if self.reason else graphs.DonatedStep(
            fn, self.device, runner=graph_runner, buffers=buffers)
            for fn in self._fns]
        self._step = self._steps[0]
        # gradient merge: the host's mirror of the counter, and the
        # (tensor, version) the last run left in the scope
        self._gm_count = None
        self._gm_seen = None

    @property
    def phase(self) -> str:
        """"eager", or a graph entry's "cold", "warm" or "captured" (under
        gradient merge, of the step that ran last)."""
        return "eager" if self._step is None else self._step.phase

    def _gm_pick(self, states) -> int:
        """0 (accumulate) or 1 (apply) for the next step, from the host
        mirror of the counter, read again where the scope's counter is
        not what the last run left there."""
        t = states[self.gm["counter"]]
        seen = self._gm_seen
        if seen is None or t is not seen[0] or t._version != seen[1]:
            self._gm_count = int(t.reshape(-1)[0].item())
        return int((self._gm_count + 1) % int(self.gm["k_steps"]) == 0)

    def run(self, feeds, states, seed: int):
        """One step over `feeds` and the scope's current `states` (name
        -> tensor); `seed` the run's seed. Returns (fetches, new_states),
        the latter the tensors the scope should hold."""
        i = 0 if self.gm is None else self._gm_pick(states)
        self.fn, self._step = self._fns[i], self._steps[i]
        if self._step is None:
            out = self.fn(feeds, states,
                          StepSeed(seed, seed_tensor(seed, self.device)))
        else:
            out = self._step.step(feeds, states, seed)
        if self.gm is not None:
            t = out[1][self.gm["counter"]]
            self._gm_count = (self._gm_count + 1) % int(self.gm["k_steps"])
            self._gm_seen = (t, t._version)
        return out

    @property
    def overlap(self) -> Optional[dict]:
        """The gradient exchange of the entry's last eager run, or of its
        capture (which fixes what every replay launches when), or None
        before a run with one (see `_GradExchange`; under gradient merge,
        the applying step's exchange of the merged gradients)."""
        return self._fns[-1].overlap

    @staticmethod
    def _graph_info(step) -> dict:
        if step is None or not step.graph.captured:
            return {}
        g = step.graph
        return dict(capture_ms=g.capture_ms, pool_bytes=g.pool_bytes,
                    replays=g.replays, launches=dict(g.launches))

    def info(self) -> dict:
        """Mode, reason, phase, the optimizer state the step keeps
        sharded (`opt_state_sharded_vars`, and with any,
        `opt_state_logical_bytes`, what every rank would hold replicated,
        against `opt_state_per_replica_bytes`, what this rank holds: the
        keys of the reference's `Executor.donation_report`) and, once
        captured, the graph's capture ms, pool bytes, replays and
        wrapper-counted launches a replay (under gradient merge those of
        the step that ran last, and ``gradient_merge`` with k and each
        step's phase and graph)."""
        out = {"mode": self.mode, "reason": self.reason,
               "phase": self.phase}
        sharded = self.shard_plan.sharded_state if self.shard_plan \
            is not None else {}
        out["opt_state_sharded_vars"] = len(sharded)
        if sharded:
            ndev = self.shard_plan.ndev
            out["opt_state_logical_bytes"] = sum(
                i.numel * i.itemsize for i in sharded.values())
            out["opt_state_per_replica_bytes"] = sum(
                i.padded // ndev * i.itemsize for i in sharded.values())
            out["grad_buckets"] = len(self.shard_plan.buckets)
        out.update(self._graph_info(self._step))
        if self.gm is not None:
            out["gradient_merge"] = {
                "k_steps": int(self.gm["k_steps"]),
                "steps": [dict(kind=kind, phase="eager" if st is None
                               else st.phase, **self._graph_info(st))
                          for kind, st in zip(("accumulate", "apply"),
                                              self._steps)]}
        return out

    def release(self):
        """Drop the captured graphs and their static buffers."""
        for st in self._steps:
            if st is not None:
                st.release()


def compile_block(program, block, feed_names, fetch_names, device,
                  graph_runner=None, ring=None) -> CompiledBlock:
    """The compiled entry of `block` for these feeds and fetches on
    `device` (counterpart: the reference's `compile_block`, which jits
    the block with its state donated). Whether it will be captured is
    decided here, from the program; a block that will run eagerly is
    logged with its reason before its first step. `graph_runner` stands
    in for CUDA graph capture and replay on the CPU (tests only; see
    `core/graphs.py`); `ring` is a data-parallel program's world."""
    entry = CompiledBlock(program, block, feed_names, fetch_names, device,
                          graph_runner=graph_runner, ring=ring)
    if entry.mode == "eager" and entry.device.type == "cuda":
        _log.info("block %d of program %d runs eagerly: %s", block.idx,
                  program._uid, entry.reason)
    return entry
