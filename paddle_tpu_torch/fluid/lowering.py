"""Block execution: a Program block -> one Python function that runs its
ops op by op, and the compiled entry the executor keeps for it
(counterpart: `paddle_tpu/fluid/lowering.py`, its core with the
control-flow ops, the bf16 AMP cast policy and the data-parallel gradient
sync, without the sharding, sparse, fp8, gradient-merge and loss-scaling
branches).

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
(replacing the reference's `jax.vjp`).

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
their float32 inputs cast to the compute dtype (bf16) and its black-list
ops their bf16 inputs cast to float32, op by op as they run (the
reference applies the same casts while tracing).

Data parallelism (`CompiledProgram.with_data_parallel`, fleet): the
reference lowers a data-parallel block under `shard_map` over the mesh;
the port runs it as one rank of a `torch.distributed` world, its ring
live for the block's collective ops (`parallel/env.py`). Unless the
program syncs its gradients itself (fleet's `c_allreduce_sum` on the
`@GRAD` vars after the backward), every gradient is averaged over the
ring right after the backward, one all-reduce each, and not at all on a
ring of one (the reference's `_dp_pmean` and `_dp_sync_axes`). The port
has no dynamic loss scaling (bf16 needs none; float16 raises), so there
is no found-inf predicate to reduce across ranks. Gloo collectives run
on the host, so a data-parallel block over gloo runs eagerly; over NCCL
it is captured at one rank, and runs eagerly at more (captured at 4
ranks, the replays ran but their losses differed from an eager run's:
ROADMAP Queue 3).

Scope semantics: the function is pure over a name -> tensor environment.
Scope state (params, optimizer moments) enters as inputs and leaves as
outputs; an op that writes a var (ParamOut is Param) rebinds the name to
a new tensor and never changes the old one in place, so autograd's saved
tensors stay valid.
"""
from __future__ import annotations

import functools
import logging
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


def _run_ops(ops, env, seed, device, base_idx=0, amp=None):
    for i, op in enumerate(ops):
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


def build_block_fn(program, block, feed_names, fetch_names,
                   state_in, state_out, device, ring=None):
    """The function `fn(feeds, states, seed, keep=None) -> (fetches,
    new_states)` that runs `block` on `device`: feeds and states map
    names to tensors on it; `seed` is the run's `core.rng.StepSeed`;
    fetches are detached tensors in `fetch_names` order, new_states maps
    each name of `state_out` the block computed to its new tensor. A
    `keep` list gets every tensor the run bound to a name (what a
    captured graph must keep alive). With a `ring` (a data-parallel
    program's world) the ring is live while the block runs, and the
    gradients are averaged over it after the backward unless the program
    syncs them itself."""
    ops = list(block.ops)
    bwd_indices = [i for i, op in enumerate(ops) if op.type == "backward"]
    if len(bwd_indices) > 1:
        raise NotImplementedError("multiple backward sections in one block")
    bwd_idx = bwd_indices[0] if bwd_indices else None
    amp = _amp_trace_policy(program)
    sync_ring = ring if (
        ring is not None and ring.size > 1
        and getattr(program, "_data_parallel", False)
        and not _has_explicit_sync(ops, bwd_idx)) else None

    def _backward_section(env, seed):
        bop = ops[bwd_idx]
        loss_name = bop.attrs["loss_name"]
        loss_scale = bop.attrs.get("loss_scale", 1.0)
        diff_names = [n for n in bop.attrs.get("diff_names", [])
                      if n in env and _diffable(block, n, env)]
        leaves = {n: env[n].detach().requires_grad_(True)
                  for n in diff_names}
        env.update(leaves)
        with torch.enable_grad():
            _run_ops(ops[:bwd_idx], env, seed, device, amp=amp)
            loss = env[loss_name]
            loss_sum = torch.sum(loss.to(torch.float32))
        grads = [None] * len(diff_names)
        if diff_names and loss_sum.requires_grad:
            grads = torch.autograd.grad(
                loss_sum, [leaves[n] for n in diff_names],
                grad_outputs=torch.full_like(loss_sum, loss_scale),
                allow_unused=True)
        for n, g in zip(diff_names, grads):
            # an unused diff var gets zeros, as jax.vjp gives
            g = torch.zeros_like(leaves[n]) if g is None else g
            g = g.to(leaves[n].dtype)
            if sync_ring is not None:
                g = collective_ops.all_reduce_mean(g, sync_ring)
            env[framework.grad_var_name(n)] = g
        env[framework.grad_var_name(loss_name)] = torch.full(
            tuple(loss.shape), loss_scale, dtype=loss.dtype, device=device)
        _run_ops(ops[bwd_idx + 1:], env, seed, device, base_idx=bwd_idx + 1,
                 amp=amp)

    def fn(feeds: Dict, states: Dict, seed: StepSeed, keep=None):
        env = {}
        env.update(states)
        env.update(feeds)
        with torch.no_grad(), penv.collective_scope(ring):
            if bwd_idx is None:
                _run_ops(ops, env, seed, device, amp=amp)
            else:
                _backward_section(env, seed)
        fetches = []
        for n in fetch_names:
            if n not in env:
                raise RuntimeError("fetch var %r was never computed" % n)
            fetches.append(env[n].detach())
        new_states = {n: env[n].detach() for n in state_out if n in env}
        if keep is not None:
            keep.extend(v for v in env.values()
                        if isinstance(v, torch.Tensor))
        return fetches, new_states

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
    data-parallel block whose `ring` is a gloo group, or an NCCL group of
    more than one rank (its captured losses differed from an eager
    run's at 4 ranks; ROADMAP Queue 3)."""
    reasons = {}
    if ring is not None and ring.backend == "gloo":
        reasons["gloo"] = ("data-parallel over %r: gloo collectives run "
                           "on the host" % (ring,))
    elif ring is not None and ring.size > 1:
        reasons["nccl"] = ("data-parallel over %r: replays of captured "
                           "NCCL collectives across ranks are not safe yet "
                           "(ROADMAP Queue 3)" % (ring,))

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


class CompiledBlock:
    """The executor's cache entry for one (program, block, feed shapes,
    fetches): the block's state analysis and function, run in `mode`
    "graph" (first run eager, second captured as a CUDA graph with the
    state donated, then replays) or "eager" (every run op by op), with
    `reason` saying why a block runs eagerly. See `compile_block`."""

    def __init__(self, program, block, feed_names, fetch_names, device,
                 graph_runner=None, ring=None):
        self.device = torch.device(device)
        self.state_in, self.state_out = analyze_block(
            block, list(feed_names), list(fetch_names))
        self.fn = build_block_fn(program, block, list(feed_names),
                                 list(fetch_names), self.state_in,
                                 self.state_out, self.device, ring)
        reason = None
        if graph_runner is None:
            if self.device.type != "cuda":
                reason = "the CPU runs blocks eagerly (no CUDA graphs)"
            elif not get_flag("FLAGS_cuda_graphs", True):
                reason = "FLAGS_cuda_graphs is off"
        self.reason = reason or capture_blocker(program, block, ring)
        self.mode = "eager" if self.reason else "graph"
        self._step = None if self.reason else graphs.DonatedStep(
            self.fn, self.device, runner=graph_runner)

    @property
    def phase(self) -> str:
        """"eager", or a graph entry's "cold", "warm" or "captured"."""
        return "eager" if self._step is None else self._step.phase

    def run(self, feeds, states, seed: int):
        """One step over `feeds` and the scope's current `states` (name
        -> tensor); `seed` the run's seed. Returns (fetches, new_states),
        the latter the tensors the scope should hold."""
        if self._step is None:
            return self.fn(feeds, states,
                           StepSeed(seed, seed_tensor(seed, self.device)))
        return self._step.step(feeds, states, seed)

    def info(self) -> dict:
        """Mode, reason, phase and, once captured, the graph's capture
        ms, pool bytes, replays and wrapper-counted launches a replay."""
        out = {"mode": self.mode, "reason": self.reason,
               "phase": self.phase}
        if self._step is not None and self._step.graph.captured:
            g = self._step.graph
            out.update(capture_ms=g.capture_ms, pool_bytes=g.pool_bytes,
                       replays=g.replays, launches=dict(g.launches))
        return out

    def release(self):
        """Drop the captured graph and its static buffers."""
        if self._step is not None:
            self._step.release()


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
