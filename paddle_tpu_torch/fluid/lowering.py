"""Block execution: a Program block -> one Python function that runs its
ops eagerly, op by op (counterpart: `paddle_tpu/fluid/lowering.py`, its
core with the `scan` loop and the bf16 AMP cast policy, without the
data-parallel, sharding, sparse, fp8, gradient-merge and loss-scaling
branches and the other control flow).

The reference traces the op list into one jitted XLA computation; the
port issues each op's torch compute function in order on the executor's
device. `torch.compile` and CUDA graphs are for a later slice.

Autodiff: `append_backward` plants a single `backward` pseudo-op. The
function runs the forward segment on leaf tensors that require grad,
then takes `torch.autograd.grad` of the loss and binds each `X@GRAD`
(replacing the reference's `jax.vjp`).

`scan` (`layers.Scan`) runs its sub-block once per iteration over
per-layer slices of stacked [n, ...] inputs, taken with one `unbind` each
(so autograd stacks their gradients once), with its iteration var (if
the body asked for one) bound to the index as an int32 [1] tensor on the
device; with `remat` each iteration runs under
`torch.utils.checkpoint`. Random ops get a generator seeded
from (the run's seed, op index); inside a scan the seed is folded with
the scan op's index and the iteration first, as the reference folds its
key, so every layer draws its own dropout mask and a recomputed
iteration draws the same one.

AMP (`fluid.contrib.mixed_precision`): the program's white-list ops get
their float32 inputs cast to the compute dtype (bf16) and its black-list
ops their bf16 inputs cast to float32, op by op as they run (the
reference applies the same casts while tracing).

Scope semantics: the function is pure over a name -> tensor environment.
Scope state (params, optimizer moments) enters as inputs and leaves as
outputs; an op that writes a var (ParamOut is Param) rebinds the name to
a new tensor and never changes the old one in place, so autograd's saved
tensors stay valid.
"""
from __future__ import annotations

import functools
from typing import Dict, List

import torch
import torch.utils.checkpoint

from . import framework
from .. import ops as ops_lib
from ..core.errors import NotFoundError, attach_op_callstack
from ..core.rng import make_generator, op_seed
from ..core.types import to_torch_dtype

# Ops that exist only for runtime bookkeeping in the reference
_SKIP_OPS = frozenset({"feed", "fetch", "nop"})


def _op_reads_writes(op):
    """(reads, writes) of an op, looking through a control-flow op's
    sub-block (a var read only inside a scan body is still block-level
    state). Sub-block writes to persistable vars also count as reads:
    the carry needs their incoming value."""
    reads = list(op.input_arg_names)
    writes = list(op.output_arg_names)
    if "sub_block" not in op.attrs:
        return reads, writes
    blk = op.block.program.block(op.attrs["sub_block"])
    # the scan's slices and its iteration var are made by the loop itself
    produced_local = set(op.attrs.get("xs_slice", []))
    if op.attrs.get("iter_var"):
        produced_local.add(op.attrs["iter_var"])
    for sop in blk.ops:
        sr, sw = _op_reads_writes(sop)
        reads.extend(n for n in sr if n not in produced_local)
        for n in sw:
            v = blk._find_var_recursive(n)
            if v is not None and v.persistable and n not in produced_local:
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
    if t == "scan":
        return _exec_scan(op, env, seed, op_idx, device, amp)
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
    if opdef.needs_rng:
        attrs["_rng_seed"] = op_seed(seed, op_idx)
        attrs["_rng_generator"] = make_generator(seed, op_idx, device)
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
    base = op_seed(seed, op_idx)
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
        _run_ops(sub.ops, e, op_seed(base, it), device, amp=amp)
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


def build_block_fn(program, block, feed_names, fetch_names,
                   state_in, state_out, device):
    """The function `fn(feeds, states, seed) -> (fetches, new_states)`
    that runs `block` on `device`: feeds and states map names to
    tensors on it; fetches are detached tensors in `fetch_names` order,
    new_states maps each name of `state_out` the block computed to its
    new tensor."""
    ops = list(block.ops)
    bwd_indices = [i for i, op in enumerate(ops) if op.type == "backward"]
    if len(bwd_indices) > 1:
        raise NotImplementedError("multiple backward sections in one block")
    bwd_idx = bwd_indices[0] if bwd_indices else None
    amp = _amp_trace_policy(program)

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
            env[framework.grad_var_name(n)] = g.to(leaves[n].dtype)
        env[framework.grad_var_name(loss_name)] = torch.full(
            tuple(loss.shape), loss_scale, dtype=loss.dtype, device=device)
        _run_ops(ops[bwd_idx + 1:], env, seed, device, base_idx=bwd_idx + 1,
                 amp=amp)

    def fn(feeds: Dict, states: Dict, seed):
        env = {}
        env.update(states)
        env.update(feeds)
        with torch.no_grad():
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
        return fetches, new_states

    return fn
