"""Block execution: a Program block -> one Python function that runs its
ops eagerly, op by op (counterpart: `paddle_tpu/fluid/lowering.py`, its
core without the AMP, data-parallel, sharding, sparse, fp8,
gradient-merge and loss-scaling branches).

The reference traces the op list into one jitted XLA computation; the
port issues each op's torch compute function in order on the executor's
device. `torch.compile` and CUDA graphs are for a later slice.

Autodiff: `append_backward` plants a single `backward` pseudo-op. The
function runs the forward segment on leaf tensors that require grad,
then takes `torch.autograd.grad` of the loss and binds each `X@GRAD`
(replacing the reference's `jax.vjp`).

Scope semantics: the function is pure over a name -> tensor environment.
Scope state (params, optimizer moments) enters as inputs and leaves as
outputs; an op that writes a var (ParamOut is Param) rebinds the name to
a new tensor and never changes the old one in place, so autograd's saved
tensors stay valid.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from . import framework
from .. import ops as ops_lib
from ..core.errors import NotFoundError, attach_op_callstack
from ..core.rng import make_generator

# Ops that exist only for runtime bookkeeping in the reference
_SKIP_OPS = frozenset({"feed", "fetch", "nop"})


def _op_reads_writes(op):
    """(reads, writes) of an op. Control-flow sub-blocks, which the
    reference looks through, are not ported yet."""
    return list(op.input_arg_names), list(op.output_arg_names)


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


def _exec_op(op, env, seed, op_idx, device):
    t = op.type
    if t in _SKIP_OPS:
        return
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
    attrs = dict(op.attrs)
    attrs["_device"] = device
    if opdef.needs_rng:
        attrs["_rng_generator"] = make_generator(seed, op_idx, device)
    try:
        outs = ops_lib.normalize_outs(opdef.compute(ins, attrs))
    except Exception as e:  # noqa: BLE001 - attach the op's creation site
        attach_op_callstack(e, op)
    for slot, names in op.output_names.items():
        for n, v in zip(names, outs.get(slot, [])):
            env[n] = v


def _run_ops(ops, env, seed, device, base_idx=0):
    for i, op in enumerate(ops):
        _exec_op(op, env, seed, base_idx + i, device)


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
            _run_ops(ops[:bwd_idx], env, seed, device)
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
        _run_ops(ops[bwd_idx + 1:], env, seed, device, base_idx=bwd_idx + 1)

    def fn(feeds: Dict, states: Dict, seed):
        env = {}
        env.update(states)
        env.update(feeds)
        with torch.no_grad():
            if bwd_idx is None:
                _run_ops(ops, env, seed, device)
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
