"""Coalesced optimizer updates (counterpart:
`paddle_tpu/fluid/fuse_optimizer.py`): a program rewrite in which groups
of same-configured `sgd`, `momentum` or `adam` ops collapse into one
`fused_sgd`, `fused_momentum` or `fused_adam` op (`ops/optimizer_ops.py`).
The update arithmetic is the same, elementwise; each parameter keeps its
own beta powers. On the card the fused op issues `torch._foreach_*`
kernels over the whole group instead of several kernels a parameter.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from . import lowering

# op type -> (input slots to coalesce, output slots produced per member)
_FUSABLE: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    "sgd": (("Param", "Grad"), ("ParamOut",)),
    "momentum": (("Param", "Grad", "Velocity"),
                 ("ParamOut", "VelocityOut")),
    "adam": (("Param", "Grad", "Moment1", "Moment2", "Beta1Pow",
              "Beta2Pow"),
             ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
              "Beta2PowOut")),
}


def _attr_sig(op):
    return tuple(sorted(
        (k, repr(v)) for k, v in op.attrs.items()
        if not k.startswith("_") and k != "op_callstack"))


def fuse_optimizer_ops(program) -> int:
    """Fuse groups of same-configured optimizer ops (same type, attrs,
    learning-rate var and param dtype) in the global block, each into one
    op planted at the group's last member. Returns the number of ops
    fused away. Idempotent (marks the program)."""
    if getattr(program, "_opt_fused", False):
        return 0
    block = program.global_block()
    ops = list(block.ops)
    rw = [tuple(map(set, lowering._op_reads_writes(op))) for op in ops]

    groups: Dict[tuple, List[int]] = {}
    for i, op in enumerate(ops):
        if op.type not in _FUSABLE:
            continue
        in_slots, _ = _FUSABLE[op.type]
        if any(len(op.input_names.get(s, [])) != 1 for s in in_slots):
            continue
        lr = op.input_names.get("LearningRate", [""])
        pvar = block._find_var_recursive(op.input_names["Param"][0])
        dtype = str(getattr(pvar, "dtype", "float32"))
        key = (op.type, _attr_sig(op), lr[0], dtype)
        groups.setdefault(key, []).append(i)

    fused_away = 0
    to_remove = set()
    insert_at = {}
    for key, idxs in groups.items():
        if len(idxs) < 2:
            continue
        op_type, _, lr_name, _ = key
        in_slots, out_slots = _FUSABLE[op_type]
        members = [ops[i] for i in idxs]
        written, member_reads = set(), set()
        for m in members:
            for names in m.output_names.values():
                written.update(names)
            for names in m.input_names.values():
                member_reads.update(names)
        # ops between the members may neither touch the group's outputs
        # nor write one of its inputs: the fused op runs at the last
        # member's place
        member_idx = set(idxs)
        if any((rw[j][0] | rw[j][1]) & written or rw[j][1] & member_reads
               for j in range(min(idxs), max(idxs) + 1)
               if j not in member_idx):
            continue
        inputs = {slot: [block._find_var_recursive(m.input_names[slot][0])
                         for m in members] for slot in in_slots}
        if lr_name:
            inputs["LearningRate"] = [block._find_var_recursive(lr_name)]
        outputs = {slot: [block._find_var_recursive(
            m.output_names[slot][0]) for m in members]
            for slot in out_slots}
        attrs = {k: v for k, v in members[0].attrs.items()
                 if not k.startswith("_")}
        insert_at[max(idxs)] = ("fused_" + op_type, inputs, outputs, attrs)
        to_remove.update(idxs)
        fused_away += len(members) - 1

    program._opt_fused = True
    if not insert_at:
        return 0
    new_ops = []
    for i, op in enumerate(ops):
        if i in insert_at:
            t, ins_, outs_, attrs_ = insert_at[i]
            new_ops.append(block.append_op(type=t, inputs=ins_,
                                           outputs=outs_, attrs=attrs_))
            block.ops.pop()  # append_op put it at the tail
        elif i not in to_remove:
            new_ops.append(op)
    block.ops = new_ops
    program._version += 1
    return fused_away
