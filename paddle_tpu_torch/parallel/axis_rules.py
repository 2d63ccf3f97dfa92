"""Logical-axis rules: named parameter axes resolved to mesh axes
(counterpart: `paddle_tpu/parallel/axis_rules.py`, the port's own copy).

The t5x idiom: a parameter carries *logical* axis names, ``('embed',
'mlp')`` for an FC weight, ``('vocab', 'embed')`` for an embedding
table, and a rules table maps each logical name to a mesh axis (or None,
replicate). The trainer asks the rules instead of hard-coding which dim
of which weight shards over which axis.

* `AxisNames`: a tuple of logical names, one per tensor dim (the
  reference also registers it as a JAX pytree leaf; the port's trees are
  plain dicts and need no registration).
* `DEFAULT_RULES`: the Megatron column-parallel assignment over the
  "model" axis.
* `logical_to_mesh_axes`: names -> a spec, one mesh axis (or None) per
  dim, as a tuple (the reference's ``PartitionSpec``).
* `logical_axes_for_param`: the logical names of a fluid parameter from
  the op that consumes it.

The reference's `with_sharding_constraint` is a trace-time GSPMD hint
for `jax.jit`; the port places nothing by annotation (each process holds
its own shard), so it has no counterpart here.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

__all__ = [
    "AxisNames", "LogicalAxisRules", "MODEL_AXIS", "DEFAULT_RULES",
    "default_rules", "logical_to_mesh_axes", "mesh_dim_for",
    "logical_axes_for_param",
]

#: rules table type: sequence of (logical_axis_name, mesh_axis_or_None).
LogicalAxisRules = Sequence[Tuple[str, Optional[str]]]

#: the tensor-parallel axis of the fluid planner's mesh
MODEL_AXIS = "model"


class AxisNames(tuple):
    """Tuple of logical axis names, one per tensor dim."""

    def __new__(cls, *names):
        return tuple.__new__(cls, names)

    def __repr__(self):
        return "AxisNames%s" % (tuple.__repr__(self),)


#: the column-parallel assignment: every eligible weight shards its
#: OUTPUT dim over `model` and keeps its contraction dim replicated, so
#: each output element's dot product stays whole on one device and the
#: only model-axis collective is the Megatron all-reduce assembling the
#: output columns.  `vocab` shards so the embedding table splits rows.
DEFAULT_RULES: LogicalAxisRules = (
    ("batch", None),        # data dims never shard over model
    ("seq", None),
    ("embed", None),        # contraction dim of fc/matmul — replicate
    ("mlp", MODEL_AXIS),        # ffn hidden (fc out dim)
    ("heads", MODEL_AXIS),      # attention heads (QKV out dim)
    ("kv", None),           # per-head depth — rides with `heads`
    ("joined_kv", MODEL_AXIS),  # fused heads*kv projection dim
    ("vocab", MODEL_AXIS),      # embedding rows / logits dim
)


def default_rules() -> LogicalAxisRules:
    """The active rules table."""
    return DEFAULT_RULES


def mesh_dim_for(logical_name, rules=None):
    """Mesh axis assigned to one logical axis name, or None."""
    for name, mesh_axis in (rules if rules is not None
                            else default_rules()):
        if name == logical_name:
            return mesh_axis
    return None


def logical_to_mesh_axes(axis_names, rules=None) -> tuple:
    """Resolve per-dim logical names to a spec: a tuple with one mesh
    axis name (or None) per dim; ``()`` for None.

    A logical name missing from the rules (or mapped to None) replicates
    that dim.  Raises if two dims resolve to the same mesh axis."""
    if axis_names is None:
        return ()
    resolved = tuple(mesh_dim_for(n, rules) for n in axis_names)
    used = [a for a in resolved if a is not None]
    if len(used) != len(set(used)):
        raise ValueError(
            "logical axes %r resolve to a duplicate mesh axis via %r"
            % (tuple(axis_names), tuple(rules or default_rules())))
    return resolved


# fluid programs carry no flax-style param metadata, so the planner
# infers logical names from how an op consumes the param.  op_type ->
# {input slot: AxisNames for a 2-D weight}.
_CONSUMER_AXES = {
    "mul": {"Y": AxisNames("embed", "mlp")},
    "matmul": {"Y": AxisNames("embed", "mlp")},
    "matmul_v2": {"Y": AxisNames("embed", "mlp")},
    "lookup_table": {"W": AxisNames("vocab", "embed")},
    "lookup_table_v2": {"W": AxisNames("vocab", "embed")},
    "embedding": {"W": AxisNames("vocab", "embed")},
}


def logical_axes_for_param(op_type, slot, ndim=2):
    """Logical axis names a param plays when `op_type` consumes it at
    input `slot`, or None when that consumption has no TP rule."""
    names = _CONSUMER_AXES.get(op_type, {}).get(slot)
    if names is None or len(names) != ndim:
        return None
    return names
