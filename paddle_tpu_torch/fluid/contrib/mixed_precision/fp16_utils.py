"""AMP program rewrites (counterpart:
`paddle_tpu/fluid/contrib/mixed_precision/fp16_utils.py`).

The white/black-list casts are applied op by op as the block runs
(`fluid/lowering._apply_amp_casts`); this module makes the rewrite that
changes the program's state: `rewrite_master_weights`, fp32 master
weights with bf16 live parameters. In a data-parallel program the
sharded update keeps each rank's 1/N slice of the masters
(`parallel/sharded_update.py`, which finds them through
``program._amp_master_of`` and the ``__amp_param_cast__`` casts).
Dynamic loss scaling (fp16) and the fp8 tier are not ported.
"""
from __future__ import annotations

from ...framework import grad_var_name
from ....core.types import normalize_dtype

MASTER_SUFFIX = "@MASTER"


def master_name(param_name: str) -> str:
    return param_name + MASTER_SUFFIX


def rewrite_master_weights(program, startup_program, compute_dtype):
    """Rewire every optimizer op's Param/ParamOut to an fp32 master var,
    flip the live params (and their grads) to `compute_dtype`, and
    append one ``cast`` op per param re-deriving the live value from the
    updated master. Returns {param_name: master_name}.

    Startup: the initializer op still fills the exact fp32 init value;
    the master is assigned from it before the live param is cast down,
    so the master starts equal to a run without AMP's param and the live
    param is its 16-bit cast.
    """
    compute_dtype = normalize_dtype(compute_dtype)
    block = program.global_block()
    bwd_idx = next((i for i, op in enumerate(block.ops)
                    if op.type == "backward"), None)
    post = block.ops[bwd_idx + 1:] if bwd_idx is not None else block.ops

    master_of = {}
    for op in post:
        params = op.input_names.get("Param", [])
        pouts = op.output_names.get("ParamOut", [])
        if not params or not pouts:
            continue
        for i, p in enumerate(params):
            if p.endswith(MASTER_SUFFIX):
                continue
            v = block._find_var_recursive(p)
            if v is None or str(v.dtype) != "float32" \
                    or not getattr(v, "persistable", False):
                continue
            m = master_of.get(p)
            if m is None:
                m = _create_master(program, startup_program, v,
                                   compute_dtype)
                master_of[p] = m
            op.input_names["Param"][i] = m
            for j, po in enumerate(op.output_names["ParamOut"]):
                if po == p:
                    op.output_names["ParamOut"][j] = m

    # one trailing cast per param: the live 16-bit value from the
    # updated fp32 master
    for p, m in master_of.items():
        block.append_op(
            type="cast", inputs={"X": [m]}, outputs={"Out": [p]},
            attrs={"in_dtype": "float32", "out_dtype": str(compute_dtype),
                   "__amp_param_cast__": True})
    if master_of:
        program._version += 1
    return master_of


def _create_master(program, startup_program, v, compute_dtype):
    block = program.global_block()
    m = master_name(v.name)
    mv = block.create_var(name=m, shape=list(v.shape), dtype="float32",
                          persistable=True)
    mv.stop_gradient = True
    if startup_program is not None:
        sb = startup_program.global_block()
        if sb.has_var(v.name):
            sb.create_var(name=m, shape=list(v.shape), dtype="float32",
                          persistable=True)
            # master = the exact fp32 init; then the live param becomes
            # its 16-bit cast (order matters: assign reads fp32)
            sb.append_op(type="assign", inputs={"X": [v.name]},
                         outputs={"Out": [m]})
            sb.append_op(
                type="cast", inputs={"X": [v.name]},
                outputs={"Out": [v.name]},
                attrs={"in_dtype": "float32",
                       "out_dtype": str(compute_dtype),
                       "__amp_param_cast__": True})
    # the live param and its grad take the compute dtype: the backward
    # binds each gradient at its param's dtype, so grads are 16-bit too
    v.dtype = compute_dtype
    g = block._find_var_recursive(grad_var_name(v.name))
    if g is not None:
        g.dtype = compute_dtype
    return m
