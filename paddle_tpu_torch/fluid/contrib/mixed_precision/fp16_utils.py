"""AMP program rewrites (counterpart:
`paddle_tpu/fluid/contrib/mixed_precision/fp16_utils.py`).

The white/black-list casts are applied op by op as the block runs
(`fluid/lowering._apply_amp_casts`); this module makes the rewrites that
change the program's state: `rewrite_master_weights`, fp32 master
weights with 16-bit (bf16 or float16) live parameters, and
`wire_dynamic_loss_scaling`, float16's loss-scale state. In a
data-parallel program the sharded update keeps each rank's 1/N slice of
the masters (`parallel/sharded_update.py`, which finds them through
``program._amp_master_of`` and the ``__amp_param_cast__`` casts). The
fp8 tier is not ported (ROADMAP Queue 1 #10).
"""
from __future__ import annotations

from ...framework import grad_var_name, unique_name
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


def wire_dynamic_loss_scaling(program, startup_program, cfg):
    """Create the persistable loss-scale state (the scale, float32, and
    the good and bad step counters, int32; each [1], filled by the
    startup program) and attach the ``dynamic_loss_scaling`` attr to the
    backward op. The state rides the backward op's ``LossScaleState``
    input and output slots, so `lowering.analyze_block` threads it as
    scope state: it persists across steps and through `fluid.io` and
    checkpoints like any optimizer state. Returns the attr dict (None
    when the program has no backward section)."""
    block = program.global_block()
    bop = next((op for op in block.ops if op.type == "backward"), None)
    if bop is None:
        return None
    sb = startup_program.global_block() if startup_program is not None \
        else None

    def state(stem, dtype, value):
        v = block.create_var(name=unique_name(stem), shape=[1],
                             dtype=dtype, persistable=True)
        v.stop_gradient = True
        if sb is not None:
            sb.create_var(name=v.name, shape=[1], dtype=dtype,
                          persistable=True)
            sb.append_op(type="fill_constant", outputs={"Out": [v.name]},
                         attrs={"shape": [1], "dtype": dtype,
                                "value": float(value)})
        return v.name

    dls = {
        "scale": state("loss_scaling", "float32",
                       cfg["init_loss_scaling"]),
        "good": state("num_good_steps", "int32", 0),
        "bad": state("num_bad_steps", "int32", 0),
        "incr_every_n_steps": int(cfg["incr_every_n_steps"]),
        "decr_every_n_nan_or_inf": int(cfg["decr_every_n_nan_or_inf"]),
        "incr_ratio": float(cfg["incr_ratio"]),
        "decr_ratio": float(cfg["decr_ratio"]),
    }
    bop.attrs["dynamic_loss_scaling"] = dls
    extra = [dls["scale"], dls["good"], dls["bad"]]
    bop.input_names["LossScaleState"] = list(extra)
    bop.output_names["LossScaleState"] = list(extra)
    program._version += 1
    return dls
