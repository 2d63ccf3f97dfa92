"""The parity checks shared by the op test files of the book and
sequence slices (`tests/test_torch_nn_extra_ops.py`,
`test_torch_linalg_loss_ops.py`, `test_torch_rnn_ops.py`,
`test_torch_sequence_ops.py`, `test_torch_framework_ops.py`): the cases
of a case table (`tests/torch_nn_cases.py` unless `cases` names another
with its `CASES` and `inputs`, such as `tests/torch_seq_cases.py`)
through the reference's `get_op(t).compute` and the port's on the CPU.

`reference_results(names)` runs the reference once per case: its
forward and, where the case names float slots to differentiate, the
`jax.vjp` of every float output under one seeded cotangent; jitted, but
for a host-side (`no_jit`) type or one of `EAGER_REFERENCE`.
`check_case` holds the port against it: float32 outputs within rtol
1e-5 (atol 1e-6), integer and bool outputs exactly, each in the dtype a
var of the reference's dtype holds on the device; the gradients
(`torch.autograd.grad`) within the same tolerance. `check_infer` holds
`infer_outputs` with a -1 batch against the reference's."""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.ops import registry as rreg

from paddle_tpu_torch.core.types import normalize_dtype, to_torch_dtype
from paddle_tpu_torch.ops import registry as treg

import torch_nn_cases

RTOL, ATOL = 1e-5, 1e-6
#: float outputs that carry no gradient
NO_GRAD_OUTS = {"XShape"}


def _float_outs(outs):
    return sorted(s for s, v in outs.items()
                  if jnp.issubdtype(v[0].dtype, jnp.floating)
                  and s not in NO_GRAD_OUTS)


def _reference(op_type, ins, attrs):
    return rreg.normalize_outs(rreg.get_op(op_type).compute(ins, dict(attrs)))


#: types whose reference reads a value on the host for a shape, which it
#: does only outside jit, or whose jitted reference rounds otherwise
#: than its own op-by-op arithmetic (XLA fuses `bicubic_interp`'s cubic
#: weight polynomial; run op by op it is the port's bit for bit); the
#: others run jitted, one compile a case
EAGER_REFERENCE = {"bincount", "bicubic_interp"}


def reference_results(names, threads=4, cases=torch_nn_cases):
    """name -> (outputs, {slot: cotangent list}, {slot: gradient}), the
    cases spread over `threads` threads (XLA compiles outside the
    GIL)."""
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        return dict(zip(names, pool.map(
            lambda n: _reference_result(n, cases), names)))


def _reference_result(name, cases):
    """(outputs, {slot: cotangent list}, {slot: gradient}) of case
    `name`."""
    op_type, _, attrs, diff, _ = cases.CASES[name]
    ins = {s: [jnp.asarray(a) for a in v]
           for s, v in cases.inputs(name).items()}
    eager = op_type in EAGER_REFERENCE or rreg.get_op(op_type).no_jit

    def f(d):
        full = dict(ins)
        for s, v in d.items():
            full[s] = [v] + ins[s][1:]
        return _reference(op_type, full, attrs)

    d0 = {s: ins[s][0] for s in diff}
    if eager and not diff:
        return f(d0), {}, {}
    if eager:
        shapes = f(d0)
    else:
        shapes = jax.eval_shape(f, d0)
    floats = _float_outs(shapes) if diff else []
    cr = np.random.RandomState(99)
    cts = {s: [np.asarray(cr.randn(*v.shape), "float32")
               for v in shapes[s]] for s in floats}

    def both(d, ct):
        _, vjp = jax.vjp(lambda dd: {s: f(dd)[s] for s in floats}, d)
        return f(d), vjp(ct)[0]

    run = both if eager else jax.jit(both)
    fwd, grads = run(d0, {s: [jnp.asarray(c) for c in v]
                          for s, v in cts.items()})
    return fwd, cts, {s: np.asarray(g) for s, g in grads.items()}


def to_torch(a, grad=False):
    a = np.asarray(a)
    t = torch.as_tensor(a.copy(), dtype=to_torch_dtype(a.dtype))
    return t.requires_grad_(True) if grad else t


def port(op_type, ins, attrs):
    attrs = dict(attrs, _device=torch.device("cpu"))
    return treg.normalize_outs(treg.get_op(op_type).compute(ins, attrs))


def _assert_close(got, want, what, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    assert got.dtype == to_torch_dtype(normalize_dtype(want.dtype)), (
        what, got.dtype, want.dtype)
    got = got.detach().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def check_case(name, ref, cases=torch_nn_cases, rtol=RTOL, atol=ATOL):
    """The port's outputs and gradients of case `name` against the
    reference's results `ref` (one entry of `reference_results`), floats
    within `rtol` and `atol`."""
    op_type, _, attrs, diff, _ = cases.CASES[name]
    r_out, cts, r_grads = ref
    t_ins = {s: [to_torch(a, s in diff and i == 0) for i, a in enumerate(v)]
             for s, v in cases.inputs(name).items()}
    t_out = port(op_type, t_ins, attrs)
    assert sorted(t_out) == sorted(r_out)
    for slot in r_out:
        assert len(t_out[slot]) == len(r_out[slot]), slot
        for tv, rv in zip(t_out[slot], r_out[slot]):
            _assert_close(tv, rv, slot, rtol, atol)
    if not diff:
        return
    # a float output with no grad_fn (a comparison's) carries none
    pairs = [(t, torch.as_tensor(c)) for s in sorted(cts)
             for t, c in zip(t_out[s], cts[s]) if t.requires_grad]
    t_grads = torch.autograd.grad(
        [t for t, _ in pairs], [t_ins[s][0] for s in diff],
        grad_outputs=[c for _, c in pairs], allow_unused=True)
    for s, tg in zip(diff, t_grads):
        want = r_grads[s]
        got = np.zeros_like(want) if tg is None else tg.numpy()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg="d" + s)


def _specs(name, cases):
    slots = cases.CASES[name][4]
    return {s: [((-1,) + a.shape[1:] if s in slots else a.shape,
                 str(a.dtype)) for a in v]
            for s, v in cases.inputs(name).items()}


def check_infer(name, cases=torch_nn_cases):
    """`infer_outputs` of case `name`, its batch slots at -1, equal in
    shape and device dtype to the reference's."""
    op_type, _, attrs, _, _ = cases.CASES[name]
    specs = _specs(name, cases)
    got = treg.infer_outputs(op_type, specs, dict(attrs))
    want = rreg.infer_outputs(op_type, specs, dict(attrs))
    assert sorted(got) == sorted(want)
    for slot in want:
        for (ts, td), (rs, rd) in zip(got[slot], want[slot]):
            assert ts == rs, (slot, ts, rs)
            assert to_torch_dtype(td) == to_torch_dtype(rd), (slot, td, rd)


def check_flags(op_type):
    """The port's registry flags are the reference's."""
    r, t = rreg.get_op(op_type), treg.get_op(op_type)
    assert (t.no_jit, t.dynamic_shape) == (r.no_jit, r.dynamic_shape)
    assert (t.rng == "device") == r.needs_rng


def public_attrs(op):
    return {k: v for k, v in op.attrs.items() if not k.startswith("_")}


def assert_same_program(rmain, tmain):
    """The two programs' global blocks hold the same op types, public
    attrs and slots, op by op."""
    rops, tops = rmain.global_block().ops, tmain.global_block().ops
    assert [op.type for op in tops] == [op.type for op in rops]
    for r, t in zip(rops, tops):
        assert public_attrs(t) == public_attrs(r), t.type
        assert t.input_names == r.input_names, t.type
        assert t.output_names == r.output_names, t.type


def run_both(rfluid, tfluid, ref, port, feed, rtol=1e-5, atol=1e-6):
    """Builds (main, startup, fetch vars) with `ref` in the JAX package
    and `port` in the port, checks them op by op, runs the reference's
    startup, carries its persistables into the port's scope and runs
    both mains on `feed` on the CPU: the fetches equal within `rtol`
    (integers exactly). Returns (the port's fetches, the reference's)."""
    from paddle_tpu.core.scope import Scope as RScope
    from paddle_tpu_torch.core.scope import load_numpy_state

    rmain, rstartup, routs = ref
    tmain, _, touts = port
    assert_same_program(rmain, tmain)
    rexe, rscope = rfluid.Executor(rfluid.CPUPlace()), RScope()
    rexe.run(rstartup, scope=rscope)
    names = sorted(v.name for v in rmain.list_vars() if v.persistable)
    tscope = tfluid.Scope()
    load_numpy_state(tscope, {n: np.asarray(rscope.find_var(n))
                              for n in names}, "cpu")
    want = [np.asarray(w) for w in rexe.run(rmain, feed=feed,
                                            fetch_list=routs, scope=rscope)]
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=feed, fetch_list=touts, scope=tscope)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (touts[i].name, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=touts[i].name)
    return got, want
