"""The rest of the reference's tensor ops (`paddle_tpu/ops/tensor_ops.py`,
63 types), its random samplers and `seed` (`rng_ops.py`, 10), `pad` and
`pad2d` (`nn_ops.py`) and the `fluid.layers` functions that emit them,
in the port (paddle_tpu_torch, on the CPU) against the JAX package.

Deterministic types, table-driven as in `tests/test_torch_bert_ops.py`:
seeded numpy inputs through the reference's `get_op(t).compute` and the
port's; float32 outputs within rtol 1e-5 (atol 1e-6), integer, index and
bool outputs exactly, each dtype the one a var of the reference's dtype
holds on the device (64-bit narrowed, x64 off); the gradient of each
differentiable float input under one seeded cotangent (`jax.vjp` against
`torch.autograd.grad`) within 1e-5; `infer_outputs` with a -1 batch
equal to the reference's, for the types whose shape does not depend on
values read on the host. The random types (their streams differ from
JAX's by design) are held by shape and dtype against the reference's
draw, by their support and moments over 20,000 draws within the stated
bounds, and by their determinism: one device seed repeats its draws
bit for bit, another draws anew. A program of every new layer is built
in both packages: the same op types and attrs op by op, and the same
fetches. A block holding `range`, `where_index`, `masked_select`,
`unique` or `unique_with_counts` runs eagerly, naming the op and flag.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rfluid
from paddle_tpu.core.rng import make_key
from paddle_tpu.core.scope import Scope as RScope
from paddle_tpu.ops import registry as rreg

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.rng import seed_tensor
from paddle_tpu_torch.core.types import normalize_dtype, to_torch_dtype
from paddle_tpu_torch.fluid import lowering
from paddle_tpu_torch.ops import registry as treg

from torch_tensor_cases import CASES, RNG_CASES, inputs as _case_inputs

RTOL, ATOL = 1e-5, 1e-6
#: draws a moment test takes, and its bound in standard errors
N_DRAWS, N_SIGMA = 20000, 6.0


#: types whose output shape the reference reads from input values on the
#: host outside a no_jit flag (its eval_shape cannot trace them), and
#: `range`, whose zero-filled probe is a zero step
HOST_VALUE_SHAPES = {"crop_tensor", "linspace", "logspace", "range"}
#: float outputs that carry no gradient
NO_GRAD_OUTS = {"XShape"}

TENSOR_OPS_TYPES = {c[0] for c in CASES.values()} | set(RNG_CASES)


def test_cases_cover_the_slice():
    """63 tensor types, 10 random types and pad, pad2d; every one the
    reference registers and the port now does."""
    rt = set(rreg.registered_ops())
    assert TENSOR_OPS_TYPES <= rt and TENSOR_OPS_TYPES <= set(
        treg.registered_ops())
    by_file = {}
    for t in TENSOR_OPS_TYPES:
        mod = rreg.get_op(t).compute.__module__.rsplit(".", 1)[-1]
        by_file.setdefault(mod, set()).add(t)
    assert {k: len(v) for k, v in by_file.items()} == {
        "tensor_ops": 63, "rng_ops": 10, "nn_ops": 2}
    for t in TENSOR_OPS_TYPES:
        r, p = rreg.get_op(t), treg.get_op(t)
        assert (p.no_jit, p.dynamic_shape) == (r.no_jit, r.dynamic_shape), t
        assert (p.rng == "device") == (r.needs_rng and t != "seed"), t


def _inputs(name, cases=CASES):
    return _case_inputs(name, cases)


def _to_torch(a, grad=False):
    a = np.asarray(a)
    t = torch.as_tensor(a.copy(), dtype=to_torch_dtype(a.dtype))
    return t.requires_grad_(True) if grad else t


def _port(op_type, ins, attrs, seed=7):
    attrs = dict(attrs, _device=torch.device("cpu"),
                 _rng_seed=seed_tensor(seed, "cpu"),
                 _rng_generator=torch.Generator().manual_seed(seed))
    return treg.normalize_outs(treg.get_op(op_type).compute(ins, attrs))


def _reference(op_type, ins, attrs):
    attrs = dict(attrs)
    if rreg.get_op(op_type).needs_rng:
        attrs["_rng_key"] = make_key(0)
    return rreg.normalize_outs(rreg.get_op(op_type).compute(ins, attrs))


def _device_dtype(arr):
    """The torch dtype a var of `arr`'s dtype holds on the device."""
    return to_torch_dtype(normalize_dtype(np.asarray(arr).dtype))


@pytest.fixture(scope="module")
def reference_outputs():
    """name -> the reference's outputs of each deterministic case."""
    return {name: _reference(CASES[name][0], {
        s: [jnp.asarray(a) for a in v] for s, v in _inputs(name).items()},
        CASES[name][2]) for name in CASES}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_reference(name, reference_outputs):
    op_type, _, attrs, diff_slots, _ = CASES[name]
    ins = _inputs(name)
    r_out = reference_outputs[name]
    t_ins = {s: [_to_torch(a, s in diff_slots) for a in v]
             for s, v in ins.items()}
    t_out = _port(op_type, t_ins, attrs)
    assert sorted(r_out) == sorted(t_out)
    for slot in r_out:
        assert len(r_out[slot]) == len(t_out[slot]), slot
        for rv, tv in zip(r_out[slot], t_out[slot]):
            rv = np.asarray(rv)
            assert tv.dtype == _device_dtype(rv), (slot, tv.dtype, rv.dtype)
            tv = tv.detach().numpy()
            assert tv.shape == rv.shape, (slot, tv.shape, rv.shape)
            if np.issubdtype(rv.dtype, np.floating):
                np.testing.assert_allclose(tv, rv, rtol=RTOL, atol=ATOL,
                                           err_msg=slot)
            else:
                np.testing.assert_array_equal(tv, rv, err_msg=slot)
    if not diff_slots:
        return
    float_outs = sorted(s for s in r_out if np.issubdtype(
        np.asarray(r_out[s][0]).dtype, np.floating)
        and s not in NO_GRAD_OUTS)
    cr = np.random.RandomState(99)
    cts = {s: [cr.randn(*np.asarray(v).shape).astype("float32")
               for v in r_out[s]] for s in float_outs}

    def fwd(diff):
        full = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
        for s, v in diff.items():
            full[s] = [v] + full[s][1:]
        outs = _reference(op_type, full, attrs)
        return {s: outs[s] for s in float_outs}

    diff_in = {s: jnp.asarray(ins[s][0]) for s in diff_slots}
    _, vjp = jax.vjp(fwd, diff_in)
    r_grads = vjp({s: [jnp.asarray(c) for c in v]
                   for s, v in cts.items()})[0]
    outs = [t for s in float_outs for t in t_out[s]]
    t_grads = torch.autograd.grad(
        outs, [t_ins[s][0] for s in diff_slots],
        grad_outputs=[torch.as_tensor(c) for s in float_outs
                      for c in cts[s]], allow_unused=True)
    for s, tg in zip(diff_slots, t_grads):
        want = np.asarray(r_grads[s])
        got = np.zeros_like(want) if tg is None else tg.numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg="d" + s)


def _specs(name, cases=CASES, batch=True):
    batch_slots = cases[name][4] if batch else []
    return {s: [((-1,) + a.shape[1:] if s in batch_slots else a.shape,
                 str(a.dtype)) for a in v]
            for s, v in _inputs(name, cases).items()}


def _same_spec(t_spec, r_spec):
    """Equal shapes; dtypes equal as the device holds them."""
    assert sorted(t_spec) == sorted(r_spec)
    for slot in r_spec:
        for (ts, td), (rs, rd) in zip(t_spec[slot], r_spec[slot]):
            assert ts == rs, (slot, ts, rs)
            assert to_torch_dtype(td) == to_torch_dtype(rd), (slot, td, rd)


@pytest.mark.parametrize("name", sorted(
    n for n in CASES if CASES[n][0] not in HOST_VALUE_SHAPES))
def test_infer_outputs_matches_reference(name):
    op_type, _, attrs, _, _ = CASES[name]
    specs = _specs(name)
    _same_spec(treg.infer_outputs(op_type, specs, dict(attrs)),
               rreg.infer_outputs(op_type, specs, dict(attrs)))


def _rng_inputs(name):
    return _case_inputs(name, RNG_CASES)


@pytest.mark.parametrize("name", sorted(RNG_CASES))
def test_random_op_shape_dtype_and_repeat(name):
    """The reference's shapes and dtypes; one seed repeats, another
    draws anew (`seed` is host-side: its attr is its value)."""
    ins = _rng_inputs(name)
    attrs = RNG_CASES[name][1]
    ref = _reference(name, {s: [jnp.asarray(a) for a in v]
                            for s, v in ins.items()}, attrs)
    t_ins = {s: [_to_torch(a) for a in v] for s, v in ins.items()}
    a, b, c = (_port(name, t_ins, attrs, seed=s) for s in (7, 7, 8))
    assert sorted(a) == sorted(ref)
    for slot in ref:
        rv = np.asarray(ref[slot][0])
        assert a[slot][0].dtype == _device_dtype(rv), slot
        assert tuple(a[slot][0].shape) == rv.shape, slot
        assert torch.equal(a[slot][0], b[slot][0]), slot
        if name != "seed":
            assert not torch.equal(a[slot][0], c[slot][0]), slot
    _same_spec(treg.infer_outputs(name, _rng_specs(name), dict(attrs)),
               rreg.infer_outputs(name, _rng_specs(name), dict(attrs)))


def _rng_specs(name):
    return {s: [(a.shape, str(a.dtype)) for a in v]
            for s, v in _rng_inputs(name).items()}


def _draw(name, ins, attrs, seed=11):
    return _port(name, ins, attrs, seed=seed)["Out"][0]


def _mean_ok(x, mean, var, what):
    """The sample mean of `x` within N_SIGMA standard errors of `mean`."""
    se = np.sqrt(var / x.size)
    assert abs(x.mean() - mean) <= N_SIGMA * se + 1e-12, (
        what, x.mean(), mean, se)


def test_uniform_and_gaussian_batch_size_like_moments():
    ref = torch.zeros(N_DRAWS, 3)
    u = _draw("uniform_random_batch_size_like", {"Input": [ref]},
              {"shape": [-1, 1], "min": -2.0, "max": 3.0}).numpy()
    assert u.shape == (N_DRAWS, 1) and u.min() >= -2.0 and u.max() < 3.0
    _mean_ok(u, 0.5, 25.0 / 12.0, "uniform")
    g = _draw("gaussian_random_batch_size_like", {"Input": [ref]},
              {"shape": [-1, 1], "mean": 1.0, "std": 2.0}).numpy()
    _mean_ok(g, 1.0, 4.0, "gaussian")
    assert abs(g.std() - 2.0) <= 0.05


def test_bernoulli_exponential_poisson_moments():
    p = torch.tensor([0.05, 0.5, 0.9]).repeat(N_DRAWS, 1)
    b = _draw("bernoulli", {"X": [p]}, {}).numpy()
    assert set(np.unique(b)) <= {0.0, 1.0}
    for j, pj in enumerate((0.05, 0.5, 0.9)):
        _mean_ok(b[:, j], pj, pj * (1 - pj), "bernoulli")
    e = _draw("exponential", {"X": [torch.zeros(N_DRAWS)]},
              {"lambda": 2.0}).numpy()
    assert e.min() > 0
    _mean_ok(e, 0.5, 0.25, "exponential")
    rates = (0.5, 4.0, 9.9, 10.0, 30.0, 400.0)
    lam = torch.tensor(rates).repeat(N_DRAWS, 1)
    k = _draw("poisson", {"X": [lam]}, {}).numpy()
    assert (k >= 0).all() and (k == np.round(k)).all()
    for j, r in enumerate(rates):
        _mean_ok(k[:, j], r, r, "poisson %g" % r)
        # the variance of a Poisson draw is its rate
        assert abs(k[:, j].var() / r - 1.0) <= 0.06, (r, k[:, j].var())


def test_categorical_and_integer_draws():
    probs = torch.tensor([[0.1, 0.2, 0.7], [0.6, 0.0, 0.4]])
    m = _draw("multinomial", {"X": [probs]},
              {"num_samples": N_DRAWS}).numpy()
    assert m.shape == (2, N_DRAWS)
    for row in range(2):
        freq = np.bincount(m[row], minlength=3) / N_DRAWS
        np.testing.assert_allclose(freq, probs[row].numpy(), atol=0.015)
    assert not (m[1] == 1).any()
    s = _draw("sampling_id", {"X": [probs.repeat(N_DRAWS // 2, 1)
                                    .reshape(-1, 3)]}, {}).numpy()
    freq = np.bincount(s[0::2], minlength=3) / (N_DRAWS // 2)
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.7], atol=0.02)
    r = _draw("randint", {}, {"shape": [N_DRAWS], "low": -3,
                              "high": 7}).numpy()
    assert r.min() == -3 and r.max() == 6
    np.testing.assert_allclose(np.bincount(r + 3) / N_DRAWS, 0.1,
                               atol=0.012)
    perms = np.stack([_draw("randperm", {}, {"n": 6}, seed=s).numpy()
                      for s in range(600)])
    assert (np.sort(perms, axis=1) == np.arange(6)).all()
    # every value lands in every position about equally often
    for v in range(6):
        np.testing.assert_allclose((perms == v).mean(axis=0), 1 / 6,
                                   atol=0.07)


def test_gumbel_softmax_rows_and_hard():
    x = torch.tensor([[1.0, 2.0, 0.5]]).repeat(N_DRAWS, 1)
    y = _draw("gumbel_softmax", {"X": [x]}, {"temperature": 1.0})
    np.testing.assert_allclose(y.sum(-1).numpy(), 1.0, rtol=1e-5)
    xg = x.clone().requires_grad_(True)
    hard = _draw("gumbel_softmax", {"X": [xg]}, {"hard": True})
    # one-hot up to the rounding of onehot + y - y, as the reference's
    onehot = np.eye(3)[hard.detach().numpy().argmax(-1)]
    np.testing.assert_allclose(hard.detach().numpy(), onehot, atol=1e-6)
    # the argmax of logits + Gumbel noise is a draw of softmax(logits)
    freq = np.bincount(hard.detach().numpy().argmax(-1),
                       minlength=3) / N_DRAWS
    p = torch.softmax(x[0], -1).numpy()
    np.testing.assert_allclose(freq, p, atol=0.015)
    (g,) = torch.autograd.grad(hard[:, 0].sum(), xg)
    assert torch.isfinite(g).all() and g.abs().sum() > 0


def test_seed_op_is_host_side():
    op = treg.get_op("seed")
    assert op.no_jit and op.rng is None
    np.random.seed(3)
    a = _port("seed", {}, {"seed": 0})["Out"][0]
    np.random.seed(3)
    b = _port("seed", {}, {"seed": 0})["Out"][0]
    assert torch.equal(a, b) and a.dtype == torch.int32


# -- the layers ---------------------------------------------------------------

def _layers_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        x = L.data(name="x", shape=[4, 6], dtype="float32",
                   append_batch_size=False)
        y = L.data(name="y", shape=[4, 6], dtype="float32",
                   append_batch_size=False)
        idx = L.data(name="idx", shape=[3, 2], dtype="int64",
                     append_batch_size=False)
        img = L.data(name="img", shape=[1, 2, 3, 4], dtype="float32",
                     append_batch_size=False)
        v = L.data(name="v", shape=[4], dtype="float32",
                   append_batch_size=False)
        cnt = L.fill_constant([1], "float32", 2.0)
        L.increment(cnt, 3.0)
        sorted_x, order = L.argsort(x, axis=1, descending=True)
        gt = L.greater_than(x, y)
        outs = [
            L.argmax(x, axis=1), L.argmin(x, axis=0), sorted_x, order,
            L.concat([x, y], axis=1), L.diag(v), L.eye(3, 5),
            L.ones([2, 3], "float32"),
            L.ones_like(x), L.zeros([3], "int32"), L.zeros_like(y),
            L.reverse(x, [0, 1]), L.shape(img),
            L.tril(x, 1), L.triu(x, -1), L.expand_as(L.reshape(v, [4, 1]), x),
            L.flatten(img, axis=2), L.gather_nd(x, idx),
            L.strided_slice(x, [0, 1], [3, -1], [0, 0], [-2, -2]),
            L.pad(x, [1, 0, 0, 2], pad_value=0.25),
            L.pad2d(img, [1, 0, 2, 1], mode="reflect"),
            L.nn.logical_and(gt, L.less_than(x, y)),
            L.nn.logical_or(gt, L.less_than(x, y)),
            L.nn.logical_xor(gt, L.less_than(x, y)), L.nn.logical_not(gt),
            L.mul(x, L.transpose(y, [1, 0])), L.is_empty(x), cnt]
        outs += L.unstack(x, axis=0)
        shapes = [L.nn.uniform_random([3, 4], min=-0.5, max=0.5),
                  L.nn.gaussian_random([2, 5], mean=1.0, std=0.1)]
        t = L.create_tensor("float32", name="made")
        # their ops read the bounds on the host: the reference's jitted
        # block cannot run them (its `range` fails alone too)
        host = [L.linspace(0.0, 1.0, 5), L.range(0.0, 3.0, 0.5)]
    return main, outs, shapes, t, host


def _layers_feed():
    r = np.random.RandomState(4)
    return {"x": r.randn(4, 6).astype("float32"),
            "y": r.randn(4, 6).astype("float32"),
            "idx": r.randint(0, 4, (3, 2)).astype("int64"),
            "img": r.randn(1, 2, 3, 4).astype("float32"),
            "v": r.randn(4).astype("float32")}


def test_layers_match_reference():
    """Every new layer: the same op types and attrs in both programs,
    op by op, and the same fetches (the random layers by shape and
    dtype)."""
    feed = _layers_feed()
    rmain, routs, rshapes, rt, rhost = _layers_program(rfluid)
    tmain, touts, tshapes, tt, thost = _layers_program(tfluid)
    rops, tops = rmain.global_block().ops, tmain.global_block().ops
    assert [op.type for op in tops] == [op.type for op in rops]
    for r, t in zip(rops, tops):
        assert t.attrs == {k: v for k, v in r.attrs.items()
                           if not k.startswith("_")} or \
            {k: v for k, v in t.attrs.items() if not k.startswith("_")} == \
            {k: v for k, v in r.attrs.items() if not k.startswith("_")}, \
            (t.type, t.attrs, r.attrs)
        assert t.input_names == r.input_names, t.type
        assert t.output_names == r.output_names, t.type
    assert (tt.name, tt.persistable) == (rt.name, rt.persistable)
    hold = [op for op in rmain.global_block().ops
            if op.type not in ("linspace", "range")]
    rmain.global_block().ops[:] = hold
    rexe, scope = rfluid.Executor(rfluid.CPUPlace()), RScope()
    want = rexe.run(rmain, feed=feed, fetch_list=routs + rshapes,
                    scope=scope)
    texe = tfluid.Executor(tfluid.CPUPlace())
    got = texe.run(tmain, feed=feed, fetch_list=touts + tshapes + thost,
                   scope=tfluid.Scope())
    np.testing.assert_allclose(got[-2], np.linspace(0.0, 1.0, 5),
                               rtol=RTOL)
    np.testing.assert_array_equal(got[-1], np.arange(0.0, 3.0, 0.5))
    n = len(routs)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if i >= n:
            continue
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=str(i))
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(i))
    # the block holds `range` (no_jit) and host-seeded initializers
    assert texe.last_entry.mode == "eager"


@pytest.mark.parametrize("op_type,flag", [
    ("range", "no_jit"), ("where_index", "dynamic_shape"),
    ("masked_select", "dynamic_shape"), ("unique", "dynamic_shape"),
    ("unique_with_counts", "dynamic_shape")])
def test_host_ops_keep_their_block_eager(op_type, flag):
    """`capture_blocker` names the op and its flag, as for the
    reference's `_block_host_op_kinds`."""
    main = tfluid.Program()
    block = main.global_block()
    block.append_op(type=op_type, inputs={}, outputs={}, attrs={})
    reason = lowering.capture_blocker(main, block)
    assert "op %r" % op_type in reason and flag in reason


@pytest.mark.parametrize("op_type,slots,attrs", [
    ("linspace", ["Start", "Stop", "Num"], {}),
    ("logspace", ["Num"], {"start": 0.0, "stop": 1.0}),
    ("crop", ["X", "Offsets"], {"shape": [2, 2]}),
    ("crop_tensor", ["X", "Offsets"], {"shape": [2, 2]}),
])
def test_tensor_inputs_read_on_the_host_keep_their_block_eager(
        op_type, slots, attrs):
    """An op that reads a tensor input on the host (a CUDA graph cannot
    capture the read) keeps its block eager and is named; without that
    input (the attr instead) its block is captured."""
    main = tfluid.Program()
    block = main.global_block()
    ins = {s: [block.create_var(name=s.lower(), shape=[1], dtype="int32")]
           for s in slots}
    out = block.create_var(name="out", shape=[2, 2], dtype="float32")
    block.append_op(type=op_type, inputs=ins, outputs={"Out": [out]},
                    attrs=attrs)
    reason = lowering.capture_blocker(main, block)
    assert reason is not None and "op %r" % op_type in reason \
        and "on the host" in reason
    if op_type != "linspace":
        main = tfluid.Program()
        block = main.global_block()
        x = block.create_var(name="x", shape=[3, 3], dtype="float32")
        block.append_op(type=op_type, inputs={"X": [x]} if "X" in slots
                        else {}, outputs={"Out": [out]},
                        attrs=dict(attrs, num=3, offsets=[0, 1]))
        assert lowering.capture_blocker(main, block) is None
