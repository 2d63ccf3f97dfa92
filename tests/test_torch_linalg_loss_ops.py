"""The reference's `linalg_ops` (22 types) and `loss_ops` (18) in the port
(paddle_tpu_torch, on the CPU) against the JAX package, table-driven as
`tests/test_torch_nn_extra_ops.py` (the cases of
`tests/torch_nn_cases.py`): outputs and gradients within fp32 rtol
1e-5, integer outputs exactly, `infer_outputs` with a -1 batch equal.
`bincount` reads max(X) on the host, so a block holding it runs eagerly
and names the op; `histogram` takes its range from the data on the
device, so its block is captured."""
import numpy as np
import pytest
import torch

from paddle_tpu.ops import registry as rreg

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import lowering

import torch_case_parity as parity
from torch_nn_cases import CASES, cases_of

NAMES = cases_of("linalg_ops", "loss_ops")
TYPES = sorted({CASES[n][0] for n in NAMES})


@pytest.fixture(scope="module")
def reference():
    return parity.reference_results(NAMES)


def test_cases_cover_linalg_and_loss_ops():
    by_file = {}
    for t in rreg.registered_ops():
        mod = rreg.get_op(t).compute.__module__.rsplit(".", 1)[-1]
        by_file.setdefault(mod, set()).add(t)
    assert by_file["linalg_ops"] | by_file["loss_ops"] == set(TYPES)
    assert (len(by_file["linalg_ops"]), len(by_file["loss_ops"])) == (22, 18)
    assert set(TYPES) <= set(parity.treg.registered_ops())


@pytest.mark.parametrize("name", NAMES)
def test_op_matches_reference(name, reference):
    parity.check_case(name, reference[name])


@pytest.mark.parametrize("name", NAMES)
def test_infer_outputs_matches_reference(name):
    parity.check_infer(name)


@pytest.mark.parametrize("op_type", TYPES)
def test_flags_match_the_reference(op_type):
    parity.check_flags(op_type)


def test_bincount_length_follows_the_data():
    """The length is max(minlength, 1, max(X) + 1)."""
    x = torch.tensor([0, 7, 2, 7], dtype=torch.int32)
    for minlength, n in ((0, 8), (3, 8), (11, 11)):
        out = parity.port("bincount", {"X": [x]},
                          {"minlength": minlength})["Out"][0]
        assert out.shape == (n,) and out.dtype == torch.int32
        assert out[7] == 2 and int(out.sum()) == 4


def _one_op_program(op, inputs, attrs):
    main = tfluid.Program()
    block = main.global_block()
    ins = {s: [block.create_var(name=s.lower(), shape=[6],
                                dtype="int64" if op == "bincount"
                                else "float32")]
           for s in inputs}
    out = block.create_var(name="out", shape=[6], dtype="int64")
    block.append_op(type=op, inputs=ins, outputs={"Out": [out]},
                    attrs=attrs)
    return main


def test_bincount_block_runs_eagerly_histogram_block_does_not():
    main = _one_op_program("bincount", ["X"], {"minlength": 2})
    why = lowering.capture_blocker(main, main.global_block())
    assert why is not None and "'bincount'" in why and "host" in why
    entry = lowering.compile_block(main, main.global_block(), ["x"], ["out"],
                                   "cpu", graph_runner=lambda body: body())
    assert entry.mode == "eager" and entry.reason == why
    main = _one_op_program("histogram", ["X"], {"bins": 4})
    assert lowering.capture_blocker(main, main.global_block()) is None


def test_histogram_range_from_the_data():
    """With min = max = 0 the bins span the data; the maximum lands in
    the last bin; a constant input widens its range by 0.5 each side."""
    x = torch.tensor([0.0, 1.0, 2.0, 3.0, 4.0])
    out = parity.port("histogram", {"X": [x]}, {"bins": 4})["Out"][0]
    assert out.tolist() == [1, 1, 1, 2]
    out = parity.port("histogram", {"X": [torch.full((3,), 2.0)]},
                      {"bins": 2})["Out"][0]
    assert out.tolist() == [0, 3]
    np.testing.assert_array_equal(
        parity.port("histogram", {"X": [x]}, {"bins": 2, "min": 1,
                                              "max": 3})["Out"][0], [1, 2])


@pytest.mark.parametrize("op_type,slot,attrs,matrix", [
    ("cholesky", "X", {}, [[1.0, 2.0], [2.0, 1.0]]),
    ("cholesky", "X", {"upper": True}, [[0.0, 0.0], [0.0, 0.0]]),
    ("inverse", "Input", {}, [[1.0, 2.0], [2.0, 4.0]]),
    ("inverse", "Input", {}, [[0.0, 0.0], [0.0, 0.0]]),
    ("matrix_power", "X", {"n": -2}, [[1.0, 2.0], [2.0, 4.0]]),
])
def test_failed_factorizations_match_the_reference(op_type, slot, attrs,
                                                   matrix):
    """A matrix that is not positive definite, or singular, gives the
    reference's non-finite values (NaN below the diagonal of a failed
    Cholesky factor) and raises nothing."""
    import jax.numpy as jnp

    a = np.asarray(matrix, "float32")
    got = parity.port(op_type, {slot: [torch.tensor(a)]}, attrs)
    want = parity._reference(op_type, {slot: [jnp.asarray(a)]}, attrs)
    for s in want:
        np.testing.assert_array_equal(got[s][0].numpy(),
                                      np.asarray(want[s][0]), err_msg=s)


def _affine_grid_program(attrs):
    main = tfluid.Program()
    block = main.global_block()
    theta = block.create_var(name="theta", shape=[2, 2, 3], dtype="float32")
    shape = block.create_var(name="shape", shape=[4], dtype="int32")
    out = block.create_var(name="out", shape=[2, 4, 5, 2], dtype="float32")
    block.append_op(type="affine_grid", inputs={"Theta": [theta],
                                                "OutputShape": [shape]},
                    outputs={"Output": [out]}, attrs=attrs)
    return main


def test_affine_grid_output_shape_tensor_runs_eagerly():
    """affine_grid reads its OutputShape tensor on the host only where
    the `output_shape` attr is absent; only then is its block eager."""
    main = _affine_grid_program({})
    why = lowering.capture_blocker(main, main.global_block())
    assert why is not None and "'affine_grid'" in why \
        and "OutputShape" in why
    main = _affine_grid_program({"output_shape": [2, 1, 4, 5]})
    assert lowering.capture_blocker(main, main.global_block()) is None


def test_histogram_bins_in_the_input_dtype():
    """float64 X is binned in float64: values that float32 rounds to
    one number still fall in their own bins; counts are int32."""
    x = torch.tensor([1.0, 1.0 + 1e-10, 1.0 + 2e-10, 1.0 + 3e-10],
                     dtype=torch.float64)
    out = parity.port("histogram", {"X": [x]}, {"bins": 3})["Out"][0]
    assert out.dtype == torch.int32 and out.tolist() == [1, 1, 2]


@pytest.mark.parametrize("shape,dim", [((3, 7), 1), ((4, 5, 6), 0),
                                       ((2, 33), -1)])
def test_cumprod_gradient_through_zeros(shape, dim):
    """With zeros in X, cumprod's gradient (summed on the device, with
    no host check for zeros) is the reference's `jax.vjp`."""
    import jax
    import jax.numpy as jnp

    r = np.random.RandomState(5)
    x = r.uniform(0.5, 1.5, shape).astype("float32")
    x[r.rand(*shape) < 0.25] = 0.0
    g = r.randn(*shape).astype("float32")
    xt = torch.tensor(x, requires_grad=True)
    out = parity.port("cumprod", {"X": [xt]}, {"dim": dim})["Out"][0]
    got = torch.autograd.grad(out, xt, torch.tensor(g))[0]
    _, vjp = jax.vjp(lambda v: parity._reference(
        "cumprod", {"X": [v]}, {"dim": dim})["Out"][0], jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(
        jnp.asarray(g))[0]), rtol=parity.RTOL, atol=parity.ATOL)
