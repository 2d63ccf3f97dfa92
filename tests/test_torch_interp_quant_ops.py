"""The reference's `interp_ops` (5 types) and `quant_ops` (11) in the port
(paddle_tpu_torch, on the CPU) against the JAX package.

Table-driven (`tests/torch_det_quant_cases.py`, checked by
`tests/torch_case_parity.py`): each case's reference runs once in a
module fixture (forward and `jax.vjp` under one seeded cotangent; the
bicubic cases op by op, since XLA's fused cubic weights round otherwise
than the reference's own arithmetic); the port's outputs within fp32
rtol 1e-5 (integer outputs exactly), its gradients likewise,
`infer_outputs` with a -1 batch equal to the reference's, and the
registry flags equal. Every interpolation type is held in both layouts,
with `align_corners` and both `align_mode`s, at output sizes of 1,
upscaling and downscaling. The quant types are held tighter: on equal
inputs `Out`, the scales and the window equal the reference's op-by-op
results bit for bit, and the straight-through gradient is the identity;
`fake_quantize_range_abs_max` runs 13 steps over a window of 4 with its
state carried, bit for bit. The interpolation layers of `fluid.layers`
build the reference's program op by op and run it to the same values."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rfluid
from paddle_tpu.ops import registry as rreg

import paddle_tpu_torch.fluid as tfluid

import torch_case_parity as parity
import torch_det_quant_cases as dq

INTERP = dq.cases_of("interp_ops")
QUANT = dq.cases_of("quant_ops")
NAMES = INTERP + QUANT
TYPES = sorted({dq.CASES[n][0] for n in NAMES})


@pytest.fixture(scope="module")
def reference():
    return parity.reference_results(NAMES, cases=dq)


def test_cases_cover_the_two_modules():
    """Every type the reference's interp_ops and quant_ops register has
    a case; the port registers them all."""
    mods = {"paddle_tpu.ops.interp_ops", "paddle_tpu.ops.quant_ops"}
    ref = {t for t in rreg.registered_ops()
           if rreg.get_op(t).compute.__module__ in mods}
    assert set(TYPES) == ref and len(TYPES) == 5 + 11
    assert ref <= set(parity.treg.registered_ops())


@pytest.mark.parametrize("name", NAMES)
def test_op_matches_reference(name, reference):
    parity.check_case(name, reference[name], cases=dq)


@pytest.mark.parametrize("name", NAMES)
def test_infer_outputs_matches_reference(name):
    parity.check_infer(name, cases=dq)


@pytest.mark.parametrize("op_type", TYPES)
def test_flags_match_the_reference(op_type):
    parity.check_flags(op_type)


@pytest.mark.parametrize("name", QUANT)
def test_quant_outputs_bit_equal(name):
    """Out, OutScale and OutScales equal the reference's op-by-op results
    bit for bit (jitted, XLA turns a division by the scale into a
    multiplication by its reciprocal, which moves some cells by an ulp:
    the rtol 1e-5 test above holds those), and where X is
    differentiated, d(sum Out)/dX is ones on both sides."""
    op, _, attrs, diff, _ = dq.CASES[name]
    ins = dq.inputs(name)
    got = parity.port(op, {s: [parity.to_torch(a) for a in v]
                           for s, v in ins.items()}, attrs)
    want = rreg.normalize_outs(rreg.get_op(op).compute(
        {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
        dict(attrs)))
    for slot in want:
        np.testing.assert_array_equal(got[slot][0].detach().numpy(),
                                      np.asarray(want[slot][0]),
                                      err_msg=slot)
    if diff:
        xt = parity.to_torch(ins["X"][0], True)
        out = parity.port(op, dict(
            {s: [parity.to_torch(a) for a in v] for s, v in ins.items()},
            X=[xt]), attrs)["Out"][0]
        (g,) = torch.autograd.grad(out.sum(), [xt])
        np.testing.assert_array_equal(g.numpy(), np.ones_like(ins["X"][0]))


def test_range_abs_max_window_over_many_steps():
    """13 steps of `fake_quantize_range_abs_max` over a window of 4, the
    scale, window and Iter carried from step to step (the window wraps
    three times and evicts its maximum): Out, OutScale and OutScales
    bit-equal to the reference's at every step."""
    r = np.random.RandomState(4)
    window = 4
    scale = np.zeros(1, "float32")
    scales = np.zeros(window, "float32")
    t_state = [torch.tensor(scale), torch.tensor(scales)]
    r_state = [jnp.asarray(scale), jnp.asarray(scales)]
    for it in range(13):
        big = it in (1, 6)
        x = (r.randn(5, 3) * (3.0 if big else 0.5)).astype("float32")
        it_a = np.asarray([it], "int64")
        want = rreg.get_op("fake_quantize_range_abs_max").compute(
            {"X": [jnp.asarray(x)], "InScale": [r_state[0]],
             "Iter": [jnp.asarray(it_a)], "InScales": [r_state[1]]},
            {"window_size": window, "bit_length": 8})
        got = parity.port("fake_quantize_range_abs_max", {
            "X": [torch.tensor(x)], "InScale": [t_state[0]],
            "Iter": [torch.tensor(it_a)], "InScales": [t_state[1]]},
            {"window_size": window, "bit_length": 8})
        for slot in ("Out", "OutScale", "OutScales"):
            np.testing.assert_array_equal(got[slot][0].numpy(),
                                          np.asarray(want[slot]),
                                          err_msg="%s step %d" % (slot, it))
        t_state = [got["OutScale"][0], got["OutScales"][0]]
        r_state = [want["OutScale"], want["OutScales"]]
    # both big batches have left the window
    assert float(t_state[0][0]) < 2.0


def test_ste_differs_from_q():
    """`x + (q - x)` is not `q` in float32 where the clip moves a cell
    far (a static scale below |x|): the port's forward is the
    reference's expression, so those cells agree too."""
    r = np.random.RandomState(0)
    x = (r.randn(4096) * 7.0).astype("float32")
    attrs = {"bit_length": 8, "static_scale": 1.3}
    out = parity.port("fake_quantize_abs_max", {"X": [torch.tensor(x)]},
                      attrs)["Out"][0].numpy()
    s = np.float32(1.3)
    q = (np.clip(np.round(x / s * np.float32(127)), -127, 127) * s
         / np.float32(127)).astype("float32")
    want = np.asarray(rreg.get_op("fake_quantize_abs_max").compute(
        {"X": [jnp.asarray(x)]}, attrs)["Out"])
    np.testing.assert_array_equal(out, want)
    assert (out != q).sum() > 100


def _resize_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        x = L.data(name="x", shape=[3, 6, 8], dtype="float32")
        v = L.data(name="v", shape=[2, 3, 4, 5], dtype="float32")
        w = L.data(name="w", shape=[3, 7], dtype="float32")
        outs = [L.resize_bilinear(x, out_shape=[9, 5], align_corners=False,
                                  align_mode=0),
                L.resize_bicubic(x, scale=1.5),
                L.interpolate(x, scale=2.0, resample="NEAREST"),
                L.image_resize_short(x, 4),
                L.resize_trilinear(v, out_shape=[4, 2, 6]),
                L.resize_linear(w, out_shape=[11], align_corners=False),
                L.interpolate(L.transpose(x, [0, 2, 3, 1]), out_shape=[4, 4],
                              data_format="NHWC")]
    return main, startup, outs


def test_resize_layers_build_and_run_the_reference_program():
    r = np.random.RandomState(3)
    feed = {"x": r.randn(2, 3, 6, 8).astype("float32"),
            "v": r.randn(2, 2, 3, 4, 5).astype("float32"),
            "w": r.randn(2, 3, 7).astype("float32")}
    got, _ = parity.run_both(rfluid, tfluid, _resize_program(rfluid),
                             _resize_program(tfluid), feed)
    assert [g.shape for g in got] == [
        (2, 3, 9, 5), (2, 3, 9, 12), (2, 3, 12, 16), (2, 3, 4, 5),
        (2, 2, 4, 2, 6), (2, 3, 11), (2, 4, 4, 3)]


def _nearest_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        x = L.data(name="x", shape=[3, 5, 7], dtype="float32")
        outs = [L.image_resize(x, out_shape=[9, 4]),
                L.resize_nearest(x, scale=2),
                L.image_resize(x, scale=1.5)]
    return main, startup, outs


def test_image_resize_and_resize_nearest_are_the_reference():
    """`fluid.layers.image_resize` and its alias `resize_nearest` emit
    the reference's `interp_nearest` ops (`out_h`, `out_w`; a scale of
    1.5 truncated to 7 x 10) and fetch its values exactly."""
    import paddle_tpu_torch.fluid.layers as tlayers

    assert tlayers.resize_nearest is tlayers.image_resize
    feed = {"x": np.random.RandomState(4).randn(2, 3, 5, 7).astype(
        "float32")}
    got, _ = parity.run_both(rfluid, tfluid, _nearest_program(rfluid),
                             _nearest_program(tfluid), feed, rtol=0,
                             atol=0)
    assert [g.shape for g in got] == [(2, 3, 9, 4), (2, 3, 10, 14),
                                      (2, 3, 7, 10)]
    ops = _nearest_program(tfluid)[0].global_block().ops
    assert [(op.type, op.attrs["out_h"], op.attrs["out_w"]) for op in ops] \
        == [("interp_nearest", 9, 4), ("interp_nearest", 10, 14),
            ("interp_nearest", 7, 10)]
