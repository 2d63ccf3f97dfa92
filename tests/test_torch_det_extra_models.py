"""The two detectors of the detection slice in the port (paddle_tpu_torch,
on the CPU) against the JAX package, built once for both by
`tests/torch_detection_programs.py`: the tiny Mask R-CNN R50-FPN
(`TINY_MASK_RCNN`: one block a stage, widths / 16, 64 x 96, 5 classes,
the samplers' sizes scaled down) and the tiny SSD MobileNet-v1
(`TINY_SSD`: widths / 8, 96 x 96, 5 classes).

Both start from one state (the port's startup's, carried into the
reference's scope). The training and evaluation programs are the
reference's op by op. The first step's losses agree within `DET_TOL`
(Mask R-CNN's five within 1e-4, SSD's within 1e-5) and its gradients
within DET_TOL of their largest |value|: Mask R-CNN's FPN, RPN, box and
mask heads (1e-3; measured 2e-6), SSD's heads (5e-4; measured 9e-5, and
2.8e-4 card against CPU) and its first
convolution within 5e-2 only (measured 1.1e-2: batch norm over one image
normalizes the extra blocks' 2 x 2 and 1 x 1 maps, 4 and 1 values a
channel, which scales the roundings up on the way back).

The reference cannot differentiate a program whose host op reads a value
computed from the parameters: Mask R-CNN's `generate_proposals` reads the
RPN's outputs, and the reference's `pure_callback` has no JVP; and it
runs a block holding a dynamic-shape host op unjitted, which compiles
every op of a step on its own (70 s for the tiny Mask R-CNN's first
step). Paddle's host ops have no gradient, and the port's read their
inputs to the host, so the test runs the reference's host ops as
callbacks on `lax.stop_gradient` of their inputs, with the output shapes
the port's step gave, in one jitted block (ROADMAP Queue 3,
reference-side). Every host op still runs the reference's own numpy, and
a shape of the port's that the reference's op does not give fails the
callback.

Each host op of the first step is then the reference's op on the same
inputs, exactly (`rpn_target_assign`, `generate_proposals`,
`collect_fpn_proposals`, `generate_proposal_labels`,
`distribute_fpn_proposals`, `generate_mask_labels`, `bipartite_match`),
and the evaluation's `multiclass_nms` and `detection_map` too, on the
port's own decoded boxes and scores; the mAP is a number in [0, 1]. The
recorded reference outputs of the input-exact host ops
(`HOST_OUTPUT_DIGESTS`, which the card must give) are the reference's.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu.fluid as rfluid
from paddle_tpu.core.scope import Scope as RScope
from paddle_tpu.fluid import lowering as rlowering
from paddle_tpu.ops import registry as rreg

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.types import to_numpy

import torch_case_parity as parity
import torch_det_extra_cases as dx
import torch_detection_programs as dp

TOL = dp.DET_TOL
MASK_GRADS = dp.DET_GRADS["mask_rcnn"]
SSD_GRADS = dp.DET_GRADS["ssd"]
#: SSD's first convolution, through the batch-1 norms (module docstring)
SSD_DEEP = dp.SSD_DEEP


@contextlib.contextmanager
def _reference_host_ops(shapes):
    """The reference's block jitted with its host ops as callbacks on
    the values of their inputs (no gradient through them, as in Paddle),
    each output of the shape and dtype `shapes` gives its var (the
    port's, module docstring)."""
    inner = rlowering._block_host_op_kinds

    def host_op(opdef, op, ins, attrs):
        slots = sorted(ins)
        flat = [jax.lax.stop_gradient(v) for s in slots for v in ins[s]]
        outs = sorted(op.output_names.items())
        spec = [jax.ShapeDtypeStruct(*shapes[n]) for _, vs in outs
                for n in vs]

        def run(*vals):
            it = iter(vals)
            got = rreg.normalize_outs(opdef.compute(
                {s: [np.asarray(next(it)) for _ in ins[s]] for s in slots},
                dict(attrs)))
            flat_out = [v for s, _ in outs for v in got[s]]
            return tuple(np.asarray(v).astype(t.dtype)
                         for v, t in zip(flat_out, spec))

        res = iter(jax.pure_callback(run, tuple(spec), *flat))
        return {s: [next(res) for _ in vs] for s, vs in outs}

    host = rlowering._host_callback_op
    rlowering._host_callback_op = host_op
    rlowering._block_host_op_kinds = lambda block: (inner(block)[0], False)
    try:
        yield
    finally:
        rlowering._host_callback_op = host
        rlowering._block_host_op_kinds = inner


def _host_outputs(program, types):
    """(op type, {slot: [var names]}, {slot: [var names]}, public attrs)
    of each op of `types` in the program's forward, in order."""
    return [(op.type, dict(op.input_names), dict(op.output_names),
             parity.public_attrs(op))
            for op in program.global_block().ops
            if op.type in types and not op.attrs.get("_is_backward")]


def _prepare(builder, size, grads):
    """Both packages' programs from one state and the first step's
    feed and fetch list: (ref, port, feed, fetch, host ops, the port's
    executor and scope, the reference's scope)."""
    ref, port = builder(rfluid, **size), builder(tfluid, **size)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(port.startup, scope=tscope)
    rscope = RScope()
    for v in ref.main.list_vars():
        if v.persistable:
            rscope.set_var(v.name, jnp.asarray(to_numpy(
                tscope.find_var(v.name))))
    host = _host_outputs(port.main, port.host_ops)
    names = sorted({n for _, ins, outs, _ in host
                    for d in (ins, outs) for vs in d.values() for n in vs})
    fetch = port.fetch + [g + "@GRAD" for g in grads] + names
    return (ref, port, port.feed(np.random.RandomState(0)), fetch, host,
            texe, tscope, rscope)


@pytest.fixture(scope="module")
def runs():
    """model -> (ref, port, the reference's first-step fetches, the
    port's, the host ops, their tensors in the port, the port's executor
    and scope)."""
    out = {}
    for model, builder, size, grads in (
            ("mask_rcnn", dp.mask_rcnn_fpn, dp.TINY_MASK_RCNN, MASK_GRADS),
            ("ssd", dp.ssd_mobilenet_v1, dp.TINY_SSD,
             SSD_GRADS + [SSD_DEEP[0]])):
        ref, port, feed, fetch, host, texe, tscope, rscope = _prepare(
            builder, size, grads)
        got = texe.run(port.main, feed=feed, fetch_list=fetch, scope=tscope)
        n = len(port.fetch) + len(grads)
        vals = dict(zip(fetch[n:], got[n:]))
        with _reference_host_ops({k: (v.shape, v.dtype)
                                  for k, v in vals.items()}):
            want = rfluid.Executor(rfluid.CPUPlace()).run(
                ref.main, feed=feed, fetch_list=ref.fetch + fetch[len(
                    port.fetch):n], scope=rscope)
        out[model] = (ref, port, [np.asarray(w) for w in want], got[:n],
                      host, vals, texe, tscope)
    return out


@pytest.fixture(scope="module")
def mask_rcnn(runs):
    return runs["mask_rcnn"]


@pytest.fixture(scope="module")
def ssd(runs):
    return runs["ssd"]


@pytest.mark.parametrize("model", ["mask_rcnn", "ssd"])
def test_programs_are_the_reference(model, request):
    ref, port = request.getfixturevalue(model)[:2]
    parity.assert_same_program(ref.main, port.main)
    parity.assert_same_program(ref.test, port.test)
    types = {op.type for op in port.main.global_block().ops}
    assert set(port.host_ops) <= types


def test_mask_rcnn_program_runs_the_slice(mask_rcnn):
    """Mask R-CNN's programs carry the slice's types: the repaired
    `resize_nearest` (FPN's top-down path), the proposal and label host
    ops, `roi_align`, `box_decoder_and_assign` and `detection_map`."""
    port = mask_rcnn[1]
    train = [op.type for op in port.main.global_block().ops]
    test = {op.type for op in port.test.global_block().ops}
    assert train.count("interp_nearest") == 3
    assert train.count("generate_proposals") == 5
    assert train.count("distribute_fpn_proposals") == 2
    assert {"affine_channel", "roi_align", "anchor_generator",
            "sigmoid_cross_entropy_with_logits"} <= set(train)
    assert {"box_decoder_and_assign", "multiclass_nms",
            "detection_map"} <= test


@pytest.mark.parametrize("model,loss_tol,grad_tol", [
    ("mask_rcnn", TOL["mask_loss"], TOL["mask_grads"]),
    ("ssd", TOL["ssd_loss"], TOL["ssd_grads"])])
def test_first_step_matches(model, loss_tol, grad_tol, request):
    """The first step's losses, then each fetched gradient within
    `grad_tol` of its largest |value| (module docstring)."""
    ref, port, want, got = request.getfixturevalue(model)[:4]
    k = len(port.fetch)
    for g, w in zip(got[:k], want[:k]):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=loss_tol)
    names = (MASK_GRADS if model == "mask_rcnn"
             else SSD_GRADS + [SSD_DEEP[0]])
    for name, g, w in zip(names, got[k:], want[k:]):
        tol = SSD_DEEP[1] if name == SSD_DEEP[0] else grad_tol
        assert g.shape == w.shape and np.abs(w).max() > 0, name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("model", ["mask_rcnn", "ssd"])
def test_host_ops_are_the_reference(model, request):
    """Each host op of the first step, on the inputs the port gave it,
    equals the reference's op exactly; the input-exact ones equal their
    recorded outputs (`HOST_OUTPUT_DIGESTS`)."""
    _, port, _, _, host, vals = request.getfixturevalue(model)[:6]
    seen = set()
    for op_type, ins, outs, attrs in host:
        want = rreg.normalize_outs(rreg.get_op(op_type).compute(
            {s: [np.asarray(vals[n]) for n in vs] for s, vs in ins.items()},
            dict(attrs)))
        for s, vs in outs.items():
            for n, w in zip(vs, want[s]):
                w = dx.canon(w)
                assert vals[n].dtype == w.dtype, (op_type, s)
                np.testing.assert_array_equal(vals[n], w,
                                              err_msg="%s %s" % (op_type, s))
        seen.add(op_type)
        recorded = dp.HOST_OUTPUT_DIGESTS.get((model, op_type))
        if recorded is not None:
            assert {s: [dx.digest(dx.canon(vals[n])) for n in outs[s]]
                    for s in recorded} == recorded, op_type
    assert seen == set(port.host_ops)


@pytest.mark.parametrize("model", ["mask_rcnn", "ssd"])
def test_evaluation_nms_and_map_are_the_reference(model, request):
    """The evaluation clone after the first step: `multiclass_nms` and
    `detection_map` equal the reference's ops on the port's decoded boxes
    and scores; the mAP in [0, 1]."""
    _, port, _, _, _, _, texe, tscope = request.getfixturevalue(model)
    ops = port.test.global_block().ops
    nms = next(op for op in ops if op.type == "multiclass_nms")
    dmap = next(op for op in ops if op.type == "detection_map")
    feed = port.test_feed(np.random.RandomState(1))
    fetch = [nms.input_names["BBoxes"][0], nms.input_names["Scores"][0],
             nms.output_names["Out"][0], dmap.input_names["DetectRes"][0],
             dmap.input_names["Label"][0], dmap.output_names["MAP"][0]]
    boxes, scores, out, det, label, m_ap = texe.run(
        port.test, feed=feed, fetch_list=fetch, scope=tscope)
    want = rreg.get_op("multiclass_nms").compute(
        {"BBoxes": [boxes], "Scores": [scores]}, dict(nms.attrs))["Out"]
    np.testing.assert_array_equal(out, np.asarray(want))
    want = rreg.get_op("detection_map").compute(
        {"DetectRes": [det], "Label": [label]}, dict(dmap.attrs))
    np.testing.assert_array_equal(m_ap, np.asarray(want["MAP"]))
    assert out.shape[1] == 6 and 0.0 <= float(m_ap[0]) <= 1.0
