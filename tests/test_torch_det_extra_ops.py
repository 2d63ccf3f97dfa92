"""The reference's `detection_extra_ops` (21 types), `vision_extra_ops` (9)
and `sample_logits` in the port (paddle_tpu_torch, on the CPU) against
the JAX package.

Table-driven (`tests/torch_det_extra_cases.py`, checked by
`tests/torch_case_parity.py`): each case's reference runs once in a
module fixture (forward and `jax.vjp` under one seeded cotangent); the
port's outputs within fp32 rtol 1e-5 (integer outputs exactly), its
gradients likewise (through the bilinear taps of the deformable types,
the trilinear taps of `bilateral_slice`, the gathers of
`target_assign`, `hsigmoid` and `conv_shift`), `infer_outputs` equal to
the reference's, and the registry flags equal. Looser, and why:
`roi_perspective_transform` within rtol 1e-4 and atol 1e-5, because each
RoI's 8 x 8 solve rounds otherwise in LAPACK's path than in XLA's (the
sampled values move by up to 1.5e-6).

The host types are exact: every output, float and integer, equal to the
reference's on identical numpy inputs (the samplers index for index,
ties, no ground truth, `11point` and the streaming state included), and
their recorded digests (`HOST_DIGESTS`, which the card must give) are
the reference's. The random types are held by their own rules: with
`CustomizedSamples` `sample_logits` equals the reference's; its draws
are log-uniform over the vocabulary, the same for a seed and the rest
of its outputs the reference's formula on them;
`sampled_softmax_with_cross_entropy` equals the reference's formula on
the port's draws; `random_crop` is a window of X at a start in range.
Then the layer functions, each program op by op against the reference's,
and the two open port faults' neighbours: `unpool`'s duplicate indices
and `retinanet_detection_output` on a zero-area box."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.rng import make_key
from paddle_tpu.ops import registry as rreg

import torch_case_parity as parity
import torch_det_extra_cases as dx

#: the reference's random types, held by their own tests below
RANDOM = {"sample_logits_customized"}
NAMES = sorted(n for n in dx.CASES if n not in RANDOM)
TYPES = sorted({c[0] for c in list(dx.CASES.values())
                + list(dx.RANDOM_CASES.values())})
HOST = dx.host_cases()
#: (rtol, atol) where the default fp32 one does not hold (module docstring)
LOOSE = {"roi_perspective_transform": (1e-4, 1e-5)}


@pytest.fixture(scope="module")
def reference():
    return parity.reference_results(NAMES, cases=dx)


def test_cases_cover_the_modules():
    """Every type the reference's detection_extra_ops and
    vision_extra_ops register has a case, and `sample_logits`; the port
    registers them all."""
    ref = {t for t in rreg.registered_ops()
           if rreg.get_op(t).compute.__module__ in (
               "paddle_tpu.ops.detection_extra_ops",
               "paddle_tpu.ops.vision_extra_ops")} | {"sample_logits"}
    assert set(TYPES) == ref and len(TYPES) == 21 + 9 + 1
    assert ref <= set(parity.treg.registered_ops())
    assert {dx.CASES[n][0] for n in HOST} == {
        t for t in ref if rreg.get_op(t).no_jit}


@pytest.mark.parametrize("name", NAMES)
def test_op_matches_reference(name, reference):
    rtol, atol = LOOSE.get(dx.CASES[name][0], (parity.RTOL, parity.ATOL))
    parity.check_case(name, reference[name], cases=dx, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if n != "retinanet_detection_output"])
def test_infer_outputs_matches_reference(name):
    parity.check_infer(name, cases=dx)


@pytest.mark.parametrize("op_type", TYPES)
def test_flags_match_the_reference(op_type):
    parity.check_flags(op_type)


def _both(op, ins, attrs, ref_attrs=None):
    """(the port's outputs, the reference's), slot -> list of numpy."""
    got = parity.port(op, {s: [parity.to_torch(a) for a in v]
                           for s, v in ins.items()}, attrs)
    want = rreg.normalize_outs(rreg.get_op(op).compute(
        {s: [np.asarray(a) for a in v] for s, v in ins.items()},
        dict(attrs, **(ref_attrs or {}))))
    return ({s: [t.detach().numpy() for t in v] for s, v in got.items()},
            {s: [np.asarray(a) for a in v] for s, v in want.items()})


def _assert_exact(got, want):
    assert sorted(got) == sorted(want)
    for s in want:
        assert len(got[s]) == len(want[s]), s
        for g, w in zip(got[s], want[s]):
            w = dx.canon(w)
            assert g.dtype == w.dtype and g.shape == w.shape, (
                s, g.dtype, w.dtype, g.shape, w.shape)
            np.testing.assert_array_equal(g, w, err_msg=s)


@pytest.mark.parametrize("name", HOST)
def test_host_case_exact(name):
    """Every output of a host type, floats included, equal to the
    reference's; its digests the recorded ones."""
    op, _, attrs, _, _ = dx.CASES[name]
    got, want = _both(op, dx.inputs(name), attrs)
    _assert_exact(got, want)
    assert dx.digests(want) == dx.HOST_DIGESTS[name] == dx.digests(got)


def test_retinanet_detection_output_infer():
    """The port's shape probe of `retinanet_detection_output` on zeros
    ends (rows of 6); the reference's never does (module docstring)."""
    specs = parity._specs("retinanet_detection_output", dx)
    out = parity.treg.infer_outputs("retinanet_detection_output", specs,
                                    dict(dx.CASES[
                                        "retinanet_detection_output"][2]))
    assert out["Out"][0][0][1] == 6 and out["Out"][0][1] == "float32"


def test_retinanet_zero_area_box_ends():
    """A zero-area detection box has IoU 0 with itself: the port keeps it
    once and goes on (the reference's loop would keep it forever)."""
    z = np.zeros((1, 3, 4), "float32")
    got = parity.port("retinanet_detection_output", {
        "BBoxes": [torch.tensor(z)], "Scores": [torch.ones(1, 3, 2)],
        "Anchors": [torch.tensor(np.tile([[5, 5, 4, 4]], (3, 1)).astype(
            "float32"))]}, {"score_threshold": 0.1, "nms_threshold": 0.3})
    assert got["Out"][0].shape == (6, 6)


def test_generate_proposals_tied_scores_exact():
    """Scores on 5 levels (ties everywhere) and boxes on a coarse grid
    (tied IoUs) at `post_nms_topN` below the survivors: the kept RoIs and
    their order equal the reference's loop."""
    r = np.random.RandomState(7)
    ins = {"Scores": [(r.randint(0, 5, (1, 3, 8, 8)) / 5.0).astype(
        "float32")],
           "BboxDeltas": [(r.randint(-2, 3, (1, 12, 8, 8)) * 0.25).astype(
               "float32")],
           "ImInfo": [np.asarray([[64.0, 64.0, 1.0]], "float32")],
           "Anchors": [dx._grid_anchors(8, 8, [8.0, 16.0, 24.0], 8.0)(
               r).reshape(8, 8, 3, 4)],
           "Variances": [np.ones((8, 8, 3, 4), "float32")]}
    got, want = _both("generate_proposals", ins,
                      {"pre_nms_topN": 150, "post_nms_topN": 40,
                       "nms_thresh": 0.4, "min_size": 0.0})
    _assert_exact(got, want)
    assert got["RpnRoisNum"][0][0] == 40


def test_samplers_redraw_from_their_seed():
    """`rpn_target_assign` and `generate_proposal_labels` draw from
    RandomState(seed attr) at every call, as the reference: the same
    seed gives the same anchors and RoIs twice, another seed others,
    each equal to the reference's."""
    for name, slot in (("rpn_target_assign", "ScoreIndex"),
                       ("generate_proposal_labels_many_fg", "Rois")):
        op, _, attrs, _, _ = dx.CASES[name]
        ins = dx.inputs(name)
        runs = []
        for seed in (0, 0, 5):
            got, want = _both(op, ins, dict(attrs, seed=seed))
            _assert_exact(got, want)
            runs.append(got[slot][0])
        assert np.array_equal(runs[0], runs[1])
        assert not np.array_equal(runs[0], runs[2])


def test_unpool_duplicates_take_every_gradient():
    """Repeated indices that carry one value: the forward is the
    reference's (one value written), and each duplicate's gradient is
    the output gradient at its index, as Paddle's Unpool2dMaxGradFunctor
    gives it (the reference's `.at[].set` gives it to one of them)."""
    x, idx = (dx.inputs("unpool_duplicates")[s][0] for s in ("X",
                                                             "Indices"))
    xt = torch.tensor(x, requires_grad=True)
    out = parity.port("unpool", {"X": [xt], "Indices": [torch.tensor(idx)]},
                      {"unpooled_height": 4, "unpooled_width": 4})["Out"][0]
    g = torch.arange(out.numel(), dtype=torch.float32).reshape(out.shape)
    (gx,) = torch.autograd.grad(out, [xt], g)
    flat = g.reshape(2, 3, 16)
    want = torch.gather(flat, 2, torch.tensor(idx).reshape(2, 3, 4).long())
    assert torch.equal(gx.reshape(2, 3, 4), want)
    assert gx[0, 0, 0, 0] == gx[0, 0, 0, 1] == 5.0


# -- the random types ---------------------------------------------------------

def test_sample_logits_customized_matches_reference():
    """With CustomizedSamples and CustomizedProbabilities the outputs and
    the logits' gradient are the reference's (its key unused)."""
    op, _, attrs, _, _ = dx.CASES["sample_logits_customized"]
    ins = dx.inputs("sample_logits_customized")
    got, want = _both(op, ins, attrs, {"_rng_key": make_key(0)})
    for s in want:
        w = dx.canon(want[s][0])
        assert got[s][0].dtype == w.dtype, s
        np.testing.assert_allclose(got[s][0], w, rtol=1e-6, err_msg=s)
    # one accidental hit a row (7, 0, 5 and 12 drawn again)
    assert (got["SampledLogits"][0] < -1e29).sum() == 4
    logits = torch.tensor(ins["Logits"][0], requires_grad=True)
    t = parity.port(op, dict({s: [parity.to_torch(v[0])] for s, v in
                              ins.items()}, Logits=[logits]), attrs)
    ct = np.random.RandomState(3).randn(4, 5).astype("float32")
    (g,) = torch.autograd.grad(t["SampledLogits"][0], [logits],
                               torch.tensor(ct))
    ref_ins = {s: [jnp.asarray(v[0])] for s, v in ins.items()}
    rg = jax.grad(lambda lg: jnp.sum(rreg.get_op(op).compute(
        dict(ref_ins, Logits=[lg]), dict(attrs, _rng_key=make_key(0)))[
            "SampledLogits"] * ct))(ref_ins["Logits"][0])
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=1e-6)


def _draw(name, seed, **over):
    op, _, attrs, diff = dx.RANDOM_CASES[name]
    ins = dict(dx.inputs(name), **over)
    t_ins = {s: [parity.to_torch(a, s in diff and i == 0)
                 for i, a in enumerate(v)] for s, v in ins.items()}
    from paddle_tpu_torch.core.rng import seed_tensor

    out = parity.port(op, t_ins, dict(attrs, _rng_seed=seed_tensor(
        seed, "cpu")))
    return out, t_ins, ins, attrs


def test_sample_logits_draws():
    """The negatives are shared by the rows, in [0, vocab), the same for a
    seed and others for another; each probability is the log-uniform
    P(k); the sampled logits are the reference's formula on the draws
    (with customized samples), accidental hits pushed to -1e30."""
    out, _, ins, attrs = _draw("sample_logits", 7)
    again = _draw("sample_logits", 7)[0]
    other = _draw("sample_logits", 8)[0]
    samples = out["Samples"][0].numpy()
    nt, vocab = 1, ins["Logits"][0].shape[1]
    assert samples.dtype == np.int32 and samples.shape == (4, 1 + 6)
    assert (samples[:, nt:] == samples[0, nt:]).all()
    assert (samples >= 0).all() and (samples < vocab).all()
    assert torch.equal(out["Samples"][0], again["Samples"][0])
    assert not torch.equal(out["Samples"][0], other["Samples"][0])
    p = out["Probabilities"][0].numpy()
    np.testing.assert_allclose(
        p, np.log((samples + 2.0) / (samples + 1.0)) / np.log(vocab + 1.0),
        rtol=1e-5)
    want = rreg.get_op("sample_logits").compute(
        {"Logits": [jnp.asarray(ins["Logits"][0])],
         "Labels": [jnp.asarray(ins["Labels"][0])],
         "CustomizedSamples": [jnp.asarray(samples)],
         "CustomizedProbabilities": [jnp.asarray(p)]},
        dict(attrs, _rng_key=make_key(0)))
    np.testing.assert_allclose(out["SampledLogits"][0].detach().numpy(),
                               np.asarray(want["SampledLogits"]), rtol=1e-6)
    np.testing.assert_array_equal(out["SampledLabels"][0].numpy(),
                                  np.zeros((4, 1), np.int32))


def test_sample_logits_draws_log_uniform():
    """20,000 draws against the log-uniform law: the frequency of the
    first classes within 2% of P(k), of the rest as a block too."""
    from paddle_tpu_torch.core.rng import seed_tensor
    from paddle_tpu_torch.ops.specialty_ops import log_uniform_sample

    vocab = 1000
    s, p = log_uniform_sample(seed_tensor(11, "cpu"), 20000, vocab, "cpu")
    counts = np.bincount(s.numpy(), minlength=vocab) / 20000.0
    law = np.log((np.arange(vocab) + 2.0) / (np.arange(vocab) + 1.0)) \
        / np.log(vocab + 1.0)
    np.testing.assert_allclose(counts[:4], law[:4], atol=0.02)
    assert abs(counts[100:].sum() - law[100:].sum()) < 0.02
    # log of a float32 ratio near 1 keeps about 4 digits for large k
    np.testing.assert_allclose(p.numpy(), law[s.numpy()], rtol=1e-4)


def test_sampled_softmax_is_the_reference_on_its_draws():
    """The loss and the softmax are the reference's composition
    (`sample_logits` with the port's draws given, then the mean negative
    log softmax of the true columns), the gradient too."""
    out, t_ins, ins, attrs = _draw("sampled_softmax_with_cross_entropy", 3)
    from paddle_tpu_torch.core.rng import seed_tensor

    drawn = parity.port("sample_logits", {
        "Logits": t_ins["Logits"], "Labels": t_ins["Label"]},
        dict(attrs, _rng_seed=seed_tensor(3, "cpu")))
    samples = drawn["Samples"][0].numpy()
    probs = drawn["Probabilities"][0].numpy()
    nt = ins["Label"][0].shape[1]

    def ref(lg):
        sl = rreg.get_op("sample_logits").compute(
            {"Logits": [lg], "Labels": [jnp.asarray(ins["Label"][0])],
             "CustomizedSamples": [jnp.asarray(samples)],
             "CustomizedProbabilities": [jnp.asarray(probs)]},
            dict(attrs, _rng_key=make_key(0)))["SampledLogits"]
        logp = jax.nn.log_softmax(sl, -1)
        return -logp[:, :nt].sum(-1, keepdims=True) / nt, jnp.exp(logp)

    lg = jnp.asarray(ins["Logits"][0])
    loss, soft = ref(lg)
    np.testing.assert_allclose(out["Loss"][0].detach().numpy(),
                               np.asarray(loss), rtol=1e-5)
    np.testing.assert_allclose(out["Softmax"][0].detach().numpy(),
                               np.asarray(soft), rtol=1e-5, atol=1e-7)
    (g,) = torch.autograd.grad(out["Loss"][0].sum(), t_ins["Logits"])
    rg = jax.grad(lambda v: ref(v)[0].sum())(lg)
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=1e-5,
                               atol=1e-7)


def test_random_crop_is_a_window_of_x():
    """Out is X[..., i:i+5, j:j+6] for starts in range, the same for a
    seed; over 40 seeds every start of the last axis shows up; the
    gradient is 1 inside the window; SeedOut is zeros."""
    starts = set()
    for seed in range(40):
        out, t_ins, ins, _ = _draw("random_crop", seed)
        x, o = ins["X"][0], out["Out"][0].detach().numpy()
        hits = [(i, j) for i in range(9 - 5 + 1) for j in range(10 - 6 + 1)
                if np.array_equal(x[..., i:i + 5, j:j + 6], o)]
        assert len(hits) == 1, seed
        starts.add(hits[0][1])
        if seed == 0:
            (g,) = torch.autograd.grad(out["Out"][0].sum(), t_ins["X"])
            i, j = hits[0]
            mask = np.zeros(x.shape, "float32")
            mask[..., i:i + 5, j:j + 6] = 1
            np.testing.assert_array_equal(g.numpy(), mask)
            assert torch.equal(_draw("random_crop", 0)[0]["Out"][0],
                               out["Out"][0])
            np.testing.assert_array_equal(out["SeedOut"][0].numpy(),
                                          np.zeros(1, np.int32))
    assert starts == set(range(5))


# -- the layer functions ------------------------------------------------------

def _extra_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        feat = L.data(name="feat", shape=[8, 6, 8], dtype="float32")
        rois = L.data(name="rois", shape=[4], dtype="float32",
                      append_batch_size=False)
        quads = L.data(name="quads", shape=[8], dtype="float32",
                       append_batch_size=False)
        seq = L.data(name="seq", shape=[5, 6], dtype="float32")
        lab = L.data(name="lab", shape=[1], dtype="int64")
        gt = L.data(name="gt", shape=[4], dtype="float32",
                    append_batch_size=False)
        gtl = L.data(name="gtl", shape=[1], dtype="int32",
                     append_batch_size=False)
        prior = L.data(name="prior", shape=[4], dtype="float32",
                       append_batch_size=False)
        loc = L.data(name="loc", shape=[1, 12, 4], dtype="float32",
                     append_batch_size=False)
        conf = L.data(name="conf", shape=[1, 12, 3], dtype="float32",
                      append_batch_size=False)
        offset = L.conv2d(feat, 2 * 9, 3, padding=1)
        mask = L.sigmoid(L.conv2d(feat, 9, 3, padding=1))
        dconv = L.deformable_conv(feat, offset, mask, 4, 3, padding=1)
        outs = [dconv,
                L.prroi_pool(feat, rois, 0.5, 2, 2),
                L.psroi_pool(feat, rois, 2, 0.5, 2, 2),
                L.deformable_roi_pooling(feat, rois, None, no_trans=True,
                                         spatial_scale=0.5, pooled_height=2,
                                         pooled_width=2,
                                         position_sensitive=True),
                L.roi_perspective_transform(feat, quads, 3, 4),
                L.polygon_box_transform(feat),
                L.add_position_encoding(seq, 0.5, 1.0),
                L.hsigmoid(L.reshape(seq, [-1, 6]), L.reshape(
                    L.concat([lab] * 5, axis=1), [-1, 1]), 6),
                L.ssd_loss(loc, conf, gt, gtl, prior),
                L.similarity_focus(feat, 1, [0, 3])]
    return main, startup, outs


def _random_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        x = L.data(name="x", shape=[3, 9, 10], dtype="float32")
        logits = L.data(name="logits", shape=[40], dtype="float32")
        label = L.data(name="label", shape=[2], dtype="int64")
        idx = L.data(name="idx", shape=[3, 4, 5], dtype="int32")
        L.random_crop(x, [5, 6])
        L.sampled_softmax_with_cross_entropy(logits, label, 8, num_true=2)
        pooled = L.data(name="pooled", shape=[3, 4, 5], dtype="float32")
        L.unpool(pooled, idx, unpool_size=[8, 10])
    return main


def test_layers_build_the_reference_program():
    """The slice's layer functions (`deformable_conv`, `prroi_pool`,
    `psroi_pool`, `deformable_roi_pooling`, `roi_perspective_transform`,
    `polygon_box_transform`, `add_position_encoding`, `hsigmoid` and the
    reference's `ssd_loss` composition, `similarity_focus`) emit the
    reference's program op by op and, from its startup state, fetch its
    values (rtol 1e-4: the perspective solve)."""
    import paddle_tpu.fluid as rfluid
    import paddle_tpu_torch.fluid as tfluid

    r = np.random.RandomState(5)
    pri = dx._boxes(12, hi=1.0, size=(0.1, 0.4))(r)
    feed = {"feat": r.randn(2, 8, 6, 8).astype("float32"),
            "rois": np.asarray([[1, 2, 9, 10], [0, 0, 15, 11]], "float32"),
            "quads": dx._quads(2)(r), "seq": r.randn(2, 5, 6).astype(
                "float32"), "lab": r.randint(0, 6, (2, 1)).astype("int64"),
            "gt": np.asarray([[0.1, 0.1, 0.4, 0.5], [0.5, 0.4, 0.9, 0.8]],
                             "float32"),
            "gtl": np.asarray([[1], [2]], "int32"), "prior": pri,
            "loc": (r.randn(1, 12, 4) * 0.1).astype("float32"),
            "conf": r.randn(1, 12, 3).astype("float32")}
    got, _ = parity.run_both(rfluid, tfluid, _extra_program(rfluid),
                             _extra_program(tfluid), feed, rtol=1e-4,
                             atol=1e-5)
    assert all(np.isfinite(g).all() for g in got)


def test_random_layers_emit_the_reference_ops():
    """`random_crop`, `sampled_softmax_with_cross_entropy` and `unpool`
    emit the reference's ops (their values are held above)."""
    import paddle_tpu.fluid as rfluid
    import paddle_tpu_torch.fluid as tfluid

    parity.assert_same_program(_random_program(rfluid),
                               _random_program(tfluid))
