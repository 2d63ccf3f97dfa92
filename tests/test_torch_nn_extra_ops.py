"""The rest of the reference's `nn_ops` (35 types: the losses
`cross_entropy` ... `kldiv_loss`, `conv2d_transpose`, `conv3d`,
`conv3d_transpose`, `pool3d`, `max_pool2d_with_index`, the norms,
`lstm_seq`, `gru_seq`, `prelu` and the rearrangements) in the port
(paddle_tpu_torch, on the CPU) against the JAX package, and the
`fluid.layers` functions of `layers/nn.py`, `layers/loss.py` and
`layers/nn_extra.py` that emit the book slice's types.

Table-driven (`tests/torch_nn_cases.py`, checked by
`tests/torch_case_parity.py`): each case's reference runs once in a
module fixture (forward and `jax.vjp` under one seeded cotangent); the
port's outputs within fp32 rtol 1e-5 (integer outputs exactly, in the
device dtype), its gradients (`torch.autograd.grad`) likewise, and
`infer_outputs` with a -1 batch equal to the reference's.
`max_pool2d_with_index` is held with ties (the first maximum of a window
wins, as `jnp.argmax`). Where the reference cannot run a case Paddle
documents (maxout over a negative axis, the `bpr_loss` layer) or
computes another function (`conv3d_transpose` where padding is not
dilation * (k - 1) / 2), the port follows Paddle and the test pins the
reference's behaviour (ROADMAP Queue 3, reference-side)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as rfluid
from paddle_tpu.core.scope import Scope as RScope
from paddle_tpu.ops import registry as rreg

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.scope import load_numpy_state

import torch_case_parity as parity
from torch_nn_cases import CASES, cases_of

NAMES = cases_of("nn_ops")
TYPES = sorted({CASES[n][0] for n in NAMES})


@pytest.fixture(scope="module")
def reference():
    return parity.reference_results(NAMES)


def test_cases_cover_the_rest_of_nn_ops():
    """Every type the reference's nn_ops registers has a case, and the
    port registers them all."""
    ref_nn = {t for t in rreg.registered_ops()
              if rreg.get_op(t).compute.__module__ == "paddle_tpu.ops.nn_ops"}
    assert len(TYPES) == 35 and set(TYPES) <= ref_nn
    assert ref_nn <= set(parity.treg.registered_ops())


@pytest.mark.parametrize("name", NAMES)
def test_op_matches_reference(name, reference):
    parity.check_case(name, reference[name])


@pytest.mark.parametrize("name", NAMES)
def test_infer_outputs_matches_reference(name):
    parity.check_infer(name)


@pytest.mark.parametrize("op_type", TYPES)
def test_flags_match_the_reference(op_type):
    parity.check_flags(op_type)


def test_max_pool_with_index_first_maximum_wins():
    """Each Mask entry is the flat index, in the unpadded input, of the
    first cell (row-major in the window) holding the window's maximum."""
    r = np.random.RandomState(3)
    x = r.randint(0, 3, (2, 2, 5, 6)).astype("float32")
    k, s, p = (3, 2), (2, 2), (1, 0)
    out = parity.port("max_pool2d_with_index", {"X": [torch.tensor(x)]},
                      {"ksize": list(k), "strides": list(s),
                       "paddings": list(p)})
    mask = out["Mask"][0].numpy()
    for n, c, i, j in np.ndindex(mask.shape):
        best, first = -np.inf, None
        for a in range(k[0]):
            for b in range(k[1]):
                h, w = i * s[0] - p[0] + a, j * s[1] - p[1] + b
                if 0 <= h < 5 and 0 <= w < 6 and x[n, c, h, w] > best:
                    best, first = x[n, c, h, w], h * 6 + w
        assert mask[n, c, i, j] == first
        assert out["Out"][0][n, c, i, j] == best


def test_reference_maxout_fails_on_a_negative_axis():
    """Paddle's maxout takes axis -1 as the last axis; the reference's
    reshape builds a wrong shape and fails. The port's axis -1 is its
    axis 2."""
    x = np.random.RandomState(0).randn(2, 3, 4).astype("float32")
    with pytest.raises(TypeError):
        rreg.get_op("maxout").compute({"X": [jnp.asarray(x)]},
                                      {"groups": 2, "axis": -1})
    a, b = (parity.port("maxout", {"X": [torch.tensor(x)]},
                        {"groups": 2, "axis": ax})["Out"][0]
            for ax in (-1, 2))
    assert a.shape == (2, 3, 2) and torch.equal(a, b)


def test_reference_conv3d_transpose_pads_its_own_way():
    """Paddle's output side is (D - 1) * stride - 2 * padding + k; the
    reference pads its transposed convolution by `padding` itself, which
    agrees only where padding = (k - 1) / 2 (the parity case). At
    padding 0 it gives (D - 1) * stride - k + 2; the port gives
    Paddle's."""
    r = np.random.RandomState(1)
    x = r.randn(1, 2, 3, 3, 3).astype("float32")
    w = r.randn(2, 4, 3, 3, 3).astype("float32")
    attrs = {"strides": [2, 2, 2], "paddings": [0, 0, 0]}
    ref = rreg.get_op("conv3d_transpose").compute(
        {"Input": [jnp.asarray(x)], "Filter": [jnp.asarray(w)]}, attrs)
    assert ref["Output"].shape == (1, 4, 3, 3, 3)
    got = parity.port("conv3d_transpose", {"Input": [torch.tensor(x)],
                                           "Filter": [torch.tensor(w)]},
                      attrs)["Output"][0]
    assert got.shape == (1, 4, 7, 7, 7)
    want = torch.nn.functional.conv_transpose3d(torch.tensor(x),
                                                torch.tensor(w), stride=2)
    assert torch.equal(got, want)


def test_reference_bpr_loss_layer_names_the_wrong_slot():
    """The reference's `bpr_loss` layer binds its result to an "Out"
    slot the op does not write (it writes "Y"), so the program cannot
    fetch it; the port's layer binds "Y"."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name_guard():
            x = fluid.layers.data("x", shape=[5], dtype="float32")
            y = fluid.layers.data("y", shape=[1], dtype="int64")
            out = fluid.layers.bpr_loss(x, y)
        return main, out

    rmain, rout = build(rfluid)
    tmain, tout = build(tfluid)
    assert list(rmain.global_block().ops[-1].output_names) == ["Out"]
    assert list(tmain.global_block().ops[-1].output_names) == ["Y"]
    r = np.random.RandomState(2)
    feed = {"x": r.randn(3, 5).astype("float32"),
            "y": r.randint(0, 5, (3, 1)).astype("int64")}
    with pytest.raises(Exception):
        rfluid.Executor(rfluid.CPUPlace()).run(
            rmain, feed=feed, fetch_list=[rout], scope=RScope())
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=feed, fetch_list=[tout], scope=tfluid.Scope())[0]
    assert got.shape == (3, 1) and np.isfinite(got).all()


# -- the layers ---------------------------------------------------------------

def _layers_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        img = L.data("img", shape=[4, 6, 6], dtype="float32")
        vol = L.data("vol", shape=[2, 4, 4, 4], dtype="float32")
        seq = L.data("seq", shape=[5, 8], dtype="float32")
        vec = L.data("vec", shape=[6], dtype="float32")
        vec2 = L.data("vec2", shape=[6], dtype="float32")
        prob = L.data("prob", shape=[6], dtype="float32")
        lab = L.data("lab", shape=[1], dtype="int64")
        bits = L.data("bits", shape=[1], dtype="float32")
        theta = L.data("theta", shape=[2, 3], dtype="float32")
        tm = L.data("tm", shape=[3, 4], dtype="float32",
                    append_batch_size=False)
        h0 = L.data("h0", shape=[2, 2, 3], dtype="float32",
                    append_batch_size=False)
        outs = [
            L.conv2d_transpose(img, 3, filter_size=3, stride=2, padding=1),
            L.group_norm(img, groups=2), L.instance_norm(img),
            L.prelu(img, "all"), L.prelu(img, "channel"),
            L.prelu(img, "element"),
            L.nn.adaptive_pool2d(img, [3, 2], pool_type="avg"),
            L.pool3d(vol, 2, pool_stride=2), L.adaptive_pool3d(vol, 2),
            L.conv3d(vol, 3, 3, padding=1),
            L.conv3d_transpose(vol, 3, filter_size=3, padding=1),
            L.grid_sampler(img, L.affine_grid(theta, [3, 4, 5, 5])),
            L.affine_channel(img), L.lrn(img), L.unfold(img, 2, 2),
            L.space_to_depth(img, 2), L.shuffle_channel(img, 2),
            L.temporal_shift(img, 1), L.pixel_shuffle(img, 2),
            L.maxout(img, 2), L.row_conv(seq, 2),
            L.fsp_matrix(img, img), L.im2sequence(img, 3, 2, 1),
            L.spectral_norm(L.create_parameter([4, 6], "float32"),
                            power_iters=2),
            L.cross_entropy(L.softmax(prob), lab),
            L.sigmoid_cross_entropy_with_logits(vec, L.sigmoid(vec2)),
            L.square_error_cost(vec, vec2), L.mse_loss(vec, vec2),
            L.huber_loss(vec, vec2, 0.5), L.smooth_l1(vec, vec2),
            L.kldiv_loss(vec, L.sigmoid(vec2)), L.cos_sim(vec, vec2),
            L.dice_loss(L.sigmoid(vec), L.sigmoid(vec2)),
            L.log_loss(L.sigmoid(bits), bits), L.npair_loss(vec, vec2, bits),
            L.rank_loss(bits, L.reduce_sum(vec, 1, keep_dim=True), bits),
            L.margin_rank_loss(bits, bits, L.reduce_mean(vec, 1,
                                                         keep_dim=True)),
            L.center_loss(vec, lab, 6, 0.5),
            L.teacher_student_sigmoid_loss(bits, L.sigmoid(bits)),
            L.sigmoid_focal_loss(vec, lab),
        ]
        outs += list(L.dynamic_lstm(L.fc(seq, 16, num_flatten_dims=2), 16,
                                    is_reverse=True))
        outs += list(L.dynamic_lstmp(L.fc(seq, 16, num_flatten_dims=2), 16,
                                     3))
        outs.append(L.dynamic_gru(L.fc(seq, 12, num_flatten_dims=2), 4))
        outs += list(L.gru_unit(L.fc(vec, 12), L.fc(vec, 4), 12))
        outs += list(L.lstm_unit(vec, L.fc(vec, 3), L.fc(vec2, 3)))
        outs += list(L.lstm(L.reshape(tm, [3, 1, 4]),
                            L.slice(h0, [1], [0], [1]),
                            L.slice(h0, [1], [1], [2]), 3, 3, 1,
                            is_bidirec=True))
    return main, startup, outs


def _layers_feed():
    r = np.random.RandomState(4)
    f = lambda *s: r.randn(*s).astype("float32")  # noqa: E731
    return {"img": f(2, 4, 6, 6), "vol": f(2, 2, 4, 4, 4), "seq": f(2, 5, 8),
            "vec": f(2, 6), "vec2": f(2, 6),
            "prob": f(2, 6), "lab": r.randint(0, 6, (2, 1)).astype("int64"),
            "bits": r.randint(0, 2, (2, 1)).astype("float32"),
            "theta": f(2, 2, 3) * 0.5, "tm": f(3, 4), "h0": f(2, 2, 3)}


def test_layers_match_reference():
    """Every new layer in both packages: the same op types, attrs and
    slots op by op; from the reference's startup state, the same
    fetches."""
    rmain, rstartup, routs = _layers_program(rfluid)
    tmain, _, touts = _layers_program(tfluid)
    rops, tops = rmain.global_block().ops, tmain.global_block().ops
    assert [op.type for op in tops] == [op.type for op in rops]
    for r, t in zip(rops, tops):
        assert {k: v for k, v in t.attrs.items() if not k.startswith("_")} \
            == {k: v for k, v in r.attrs.items() if not k.startswith("_")}, \
            t.type
        assert t.input_names == r.input_names, t.type
        assert t.output_names == r.output_names, t.type
    rexe, rscope = rfluid.Executor(rfluid.CPUPlace()), RScope()
    rexe.run(rstartup, scope=rscope)
    names = sorted(v.name for v in rmain.list_vars() if v.persistable)
    tscope = tfluid.Scope()
    load_numpy_state(tscope, {n: np.asarray(rscope.find_var(n))
                              for n in names}, "cpu")
    feed = _layers_feed()
    want = rexe.run(rmain, feed=feed, fetch_list=routs, scope=rscope)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=feed, fetch_list=touts, scope=tscope)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape, touts[i].name
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                   err_msg=touts[i].name)


@pytest.mark.parametrize("shape,pads,mode", [
    ((2, 3, 5, 6), [1, 2, 2, 1], "reflect"),
    ((2, 3, 5, 6), [2, 0, 1, 3], "replicate"),
    ((1, 2, 3, 4, 5), [1, 1, 2, 0, 1, 2], "replicate"),
    ((1, 2, 3, 4, 5), [2, 1, 1, 2, 1, 1], "reflect"),
    ((1, 2, 3, 4, 5), [1, 2, 0, 1, 2, 1], "circular"),
])
def test_mode_pad_gradient_summed_in_order(shape, pads, mode):
    """The gradient that `pad2d`/`pad3d` take on the card
    (`_SortedModePad`: each output cell's source by padding cell
    numbers, then one ordered `index_put_`) equals autograd's of
    `F.pad`."""
    from paddle_tpu_torch.ops.nn_ops import _SortedModePad

    r = np.random.RandomState(1)
    x = torch.tensor(r.randn(*shape).astype("float32"), requires_grad=True)
    out = _SortedModePad.apply(x, pads, mode)
    want_out = torch.nn.functional.pad(x, pads, mode=mode)
    g = torch.tensor(r.randn(*out.shape).astype("float32"))
    got = torch.autograd.grad(out, x, g)[0]
    want = torch.autograd.grad(want_out, x, g)[0]
    assert torch.equal(out, want_out)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
