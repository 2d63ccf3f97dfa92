"""The op types that BERT pretraining adds to the port's registry
(paddle_tpu_torch.ops, on the CPU), each against the JAX package's
(`paddle_tpu.ops`).

As in `tests/test_torch_fluid_ops.py`: seeded numpy inputs go through the
reference's `get_op(t).compute` and the port's; float32 outputs within
rtol 1e-5, integer outputs exactly; for differentiable ops the gradient
of every float input under one seeded cotangent (`jax.vjp` against
`torch.autograd.grad`) within rtol 1e-5; `infer_outputs` with a -1
batch equal in shape and dtype. The random ops are held by shape, dtype
and range: the port's generator streams are not JAX's. Dropout (the op,
and inside the composite attention) is held with the port's keep mask
(`core.rng.keep_mask` of the op's device seed) injected into the
reference, whose `jax.random.bernoulli` returns it.

`fused_linear_softmax_xent` is also held against a plain unfused version
(the [N, V] logits, then log-softmax) at a vocab that is not a multiple
of the chunk, and `scaled_dot_product_attention` on the CPU takes the
composite path with and without a key bias."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.rng import make_key
from paddle_tpu.ops import registry as rreg

from paddle_tpu_torch.core.rng import keep_mask, seed_tensor
from paddle_tpu_torch.core.types import to_torch_dtype
from paddle_tpu_torch.ops import registry as treg

RTOL, ATOL = 1e-5, 1e-6


def _f(*shape):
    return lambda r: r.randn(*shape).astype("float32")


def _i(high, *shape):
    return lambda r: r.randint(0, high, size=shape).astype("int64")


def _const(v):
    return lambda r: np.asarray(v)


def _pos(*shape):
    return lambda r: (r.rand(*shape) + 0.5).astype("float32")


def _attn_mask(r):
    """A [B, Sq, Sk] float mask: 0 where attended, -1e4 elsewhere."""
    return np.where(r.rand(2, 6, 6) < 0.7, 0.0, -1e4).astype("float32")


def _labels_with_tail(r):
    """Labels over a vocab of 50 (chunk 16: four chunks, the last 2
    wide), with labels in the narrow last chunk."""
    y = r.randint(0, 50, size=(6, 1)).astype("int64")
    y[0, 0], y[1, 0] = 49, 48
    return y


_ADAM_STATE = {
    "Moment1": [_f(4, 3), _f(5)],
    "Moment2": [lambda r: r.rand(4, 3).astype("float32"),
                lambda r: r.rand(5).astype("float32")],
    "Beta1Pow": [_const(np.float32([0.9 ** 3])),
                 _const(np.float32([0.9 ** 5]))],
    "Beta2Pow": [_const(np.float32([0.999 ** 3])),
                 _const(np.float32([0.999 ** 5]))],
}

SDPA_ATTRS = {"causal": False, "sm_scale": 0.3, "attn_dropout_prob": 0.0,
              "is_test": False}

#: name -> (op type, {slot: [numpy maker]}, attrs, float input slots to
#: differentiate, batch-carrying slots for the -1 inference check)
CASES = {
    "matmul": ("matmul", {"X": [_f(2, 3, 4)], "Y": [_f(4, 5)]}, {},
               ["X", "Y"], ["X"]),
    "matmul_transpose_alpha": (
        "matmul", {"X": [_f(2, 4, 3)], "Y": [_f(2, 5, 4)]},
        {"transpose_X": True, "transpose_Y": True, "alpha": 0.5},
        ["X", "Y"], ["X", "Y"]),
    "elementwise_mul": ("elementwise_mul", {"X": [_f(2, 3, 4)],
                                            "Y": [_f(3)]},
                        {"axis": 1}, ["X", "Y"], ["X"]),
    "elementwise_div": ("elementwise_div", {"X": [_f(4, 1)],
                                            "Y": [_pos(1)]},
                        {"axis": -1}, ["X", "Y"], ["X"]),
    "reduce_sum_all": ("reduce_sum", {"X": [_f(4, 3)]},
                       {"reduce_all": True, "dim": [0], "keep_dim": False},
                       ["X"], ["X"]),
    "reduce_sum_dim": ("reduce_sum", {"X": [_f(4, 3, 2)]},
                       {"reduce_all": False, "dim": [1, -1],
                        "keep_dim": True}, ["X"], ["X"]),
    "cast": ("cast", {"X": [_f(4, 3)]},
             {"in_dtype": "float32", "out_dtype": "int32"}, [], ["X"]),
    "assign": ("assign", {"X": [_f(4, 3)]}, {}, ["X"], ["X"]),
    "reshape2": ("reshape2", {"X": [_f(2, 6, 4)]}, {"shape": [0, 0, 2, 2]},
                 ["X"], ["X"]),
    "transpose2": ("transpose2", {"X": [_f(2, 3, 4, 5)]},
                   {"axis": [0, 2, 1, 3]}, ["X"], ["X"]),
    "slice": ("slice", {"Input": [_f(2, 5, 6)]},
              {"axes": [1, 2], "starts": [1, -4], "ends": [100, -1],
               "decrease_axis": []}, ["Input"], ["Input"]),
    "slice_decrease": ("slice", {"Input": [_f(2, 5, 6)]},
                       {"axes": [1], "starts": [0], "ends": [1],
                        "decrease_axis": [1]}, ["Input"], ["Input"]),
    "take_along_axis": ("take_along_axis",
                        {"Input": [_f(2, 5, 3)], "Index": [_i(5, 2, 4, 1)]},
                        {"Axis": 1}, ["Input"], ["Input", "Index"]),
    "tanh": ("tanh", {"X": [_f(4, 5)]}, {}, ["X"], ["X"]),
    "gelu": ("gelu", {"X": [_f(4, 5)]}, {}, ["X"], ["X"]),
    "gelu_tanh": ("gelu", {"X": [_f(4, 5)]}, {"approximate": True}, ["X"],
                  ["X"]),
    "layer_norm": ("layer_norm", {"X": [_f(2, 3, 8)], "Scale": [_f(8)],
                                  "Bias": [_f(8)]},
                   {"begin_norm_axis": 2, "epsilon": 1e-5},
                   ["X", "Scale", "Bias"], ["X"]),
    "layer_norm_flat": ("layer_norm", {"X": [_f(4, 2, 3)],
                                       "Scale": [_f(6)]},
                        {"begin_norm_axis": 1, "epsilon": 1e-5},
                        ["X", "Scale"], ["X"]),
    "dropout_infer": ("dropout", {"X": [_f(4, 5)]},
                      {"dropout_prob": 0.3, "is_test": True,
                       "dropout_implementation": "downgrade_in_infer"},
                      ["X"], ["X"]),
    "dropout_upscale": ("dropout", {"X": [_f(4, 5)]},
                        {"dropout_prob": 0.3, "is_test": False,
                         "dropout_implementation": "upscale_in_train"},
                        ["X"], ["X"]),
    "dropout_downgrade": ("dropout", {"X": [_f(4, 5)]},
                          {"dropout_prob": 0.3, "is_test": False,
                           "dropout_implementation": "downgrade_in_infer"},
                          ["X"], ["X"]),
    "lookup_table": ("lookup_table", {"W": [_f(7, 4)], "Ids": [_i(7, 3, 5)]},
                     {"padding_idx": 2}, ["W"], ["Ids"]),
    "lookup_table_v2": ("lookup_table_v2",
                        {"W": [_f(7, 4)], "Ids": [_i(7, 3, 1)]},
                        {"padding_idx": -1}, ["W"], ["Ids"]),
    "embedding": ("embedding", {"W": [_f(7, 4)], "Ids": [_i(7, 3, 5)]},
                  {}, ["W"], ["Ids"]),
    "sdpa": ("scaled_dot_product_attention",
             {"Q": [_f(2, 3, 6, 4)], "K": [_f(2, 3, 6, 4)],
              "V": [_f(2, 3, 6, 4)]}, SDPA_ATTRS, ["Q", "K", "V"],
             ["Q", "K", "V"]),
    "sdpa_key_bias": ("scaled_dot_product_attention",
                      {"Q": [_f(2, 3, 6, 4)], "K": [_f(2, 3, 6, 4)],
                       "V": [_f(2, 3, 6, 4)], "KeyBias": [_f(2, 6)]},
                      dict(SDPA_ATTRS, sm_scale=-1.0), ["Q", "K", "V"],
                      ["Q", "K", "V", "KeyBias"]),
    "sdpa_mask_causal": ("scaled_dot_product_attention",
                         {"Q": [_f(2, 3, 6, 4)], "K": [_f(2, 3, 6, 4)],
                          "V": [_f(2, 3, 6, 4)], "Mask": [_attn_mask]},
                         dict(SDPA_ATTRS, causal=True), ["Q", "K", "V"],
                         ["Q", "K", "V", "Mask"]),
    "sdpa_dropout_bias": ("scaled_dot_product_attention",
                          {"Q": [_f(2, 3, 6, 4)], "K": [_f(2, 3, 6, 4)],
                           "V": [_f(2, 3, 6, 4)], "KeyBias": [_f(2, 6)]},
                          dict(SDPA_ATTRS, attn_dropout_prob=0.25),
                          ["Q", "K", "V"], ["Q", "K", "V", "KeyBias"]),
    "fused_linear_softmax_xent": (
        "fused_linear_softmax_xent",
        {"X": [_f(6, 8)], "W": [_f(8, 50)], "Bias": [_f(50)],
         "Label": [_labels_with_tail]}, {"chunk_size": 16},
        ["X", "W", "Bias"], ["X", "Label"]),
    "fused_linear_softmax_xent_nobias": (
        "fused_linear_softmax_xent",
        {"X": [_f(2, 3, 8)], "W": [_f(8, 20)], "Label": [_i(20, 2, 3, 1)]},
        {"chunk_size": 8192}, ["X", "W"], ["X", "Label"]),
    "fused_adam": ("fused_adam", dict(
        {"Param": [_f(4, 3), _f(5)], "Grad": [_f(4, 3), _f(5)],
         "LearningRate": [_const(np.float32([1e-3]))]}, **_ADAM_STATE),
        {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}, [], []),
}
RNG_OPS = {
    "truncated_gaussian_random": {"shape": [64, 64], "dtype": "float32",
                                  "mean": 0.5, "std": 0.02, "seed": 0},
}
#: ops whose reference draws a keep mask: the port's mask is injected
DROPOUT = {"dropout_upscale", "dropout_downgrade", "sdpa_dropout_bias"}
#: float outputs that carry no gradient in the port: layer_norm's Mean and
#: Variance are statistics, as in Paddle's layer_norm_grad, which takes
#: Y's gradient only (the reference's values are held all the same); an
#: XShape holds no data
NO_GRAD_OUTS = {"layer_norm": {"Mean", "Variance"}, "reshape2": {"XShape"},
                "transpose2": {"XShape"}}
#: the fluid slice's op types, held by tests/test_torch_fluid_ops.py
FLUID_SLICE_OPS = {
    "mul", "mean", "scale", "elementwise_add", "relu", "softmax",
    "softmax_with_cross_entropy", "top_k", "fill_constant", "accuracy",
    "sgd", "adam", "fc", "uniform_random", "gaussian_random"}
#: the ResNet slice's op types, held by tests/test_torch_resnet_ops.py
RESNET_SLICE_OPS = {
    "conv2d", "depthwise_conv2d", "pool2d", "batch_norm", "sign", "gather",
    "scatter", "momentum", "fused_sgd", "fused_momentum"}
#: the Transformer slice's op types, held by
#: tests/test_torch_transformer_ops.py
TRANSFORMER_SLICE_OPS = {
    "elementwise_sub", "elementwise_max", "elementwise_min",
    "elementwise_pow", "elementwise_mod", "elementwise_floordiv", "equal",
    "not_equal", "less_than", "less_equal", "greater_than", "greater_equal",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "fill_constant_batch_size_like", "assign_value", "squeeze2",
    "unsqueeze2", "stack", "increment", "one_hot", "label_smooth", "exp",
    "floor", "cos", "where", "sigmoid", "log_softmax", "split", "expand",
    "cumsum", "beam_search", "gather_tree", "beam_search_decode"}
#: the data-parallel slice's op types, held by
#: tests/test_torch_collective_ops.py (sync_batch_norm also by
#: tests/test_torch_fleet_dp.py)
COLLECTIVE_SLICE_OPS = {
    "c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
    "c_allreduce_prod", "c_broadcast", "c_allgather", "c_reducescatter",
    "c_reduce_sum", "alltoall", "c_concat", "c_split", "c_embedding",
    "c_identity", "c_sync_calc_stream", "c_sync_comm_stream", "allreduce",
    "broadcast", "dgc", "sync_batch_norm"}


#: the float16 AMP, LAMB and clipping slice's op types, held by
#: tests/test_torch_math_ops.py: the rest of `math_ops.py` (36), 44 unary
#: elementwise types of `nn_ops.py` and the rest of `optimizer_ops.py`
#: (16)
AMP_SLICE_MATH_OPS = {
    "amp_check_finite_and_scale", "check_finite_and_unscale",
    "update_loss_scaling", "isfinite", "isfinite_v2", "isnan_v2",
    "isinf_v2", "sum", "squared_l2_norm", "clip", "clip_by_norm", "p_norm",
    "l1_norm", "frobenius_norm", "dist", "reduce_all", "reduce_any",
    "reduce_max", "reduce_mean", "reduce_min", "reduce_prod", "matmul_v2",
    "maximum", "minimum", "pow", "minus", "lgamma", "digamma", "erfinv",
    "lerp", "frac", "trunc", "take", "put_along_axis", "masked_fill",
    "searchsorted"}
AMP_SLICE_NN_OPS = set(
    "abs acos acosh asin asinh atan atanh brelu ceil celu cosh elu erf "
    "expm1 hard_shrink hard_sigmoid hard_swish leaky_relu log log10 log1p "
    "log2 logit logsigmoid mish reciprocal relu6 round rsqrt selu silu sin "
    "sinh soft_relu softplus softshrink softsign sqrt square stanh swish "
    "tan tanh_shrink thresholded_relu".split())
AMP_SLICE_OPT_OPS = {
    "lamb", "lars_momentum", "adamw", "adamax", "adagrad",
    "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "dpsgd",
    "proximal_gd", "proximal_adagrad", "lookahead_step",
    "average_accumulates", "dgc_momentum", "dgc_clip_by_norm"}
AMP_SLICE_OPS = AMP_SLICE_MATH_OPS | AMP_SLICE_NN_OPS | AMP_SLICE_OPT_OPS
#: the large-batch slice's op types, held by
#: tests/test_torch_tensor_ops.py: the rest of `tensor_ops.py` (63), the
#: rest of `rng_ops.py` (10) and `pad`, `pad2d` of `nn_ops.py`
TENSOR_SLICE_TENSOR_OPS = set(
    "allclose arg_max arg_min argsort broadcast_to concat crop crop_tensor "
    "diag diag_embed diag_v2 diagonal expand_as expand_as_v2 expand_v2 eye "
    "fill fill_any_like fill_zeros_like fill_zeros_like2 flatten flatten2 "
    "flatten_contiguous_range flip gather_nd gaussian_random_batch_size_like "
    "index_sample index_select is_empty isclose linspace logspace "
    "masked_select merge_ids meshgrid numel pad3d pad_constant_like "
    "partial_concat partial_sum range rank reshape reverse roll scatter_nd "
    "scatter_nd_add shape shard_index size split_ids squeeze strided_slice "
    "tile top_k_v2 transpose tril_triu unbind unique unique_with_counts "
    "unsqueeze unstack where_index".split())
TENSOR_SLICE_RNG_OPS = {
    "bernoulli", "exponential", "gumbel_softmax", "multinomial", "poisson",
    "randint", "randperm", "sampling_id", "seed",
    "uniform_random_batch_size_like"}
TENSOR_SLICE_OPS = TENSOR_SLICE_TENSOR_OPS | TENSOR_SLICE_RNG_OPS \
    | {"pad", "pad2d"}


def test_cases_cover_the_registry():
    """Every op type the port registers is held here, by
    tests/test_torch_fluid_ops.py, tests/test_torch_resnet_ops.py,
    tests/test_torch_transformer_ops.py, tests/test_torch_tensor_ops.py,
    tests/test_torch_collective_ops.py or tests/test_torch_math_ops.py."""
    types = {c[0] for c in CASES.values()} | set(RNG_OPS)
    assert types | FLUID_SLICE_OPS | RESNET_SLICE_OPS \
        | TRANSFORMER_SLICE_OPS | COLLECTIVE_SLICE_OPS | AMP_SLICE_OPS \
        | TENSOR_SLICE_OPS == set(treg.registered_ops())
    assert (len(AMP_SLICE_MATH_OPS), len(AMP_SLICE_NN_OPS),
            len(AMP_SLICE_OPT_OPS)) == (36, 44, 16)
    assert (len(TENSOR_SLICE_TENSOR_OPS), len(TENSOR_SLICE_RNG_OPS),
            len(TENSOR_SLICE_OPS)) == (63, 10, 75)
    assert not (types | FLUID_SLICE_OPS | RESNET_SLICE_OPS
                | TRANSFORMER_SLICE_OPS | COLLECTIVE_SLICE_OPS
                | AMP_SLICE_OPS) & TENSOR_SLICE_OPS
    assert not (types | FLUID_SLICE_OPS | RESNET_SLICE_OPS
                | TRANSFORMER_SLICE_OPS | COLLECTIVE_SLICE_OPS) \
        & AMP_SLICE_OPS and len(treg.registered_ops()) == 272
    assert not (types | FLUID_SLICE_OPS | RESNET_SLICE_OPS
                | TRANSFORMER_SLICE_OPS) & COLLECTIVE_SLICE_OPS \
        and len(COLLECTIVE_SLICE_OPS) == 19
    assert not types & FLUID_SLICE_OPS and len(types) == 21
    assert not (types | FLUID_SLICE_OPS) & RESNET_SLICE_OPS
    assert not (types | FLUID_SLICE_OPS | RESNET_SLICE_OPS) \
        & TRANSFORMER_SLICE_OPS and len(TRANSFORMER_SLICE_OPS) == 36


def _inputs(name):
    r = np.random.RandomState(sorted(CASES).index(name))
    return {slot: [make(r) for make in makers]
            for slot, makers in CASES[name][1].items()}


def _to_torch(a, grad=False):
    t = torch.as_tensor(a, dtype=to_torch_dtype(a.dtype))
    return t.requires_grad_(True) if grad else t


def _port(op_type, ins, attrs, seed=7):
    # the device seed (dropout, attention) and the host generator (the
    # initializers)
    attrs = dict(attrs, _device=torch.device("cpu"),
                 _rng_seed=seed_tensor(seed, "cpu"),
                 _rng_generator=torch.Generator().manual_seed(seed))
    return treg.normalize_outs(treg.get_op(op_type).compute(ins, attrs))


def _port_keep_mask(name, ins):
    """The keep mask the port's op draws for `name`'s inputs (its device
    seed 7, as `_port` passes it)."""
    op_type, _, attrs, _, _ = CASES[name]
    if op_type == "dropout":
        shape = ins["X"][0].shape
    else:
        q, k = ins["Q"][0], ins["K"][0]
        shape = q.shape[:-1] + (k.shape[-2],)
    return keep_mask(seed_tensor(7, "cpu"), shape, attrs.get(
        "dropout_prob", attrs.get("attn_dropout_prob"))).numpy()


def _reference(name, ins, monkeypatch):
    op_type, _, attrs, _, _ = CASES[name]
    attrs = dict(attrs)
    if CASES[name][0] in ("dropout", "scaled_dot_product_attention"):
        attrs["_rng_key"] = make_key(0)
    if name in DROPOUT:
        keep = jnp.asarray(_port_keep_mask(name, ins))
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, p, shape: keep)

    def compute(full):
        return rreg.normalize_outs(rreg.get_op(op_type).compute(
            full, dict(attrs)))

    return compute


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_reference(name, monkeypatch):
    op_type, _, attrs, diff_slots, _ = CASES[name]
    ins = _inputs(name)
    compute = _reference(name, ins, monkeypatch)
    r_out = compute({s: [jnp.asarray(a) for a in v]
                     for s, v in ins.items()})
    t_ins = {s: [_to_torch(a, s in diff_slots) for a in v]
             for s, v in ins.items()}
    t_out = _port(op_type, t_ins, attrs)
    assert sorted(r_out) == sorted(t_out)
    for slot in r_out:
        assert len(r_out[slot]) == len(t_out[slot]), slot
        for rv, tv in zip(r_out[slot], t_out[slot]):
            rv, tv = np.asarray(rv), tv.detach().numpy()
            assert (tv.dtype, tv.shape) == (rv.dtype, rv.shape), slot
            if np.issubdtype(rv.dtype, np.floating):
                np.testing.assert_allclose(tv, rv, rtol=RTOL, atol=ATOL,
                                           err_msg=slot)
            else:
                np.testing.assert_array_equal(tv, rv, err_msg=slot)
    if not diff_slots:
        return

    float_outs = sorted(s for s in r_out
                        if np.issubdtype(np.asarray(r_out[s][0]).dtype,
                                         np.floating)
                        and s not in NO_GRAD_OUTS.get(op_type, ()))
    cr = np.random.RandomState(99)
    cts = {s: cr.randn(*np.asarray(r_out[s][0]).shape).astype("float32")
           for s in float_outs}

    def fwd(diff):
        full = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
        full.update(diff)
        outs = compute(full)
        return {s: outs[s][0] for s in float_outs}

    diff_in = {s: [jnp.asarray(a) for a in ins[s]] for s in diff_slots}
    _, vjp = jax.vjp(fwd, diff_in)
    r_grads = vjp({s: jnp.asarray(c) for s, c in cts.items()})[0]
    leaves = [t_ins[s][0] for s in diff_slots]
    t_grads = torch.autograd.grad(
        [t_out[s][0] for s in float_outs], leaves,
        grad_outputs=[torch.as_tensor(cts[s]) for s in float_outs])
    for s, tg in zip(diff_slots, t_grads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(r_grads[s][0]),
                                   rtol=RTOL, atol=ATOL, err_msg="d" + s)
    for s in NO_GRAD_OUTS.get(op_type, ()):
        assert not t_out[s][0].requires_grad, s


def _specs(name):
    _, _, _, _, batch_slots = CASES[name]
    return {s: [((-1,) + a.shape[1:] if s in batch_slots else a.shape,
                 str(a.dtype)) for a in v]
            for s, v in _inputs(name).items()}


@pytest.mark.parametrize("name", sorted(CASES) + sorted(RNG_OPS))
def test_infer_outputs_matches_reference(name):
    if name in RNG_OPS:
        op_type, specs, attrs = name, {}, RNG_OPS[name]
    else:
        op_type, attrs, specs = CASES[name][0], CASES[name][2], _specs(name)
    assert treg.infer_outputs(op_type, specs, dict(attrs)) == \
        rreg.infer_outputs(op_type, specs, dict(attrs))


def test_truncated_gaussian_shape_dtype_range():
    attrs = RNG_OPS["truncated_gaussian_random"]
    ref = np.asarray(rreg.get_op("truncated_gaussian_random").compute(
        {}, dict(attrs, _rng_key=make_key(0)))["Out"])
    out = _port("truncated_gaussian_random", {}, attrs)["Out"][0].numpy()
    assert (out.dtype, out.shape) == (ref.dtype, ref.shape)
    mean, std = attrs["mean"], attrs["std"]
    # truncated at two standard deviations, as the reference draws it
    assert mean - 2 * std <= out.min() and out.max() <= mean + 2 * std
    # 4096 draws: the standard normal truncated to [-2, 2] has std 0.880
    assert abs(out.mean() - mean) < 5 * 0.88 * std / 64
    assert abs(out.std() / std - 0.880) < 0.05
    again = _port("truncated_gaussian_random", {}, attrs)["Out"][0].numpy()
    np.testing.assert_array_equal(again, out)


def test_dropout_keeps_one_minus_p():
    x = torch.ones(200, 100)
    out = _port("dropout", {"X": [x]}, CASES["dropout_upscale"][2])
    keep = out["Mask"][0]
    assert keep.dtype == torch.uint8
    assert abs(keep.float().mean().item() - 0.7) < 0.02
    np.testing.assert_allclose(out["Out"][0].numpy(),
                               keep.numpy() / 0.7, rtol=1e-6)


@pytest.mark.parametrize("vocab,chunk", [(50, 16), (50, 64), (8192, 8192)])
def test_linear_xent_matches_unfused(vocab, chunk):
    """The fused head against the unfused chain it replaces: the [N, V]
    logits x w + b, then log-softmax and the label's entry; loss and the
    gradients of x, w and b within rtol 1e-5."""
    r = np.random.RandomState(vocab + chunk)
    x, w, b = (torch.tensor(r.randn(*s).astype("float32") * 0.5,
                            requires_grad=True)
               for s in ((9, 16), (16, vocab), (vocab,)))
    label = torch.tensor(r.randint(0, vocab, (9, 1)))
    label[0, 0] = vocab - 1
    fused = _port("fused_linear_softmax_xent",
                  {"X": [x], "W": [w], "Bias": [b], "Label": [label]},
                  {"chunk_size": chunk})["Loss"][0]
    logits = x @ w + b
    plain = -torch.log_softmax(logits, -1).gather(1, label)
    np.testing.assert_allclose(fused.detach().numpy(),
                               plain.detach().numpy(), rtol=RTOL, atol=ATOL)
    ct = torch.tensor(r.randn(9, 1).astype("float32"))
    for g_f, g_p in zip(torch.autograd.grad(fused, (x, w, b), ct),
                        torch.autograd.grad(plain, (x, w, b), ct)):
        np.testing.assert_allclose(g_f.numpy(), g_p.numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_linear_xent_bf16_accumulates_in_float32():
    """bf16 operands (AMP): the loss is float32 and equals the float32
    head run on the bf16-rounded operands, and the gradients keep the
    operands' dtypes."""
    r = np.random.RandomState(0)
    x, w = (torch.tensor(r.randn(*s).astype("float32")).bfloat16()
            .requires_grad_(True) for s in ((6, 32), (32, 40)))
    label = torch.tensor(r.randint(0, 40, (6, 1)))
    out = _port("fused_linear_softmax_xent",
                {"X": [x], "W": [w], "Label": [label]},
                {"chunk_size": 16})["Loss"][0]
    ref = _port("fused_linear_softmax_xent",
                {"X": [x.detach().float()], "W": [w.detach().float()],
                 "Label": [label]}, {"chunk_size": 16})["Loss"][0]
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), rtol=RTOL,
                               atol=ATOL)
    gx, gw = torch.autograd.grad(out.sum(), (x, w))
    assert (gx.dtype, gw.dtype) == (torch.bfloat16, torch.bfloat16)


def test_sdpa_views_on_cpu_take_the_composite_path():
    """On the CPU the op never takes the flash kernels, whatever the key
    length: a key bias that masks the second half gives the attention of
    the first half alone."""
    r = np.random.RandomState(3)
    q, k, v = (torch.tensor(r.randn(1, 2, 8, 4).astype("float32"))
               for _ in range(3))
    bias = torch.zeros(1, 8)
    bias[:, 4:] = -1e30
    out = _port("scaled_dot_product_attention",
                {"Q": [q], "K": [k], "V": [v], "KeyBias": [bias]},
                dict(SDPA_ATTRS, sm_scale=0.5))["Out"][0]
    half = _port("scaled_dot_product_attention",
                 {"Q": [q], "K": [k[:, :, :4]], "V": [v[:, :, :4]]},
                 dict(SDPA_ATTRS, sm_scale=0.5))["Out"][0]
    np.testing.assert_allclose(out.numpy(), half.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_head_split_ops_return_views():
    """slice -> reshape2 -> transpose2 of a fused [B, S, 3H] projection
    (the scan encoder's head split) copies nothing."""
    qkv = torch.randn(2, 5, 3 * 8)
    k = _port("slice", {"Input": [qkv]},
              {"axes": [2], "starts": [8], "ends": [16]})["Out"][0]
    k = _port("reshape2", {"X": [k]}, {"shape": [0, 0, 2, 4]})["Out"][0]
    k = _port("transpose2", {"X": [k]}, {"axis": [0, 2, 1, 3]})["Out"][0]
    assert k.untyped_storage().data_ptr() == \
        qkv.untyped_storage().data_ptr()
    assert k.shape == (2, 2, 5, 4)
    np.testing.assert_array_equal(
        k.numpy(), qkv[:, :, 8:16].reshape(2, 5, 2, 4).permute(0, 2, 1, 3)
        .numpy())
