"""Neural-network operators of the slice (counterpart:
`paddle_tpu/ops/nn_ops.py`): `relu`, `sigmoid`, `tanh`, `gelu`, `sign`,
`exp`, `floor`, `cos` and the reference's 44 other unary elementwise
types (`_UNARY`, attrs and defaults as the reference reads them),
`softmax`, `log_softmax`, `softmax_with_cross_entropy` (hard labels with
`ignore_index`, or soft labels), `one_hot`, `label_smooth`, `conv2d` / `depthwise_conv2d`, `pool2d`, `batch_norm`,
`layer_norm`, `dropout`, `pad`, `pad2d`, the embedding lookups and
`scaled_dot_product_attention`; and the rest of the reference's file:
`prelu`, the losses (`cross_entropy` of probabilities,
`sigmoid_cross_entropy_with_logits`, `square_error_cost`, `huber_loss`,
`smooth_l1_loss`, `kldiv_loss`), `conv2d_transpose`, `conv3d`,
`conv3d_transpose`, `pool3d`, `max_pool2d_with_index`, `spp`, the norms
(`instance_norm`, `group_norm`, `norm`, `lrn`, `spectral_norm`,
`data_norm`), `lstm_seq`, `gru_seq` and the rearrangements and samplers
(`interp_nearest`, `one_hot_v2`, `maxout`, `row_conv`, `affine_channel`,
`fsp`, `pixel_shuffle`, `shuffle_channel`, `space_to_depth`,
`temporal_shift`, `grid_sampler`, `affine_grid`, `unfold`,
`im2sequence`).

The convolutions are cuDNN's on the card; `pool3d`'s max gradient there
is summed in a fixed order (`_SortedMaxPool3d`), so under
`FLAGS_cudnn_deterministic` the four repeat bit for bit. So is the
gradient of `pad2d`'s and `pad3d`'s reflect, edge and replicate modes
(`_SortedModePad`), at any setting. Where the
reference departs from Paddle, the port follows Paddle: `maxout` takes a
negative axis, and `conv3d_transpose` pads as Paddle's transposed
convolution does (ROADMAP Queue 3, reference-side).

`conv2d` is `F.conv2d` (cuDNN on the card), NCHW input and OIHW filter.
`pool2d` pads as the reference's `lax.reduce_window` does (the left
padding, then on the right exactly what the last window needs, so
`ceil_mode` windows end where the reference's do) and pools the padded
tensor. `batch_norm` keeps Paddle's running-statistics convention, not
PyTorch's: the biased batch variance, `mean_out = mean * momentum +
batch_mean * (1 - momentum)`, `SavedVariance = 1/sqrt(var + eps)`, new
tensors for every output and no gradient through the statistics.

A hard label outside the classes gives the reference's answer without a
host sync or a device-side assert: a negative label counts from the last
class, one beyond the classes a NaN loss, an `ignore_index` label a zero
loss.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register_op
from .rnn_unit_ops import _batch_major, _cudnn_dir, _time_major
from ..core.place import deterministic_algorithms
from ..core.rng import flash_seed
from ..utils.flags import get_flag


@register_op("relu")
def _relu(ins, attrs):
    return {"Out": torch.relu(ins["X"][0])}


@register_op("sigmoid")
def _sigmoid(ins, attrs):
    return {"Out": torch.sigmoid(ins["X"][0])}


@register_op("tanh")
def _tanh(ins, attrs):
    return {"Out": torch.tanh(ins["X"][0])}


@register_op("gelu")
def _gelu(ins, attrs):
    return {"Out": F.gelu(ins["X"][0], approximate="tanh" if attrs.get(
        "approximate", False) else "none")}


@register_op("sign")
def _sign(ins, attrs):
    return {"Out": torch.sign(ins["X"][0])}


@register_op("exp")
def _exp(ins, attrs):
    return {"Out": torch.exp(ins["X"][0])}


@register_op("floor")
def _floor(ins, attrs):
    return {"Out": torch.floor(ins["X"][0])}


@register_op("cos")
def _cos(ins, attrs):
    return {"Out": torch.cos(ins["X"][0])}


def _softplus(x):
    """log(1 + e^x), as `jax.nn.softplus` (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _where0(cond, x):
    return torch.where(cond, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _celu(x, alpha):
    return torch.where(x > 0, x, alpha * (torch.exp(x / alpha) - 1.0))


def _logit(x, eps):
    xc = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(xc / (1.0 - xc))


def _softshrink(x, a):
    lam = a.get("lambda", a.get("threshold", 0.5))
    return torch.where(x > lam, x - lam, _where0(x < -lam, x + lam))


#: the unary elementwise types the reference registers beside relu,
#: sigmoid, tanh, gelu, sign, exp, floor and cos: type -> fn(x, attrs)
_UNARY = {
    "abs": lambda x, a: torch.abs(x),
    "acos": lambda x, a: torch.acos(x),
    "acosh": lambda x, a: torch.acosh(x),
    "asin": lambda x, a: torch.asin(x),
    "asinh": lambda x, a: torch.asinh(x),
    "atan": lambda x, a: torch.atan(x),
    "atanh": lambda x, a: torch.atanh(x),
    "brelu": lambda x, a: torch.clamp(x, a.get("t_min", 0.0),
                                      a.get("t_max", 24.0)),
    "ceil": lambda x, a: torch.ceil(x),
    "celu": lambda x, a: _celu(x, a.get("alpha", 1.0)),
    "cosh": lambda x, a: torch.cosh(x),
    "elu": lambda x, a: torch.where(
        x >= 0, x, a.get("alpha", 1.0) * (torch.exp(x) - 1)),
    "erf": lambda x, a: torch.erf(x),
    "expm1": lambda x, a: torch.expm1(x),
    "hard_shrink": lambda x, a: _where0(
        torch.abs(x) > a.get("threshold", 0.5), x),
    "hard_sigmoid": lambda x, a: torch.clamp(
        a.get("slope", 0.2) * x + a.get("offset", 0.5), 0.0, 1.0),
    "hard_swish": lambda x, a: x * torch.clamp(
        x + a.get("offset", 3.0), 0.0, a.get("threshold", 6.0))
    / a.get("scale", 6.0),
    "leaky_relu": lambda x, a: torch.where(x >= 0, x,
                                           x * a.get("alpha", 0.02)),
    "log": lambda x, a: torch.log(x),
    "log10": lambda x, a: torch.log10(x),
    "log1p": lambda x, a: torch.log1p(x),
    "log2": lambda x, a: torch.log2(x),
    "logit": lambda x, a: _logit(x, a.get("eps", 1e-6)),
    "logsigmoid": lambda x, a: -_softplus(-x),
    "mish": lambda x, a: x * torch.tanh(_softplus(x)),
    "reciprocal": lambda x, a: 1.0 / x,
    "relu6": lambda x, a: torch.clamp(x, 0.0, a.get("threshold", 6.0)),
    "round": lambda x, a: torch.round(x),
    "rsqrt": lambda x, a: torch.rsqrt(x),
    "selu": lambda x, a: a.get("scale", 1.0507009873554805) * torch.where(
        x > 0, x, a.get("alpha", 1.6732632423543772) * (torch.exp(x) - 1.0)),
    "silu": lambda x, a: x * torch.sigmoid(x),
    "sin": lambda x, a: torch.sin(x),
    "sinh": lambda x, a: torch.sinh(x),
    "soft_relu": lambda x, a: torch.log1p(torch.exp(torch.clamp(
        x, -a.get("threshold", 40.0), a.get("threshold", 40.0)))),
    "softplus": lambda x, a: _softplus(x),
    "softshrink": _softshrink,
    "softsign": lambda x, a: x / (1 + torch.abs(x)),
    "sqrt": lambda x, a: torch.sqrt(x),
    "square": lambda x, a: torch.square(x),
    "stanh": lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
        a.get("scale_a", 0.67) * x),
    "swish": lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x),
    "tan": lambda x, a: torch.tan(x),
    "tanh_shrink": lambda x, a: x - torch.tanh(x),
    "thresholded_relu": lambda x, a: _where0(
        x > a.get("threshold", 1.0), x),
}


def _register_unary(name, fn):
    @register_op(name)
    def _unary(ins, attrs, _fn=fn):
        return {"Out": _fn(ins["X"][0], attrs)}


for _name, _fn in _UNARY.items():
    _register_unary(_name, _fn)


@register_op("one_hot")
def _one_hot(ins, attrs):
    """[..., 1] ids -> [..., depth] float32 rows; an id outside
    [0, depth) gives a row of zeros (as `jax.nn.one_hot`)."""
    x = ins["X"][0]
    ids = x.reshape(x.shape[:-1]).to(torch.int32)
    classes = torch.arange(attrs["depth"], dtype=torch.int32,
                           device=x.device)
    return {"Out": (ids.unsqueeze(-1) == classes).to(torch.float32)}


@register_op("label_smooth")
def _label_smooth(ins, attrs):
    """(1 - epsilon) * X + epsilon * PriorDist, or epsilon / classes
    without a prior."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 0.0)
    if ins.get("PriorDist"):
        return {"Out": (1 - eps) * x + eps * ins["PriorDist"][0]}
    return {"Out": (1 - eps) * x + eps / x.shape[-1]}


@register_op("softmax")
def _softmax(ins, attrs):
    return {"Out": torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))}


@register_op("log_softmax")
def _log_softmax(ins, attrs):
    return {"Out": torch.log_softmax(ins["X"][0],
                                     dim=attrs.get("axis", -1))}


@register_op("softmax_with_cross_entropy")
def _softmax_ce(ins, attrs):
    logits, label = ins["Logits"][0], ins["Label"][0]
    axis = attrs.get("axis", -1) % logits.ndim
    softmax = torch.softmax(logits, dim=axis)
    logp = torch.log_softmax(logits, dim=axis)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        idx = label.to(torch.int32)
        if idx.ndim == logits.ndim and idx.shape[axis] == 1:
            idx = idx.squeeze(axis)
        idx = idx.unsqueeze(axis)
        n_cls = logits.shape[axis]
        valid = (idx >= -n_cls) & (idx < n_cls)
        loss = -torch.gather(logp, axis, torch.remainder(idx, n_cls).long())
        loss = loss.masked_fill(~valid, float("nan")).masked_fill(
            idx == attrs.get("ignore_index", -100), 0.0)
    return {"Softmax": softmax, "Loss": loss}


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


@register_op("conv2d")
def _conv2d(ins, attrs):
    """NCHW input, OIHW filter; `paddings` is [ph, pw] or [top, bottom,
    left, right]. The result is in the promoted dtype of the two (under
    AMP both are bf16)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    dt = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(dt), w.to(dt)
    pads = _pair(attrs.get("paddings", [0, 0]))
    if len(pads) == 4 and (pads[0] != pads[1] or pads[2] != pads[3]):
        x = F.pad(x, (pads[2], pads[3], pads[0], pads[1]))
        pads = [0, 0]
    elif len(pads) == 4:
        pads = [pads[0], pads[2]]
    return {"Output": F.conv2d(
        x, w, None, stride=_pair(attrs.get("strides", [1, 1])),
        padding=pads, dilation=_pair(attrs.get("dilations", [1, 1])),
        groups=int(attrs.get("groups", 1)))}


@register_op("depthwise_conv2d")
def _depthwise_conv2d(ins, attrs):
    return _conv2d(ins, attrs)


def _pool_pads(dims, ksize, strides, paddings, ceil_mode):
    """The reference's (left, right) padding of each spatial dim: the
    left is the attr, the right what the last window needs beyond the
    input (`ceil_mode` counts one more window where a partial one
    remains)."""
    pads = []
    for dim, k, s, p in zip(dims, ksize, strides, paddings):
        span = dim + 2 * p - k
        out = (-(-span // s) if ceil_mode else span // s) + 1
        pads.append((p, max(0, (out - 1) * s + k - dim - p)))
    return pads


@register_op("pool2d")
def _pool2d(ins, attrs):
    """max or avg over NCHW windows; `global_pooling` (or adaptive to 1 x
    1) reduces H and W; `adaptive` splits H and W into equal windows;
    otherwise the padded input is pooled with no further padding, and
    an `exclusive` average divides by the window's count of input
    cells."""
    x = ins["X"][0]
    is_max = attrs.get("pooling_type", "max") == "max"
    ksize = _pair(attrs.get("ksize", [2, 2]))
    adaptive = attrs.get("adaptive", False)
    if attrs.get("global_pooling", False) or (
            adaptive and tuple(ksize) == (1, 1)):
        return {"Out": torch.amax(x, dim=(2, 3), keepdim=True) if is_max
                else torch.mean(x, dim=(2, 3), keepdim=True)}
    if adaptive:
        n, c, h, w = x.shape
        oh, ow = ksize
        if h % oh or w % ow:
            raise ValueError("adaptive pool2d needs H and W divisible by "
                             "the output size, got %s and %s"
                             % ((h, w), (oh, ow)))
        xr = x.reshape(n, c, oh, h // oh, ow, w // ow)
        return {"Out": torch.amax(xr, dim=(3, 5)) if is_max
                else torch.mean(xr, dim=(3, 5))}
    strides = _pair(attrs.get("strides", ksize))
    (pt, pb), (pl, pr) = _pool_pads(
        x.shape[2:], ksize, strides, _pair(attrs.get("paddings", [0, 0])),
        attrs.get("ceil_mode", False))
    if is_max:
        xp = F.pad(x, (pl, pr, pt, pb), value=float("-inf"))
        return {"Out": F.max_pool2d(xp, ksize, strides)}
    out = F.avg_pool2d(F.pad(x, (pl, pr, pt, pb)), ksize, strides,
                       divisor_override=1)
    if attrs.get("exclusive", True):
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        cnt = F.avg_pool2d(F.pad(ones, (pl, pr, pt, pb)), ksize, strides,
                           divisor_override=1)
        return {"Out": out / cnt}
    return {"Out": out / float(ksize[0] * ksize[1])}


@register_op("batch_norm")
def _batch_norm(ins, attrs):
    """Batch norm over every axis but the channel's (NCHW: 1; NHWC: the
    last), in float32 whatever X's dtype; Y in X's dtype. Training uses
    the batch's statistics and moves the running ones by Paddle's rule;
    `is_test` or `use_global_stats` normalizes with the running ones and
    passes them through. `fused_act` "relu" applies a relu to Y."""
    x = ins["X"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    use_running = attrs.get("is_test", False) or attrs.get(
        "use_global_stats", False)
    xf = x.float()
    if attrs.get("data_layout", "NCHW") != "NCHW":
        xf = xf.movedim(-1, 1)
    y, bmean, invstd = torch.native_batch_norm(
        xf, ins["Scale"][0].float(), ins["Bias"][0].float(),
        mean.float() if use_running else None,
        var.float() if use_running else None, not use_running, 0.0, eps)
    if attrs.get("data_layout", "NCHW") != "NCHW":
        y = y.movedim(1, -1)
    if attrs.get("fused_act") == "relu":
        y = torch.relu(y)
    with torch.no_grad():
        if use_running:
            saved = (mean, torch.reciprocal(torch.sqrt(var + eps)))
            stats = (mean, var)
        else:
            # the biased variance the normalization used
            bvar = torch.reciprocal(torch.square(invstd)) - eps
            saved = (bmean, invstd)
            stats = (mean * momentum + bmean.to(mean.dtype) * (1 - momentum),
                     var * momentum + bvar.to(var.dtype) * (1 - momentum))
    return {"Y": y.to(x.dtype), "MeanOut": stats[0],
            "VarianceOut": stats[1], "SavedMean": saved[0],
            "SavedVariance": saved[1]}


@register_op("layer_norm")
def _layer_norm(ins, attrs):
    """Normalizes over the axes from begin_norm_axis on, in float32
    whatever x's dtype; Y in x's dtype, Mean and Variance float32 over
    the leading axes."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    norm_shape = tuple(x.shape[begin:])
    scale = ins["Scale"][0].float().reshape(norm_shape) \
        if ins.get("Scale") else None
    bias = ins["Bias"][0].float().reshape(norm_shape) \
        if ins.get("Bias") else None
    y, mean, rstd = torch.native_layer_norm(x.float(), norm_shape, scale,
                                            bias, eps)
    red_shape = tuple(x.shape[:begin])
    with torch.no_grad():
        var = torch.reciprocal(torch.square(rstd)) - eps
    return {"Y": y.to(x.dtype), "Mean": mean.detach().reshape(red_shape),
            "Variance": var.reshape(red_shape)}


@register_op("pad")
def _pad(ins, attrs):
    """X padded with `pad_value` by `paddings`, a (before, after) pair a
    dim, dims in order."""
    x = ins["X"][0]
    p = [int(v) for v in attrs["paddings"]]
    pads = []
    for i in reversed(range(x.ndim)):
        pads += [p[2 * i], p[2 * i + 1]]
    return {"Out": F.pad(x, pads, value=float(attrs.get("pad_value", 0.0)))}


@register_op("pad2d")
def _pad2d(ins, attrs):
    """NCHW X padded by `paddings` [top, bottom, left, right]: with
    `pad_value` ("constant"), or "reflect" or "edge"."""
    x = ins["X"][0]
    t, b, l, r = (int(v) for v in attrs["paddings"])
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return {"Out": F.pad(x, [l, r, t, b],
                             value=float(attrs.get("pad_value", 0.0)))}
    return {"Out": mode_pad(x, [l, r, t, b], {"reflect": "reflect",
                                              "edge": "replicate"}[mode])}


class _SortedModePad(torch.autograd.Function):
    """`F.pad` in a mode that copies cells of X (reflect, replicate,
    circular) whose gradient on the card is summed into each cell of X
    in a fixed order (`index_put_` with accumulate under PyTorch's
    deterministic algorithms). The default CUDA backwards of reflect and
    replicate add with atomics, so two runs differ in the last bits."""

    @staticmethod
    def forward(ctx, x, pads, mode):
        ctx.x_shape, ctx.pads, ctx.mode = x.shape, pads, mode
        return F.pad(x, pads, mode=mode)

    @staticmethod
    def backward(ctx, g):
        spatial = ctx.x_shape[2:]
        n = math.prod(spatial)
        # the source cell of each output cell: padding float64 cell
        # numbers (exact to 2**53) the same way
        src = F.pad(torch.arange(n, dtype=torch.float64, device=g.device)
                    .reshape((1, 1) + tuple(spatial)), ctx.pads,
                    mode=ctx.mode).long().reshape(1, -1)
        nc = ctx.x_shape[0] * ctx.x_shape[1]
        planes = torch.arange(nc, device=g.device).reshape(nc, 1)
        with deterministic_algorithms():
            gx = g.new_zeros((nc, n)).index_put_(
                (planes.expand(nc, src.shape[1]), src.expand(nc, -1)),
                g.reshape(nc, -1), accumulate=True)
        return gx.reshape(ctx.x_shape), None, None


def mode_pad(x, pads, mode):
    """`F.pad(x, pads, mode=mode)` for reflect, replicate and circular,
    its gradient on the card summed in a fixed order (`_SortedModePad`)."""
    if x.is_cuda and x.requires_grad:
        return _SortedModePad.apply(x, list(pads), mode)
    return F.pad(x, pads, mode=mode)


@register_op("dropout", rng="device")
def _dropout(ins, attrs):
    """Training: `kernels.dropout` under the op's device seed (the CUDA
    kernel on the card, its plain version elsewhere), Out and the uint8
    Mask. `is_test`: no mask drawn."""
    from .kernels.dropout import dropout

    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    upscale = attrs.get("dropout_implementation",
                        "downgrade_in_infer") == "upscale_in_train"
    if attrs.get("is_test", False):
        return {"Out": x if upscale else x * (1.0 - p),
                "Mask": torch.ones(x.shape, dtype=torch.uint8,
                                   device=x.device)}
    out, mask = dropout(x, attrs["_rng_seed"], p, upscale=upscale)
    return {"Out": out, "Mask": mask}


class _SortedLookup(torch.autograd.Function):
    """`F.embedding` whose weight gradient on the card takes PyTorch's
    deterministic CUDA path (sort the ids, then sum each id's rows in
    order). The default path sums the rows of an id that repeats often
    (BERT's position and segment ids) in another order each run, so two
    runs, or a captured and an eager step, differ in those rows."""

    @staticmethod
    def forward(ctx, w, ids):
        ctx.save_for_backward(ids)
        ctx.rows = w.shape[0]
        return F.embedding(ids, w)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        with deterministic_algorithms():
            gw = torch.ops.aten.embedding_dense_backward(
                g, ids, ctx.rows, -1, False)
        return gw, None


def _lookup(w, ids, padding_idx):
    out = _SortedLookup.apply(w, ids) if w.is_cuda and w.requires_grad \
        else F.embedding(ids, w)
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype,
                                      device=out.device), out)
    return out


@register_op("lookup_table")
def _lookup_table(ins, attrs):
    w, ids = ins["W"][0], ins["Ids"][0]
    # v1 ids carry a trailing [..., 1] dim; squeeze it
    if ids.ndim > 1 and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    return {"Out": _lookup(w, ids, attrs.get("padding_idx", -1))}


@register_op("lookup_table_v2")
def _lookup_table_v2(ins, attrs):
    return {"Out": _lookup(ins["W"][0], ins["Ids"][0],
                           attrs.get("padding_idx", -1))}


@register_op("embedding")
def _embedding(ins, attrs):
    return _lookup_table_v2(ins, attrs)


@register_op("scaled_dot_product_attention", rng="device")
def _sdpa(ins, attrs):
    """Attention over Q, K, V [B, H, S, D] with an optional additive key
    bias KeyBias [B, Sk] or a full Mask (bool: True attends; float:
    added), in the reference's order:

    - on the card, with no Mask and Sk >= FLAGS_flash_attention_min_seq:
      the flash kernels, with dropout inside them (their hash of an int32
      seed derived on the device from the op's seed, `rng.flash_seed`,
      which the kernels read through a pointer);
      ``attrs["flash_impl"] = "reference"`` runs their plain version
      with the same hash instead;
    - with dropout off: `reference_attention` (float32);
    - otherwise the unfused path: float32 scores and softmax, dropout
      on the probabilities (`kernels.dropout` under the op's seed), and
      the probabilities in V's dtype for the second product.

    The reference takes the kernel on the TPU only; the port on CUDA."""
    from .kernels.dropout import dropout
    from .kernels.flash_attention import flash_attention, \
        reference_attention

    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    bias = ins["KeyBias"][0] if ins.get("KeyBias") else None
    mask = ins["Mask"][0] if ins.get("Mask") else None
    causal = attrs.get("causal", False)
    sm_scale = attrs.get("sm_scale", None)
    if sm_scale is not None and sm_scale <= 0:
        sm_scale = None
    p_drop = attrs.get("attn_dropout_prob", 0.0)
    drop_active = not attrs.get("is_test", False) and p_drop > 0.0

    if mask is None:
        if q.device.type == "cuda" and k.shape[-2] >= int(
                get_flag("FLAGS_flash_attention_min_seq")):
            seed = flash_seed(attrs["_rng_seed"]) if drop_active else None
            return {"Out": flash_attention(
                q, k, v, key_bias=bias, causal=causal, sm_scale=sm_scale,
                dropout_p=p_drop if drop_active else 0.0,
                dropout_seed=seed, impl=attrs.get("flash_impl", "auto"))}
        if not drop_active:
            return {"Out": reference_attention(q, k, v, key_bias=bias,
                                               causal=causal,
                                               sm_scale=sm_scale)}

    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias[:, None, None, :].float()
    if mask is not None:
        # [Sq, Sk] -> [1, 1, Sq, Sk]; [B, Sq, Sk] -> [B, 1, Sq, Sk]
        mask = mask[None, None] if mask.ndim == 2 else (
            mask[:, None] if mask.ndim == 3 else mask)
        s = torch.where(mask, s, torch.full((), -1e30, device=s.device)) \
            if mask.dtype == torch.bool else s + mask.float()
    if causal:
        Sq, Sk = s.shape[-2], s.shape[-1]
        rows = torch.arange(Sq, device=s.device)[:, None]
        cols = torch.arange(Sk, device=s.device)[None, :]
        s = torch.where(rows >= cols, s, torch.full((), -1e30,
                                                    device=s.device))
    probs = torch.softmax(s, dim=-1)
    if drop_active:
        probs, _ = dropout(probs, attrs["_rng_seed"], p_drop)
    return {"Out": torch.matmul(probs.to(q.dtype), v).to(q.dtype)}


# -- the rest of the reference's nn_ops: activations with a weight, losses,
# -- convolutions and pools, norms, recurrences and rearrangements -----------

@register_op("prelu")
def _prelu(ins, attrs):
    """X where X >= 0, else X * Alpha; mode "all" (one alpha), "channel"
    (one per dim-1 channel) or "element" (Alpha shaped like X[0])."""
    x, alpha = ins["X"][0], ins["Alpha"][0]
    if attrs.get("mode", "all") == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
    return {"Out": torch.where(x >= 0, x, x * alpha)}


_CE_EPS = 1e-9


def _take_last(x, idx):
    """x[..., idx] along the last axis as `jnp.take_along_axis` reads it:
    a negative index counts from the end, one outside [-n, n) gives NaN
    (a float x) with no host sync."""
    n = x.shape[-1]
    idx = idx.unsqueeze(-1)
    valid = (idx >= -n) & (idx < n)
    picked = torch.gather(x, -1, torch.remainder(idx, n).long())
    return picked.masked_fill(~valid, float("nan"))


@register_op("cross_entropy")
def _cross_entropy(ins, attrs):
    """-log(X[label] + 1e-9) of probabilities X, an `ignore_index` label
    giving 0; with `soft_label`, -sum(Label * log(X + 1e-9)) over the
    last axis."""
    x, label = ins["X"][0], ins["Label"][0]
    if attrs.get("soft_label", False):
        return {"Y": -torch.sum(label * torch.log(x + _CE_EPS), dim=-1,
                                keepdim=True)}
    idx = label.reshape(label.shape[:-1]).to(torch.int32)
    loss = -torch.log(_take_last(x, idx) + _CE_EPS)
    return {"Y": loss.masked_fill(
        idx.unsqueeze(-1) == attrs.get("ignore_index", -100), 0.0)}


@register_op("sigmoid_cross_entropy_with_logits")
def _sigmoid_ce(ins, attrs):
    """The stable logistic loss of logits X against Label, 0 where the
    label is `ignore_index`; `normalize` divides by the count of the
    other labels (at least 1)."""
    x, label = ins["X"][0], ins["Label"][0]
    loss = torch.clamp_min(x, 0) - x * label + torch.log1p(
        torch.exp(-torch.abs(x)))
    ignore = label == attrs.get("ignore_index", -100)
    loss = loss.masked_fill(ignore, 0.0)
    if attrs.get("normalize", False):
        n = torch.sum((~ignore).to(loss.dtype))
        loss = loss / torch.clamp_min(n, 1.0)
    return {"Out": loss}


@register_op("square_error_cost")
def _square_error_cost(ins, attrs):
    return {"Out": torch.square(ins["X"][0] - ins["Y"][0])}


@register_op("huber_loss")
def _huber_loss(ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    delta = attrs.get("delta", 1.0)
    r = y - x
    a = torch.abs(r)
    return {"Out": torch.where(a <= delta, 0.5 * r * r,
                               delta * (a - 0.5 * delta)), "Residual": r}


@register_op("smooth_l1_loss")
def _smooth_l1_loss(ins, attrs):
    """The smooth L1 distance summed over the last axis, and Diff = X -
    Y (the inside and outside weights are not read, as in the
    reference)."""
    x, y = ins["X"][0], ins["Y"][0]
    s2 = attrs.get("sigma", 1.0) ** 2
    diff = x - y
    a = torch.abs(diff)
    elem = torch.where(a < 1.0 / s2, 0.5 * s2 * diff * diff, a - 0.5 / s2)
    return {"Out": torch.sum(elem, dim=-1, keepdim=True), "Diff": diff}


@register_op("kldiv_loss")
def _kldiv_loss(ins, attrs):
    """Target * (log(Target) - X) where Target > 0, else 0; reduced by
    "mean", "sum" or "batchmean" to a [1] tensor, or kept ("none")."""
    x, target = ins["X"][0], ins["Target"][0]
    loss = _where0(target > 0, target * (torch.log(target) - x))
    red = attrs.get("reduction", "mean")
    if red == "mean":
        loss = torch.mean(loss).reshape(1)
    elif red == "sum":
        loss = torch.sum(loss).reshape(1)
    elif red == "batchmean":
        loss = (torch.sum(loss) / x.shape[0]).reshape(1)
    return {"Loss": loss}


def _triple(v, n=3):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


@register_op("conv2d_transpose")
def _conv2d_transpose(ins, attrs):
    """The transposed 2-D convolution (cuDNN on the card): NCHW input,
    filter (in, out / groups, kh, kw); each output side (H - 1) * stride
    - 2 * padding + dilation * (k - 1) + 1, as the reference's
    lhs-dilated convolution with the flipped filter gives it."""
    x, w = ins["Input"][0], ins["Filter"][0]
    dt = torch.promote_types(x.dtype, w.dtype)
    pads = _pair(attrs.get("paddings", [0, 0]))
    return {"Output": F.conv_transpose2d(
        x.to(dt), w.to(dt), None, stride=_pair(attrs.get("strides", [1, 1])),
        padding=[pads[0], pads[1]], groups=int(attrs.get("groups", 1)),
        dilation=_pair(attrs.get("dilations", [1, 1])))}


@register_op("conv3d")
def _conv3d(ins, attrs):
    """NCDHW input, OIDHW filter, symmetric padding (cuDNN on the
    card)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    dt = torch.promote_types(x.dtype, w.dtype)
    return {"Output": F.conv3d(
        x.to(dt), w.to(dt), None,
        stride=_triple(attrs.get("strides", [1, 1, 1])),
        padding=_triple(attrs.get("paddings", [0, 0, 0])),
        dilation=_triple(attrs.get("dilations", [1, 1, 1])),
        groups=int(attrs.get("groups", 1)))}


@register_op("conv3d_transpose")
def _conv3d_transpose(ins, attrs):
    """Paddle's transposed 3-D convolution (cuDNN on the card): filter
    (in, out / groups, kd, kh, kw), each output side (D - 1) * stride -
    2 * padding + dilation * (k - 1) + 1. The reference pads its
    transposed convolution by `padding` itself, which agrees with this
    only where padding = dilation * (k - 1) / 2 (ROADMAP Queue 3,
    reference-side)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    dt = torch.promote_types(x.dtype, w.dtype)
    return {"Output": F.conv_transpose3d(
        x.to(dt), w.to(dt), None,
        stride=_triple(attrs.get("strides", [1, 1, 1])),
        padding=_triple(attrs.get("paddings", [0, 0, 0])),
        groups=int(attrs.get("groups", 1)),
        dilation=_triple(attrs.get("dilations", [1, 1, 1])))}


class _SortedMaxPool3d(torch.autograd.Function):
    """`F.max_pool3d` whose gradient on the card is summed into each
    input cell in a fixed order (`index_put_` with accumulate under
    PyTorch's deterministic algorithms: sort the cells, then sum). The
    default CUDA backward adds overlapping windows' gradients with
    atomics, so two runs differ in the last bits."""

    @staticmethod
    def forward(ctx, x, ksize, strides):
        out, idx = F.max_pool3d(x, ksize, strides, return_indices=True)
        ctx.save_for_backward(idx)
        ctx.x_shape = x.shape
        return out

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        n, c = ctx.x_shape[:2]
        planes = torch.arange(n * c, device=g.device).reshape(
            n * c, 1).expand(n * c, idx[0, 0].numel())
        with deterministic_algorithms():
            gx = g.new_zeros((n * c, math.prod(ctx.x_shape[2:]))).index_put_(
                (planes, idx.reshape(n * c, -1)), g.reshape(n * c, -1),
                accumulate=True)
        return gx.reshape(ctx.x_shape), None, None


@register_op("pool3d")
def _pool3d(ins, attrs):
    """max or average over NCDHW windows with symmetric padding; the
    average divides by the count of input cells in the window (the
    reference's, whatever `exclusive` says)."""
    x = ins["X"][0]
    ksize = _triple(attrs.get("ksize", [2, 2, 2]))
    strides = _triple(attrs.get("strides", ksize))
    p = _triple(attrs.get("paddings", [0, 0, 0]))
    pads = (p[2], p[2], p[1], p[1], p[0], p[0])
    if attrs.get("pooling_type", "max") == "max":
        xp = F.pad(x, pads, value=float("-inf"))
        if xp.is_cuda and xp.requires_grad:
            return {"Out": _SortedMaxPool3d.apply(xp, ksize, strides)}
        return {"Out": F.max_pool3d(xp, ksize, strides)}
    total = F.avg_pool3d(F.pad(x, pads), ksize, strides, divisor_override=1)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    cnt = F.avg_pool3d(F.pad(ones, pads), ksize, strides,
                       divisor_override=1)
    return {"Out": total / cnt}


@register_op("max_pool2d_with_index")
def _max_pool2d_with_index(ins, attrs):
    """Max pooling that also gives, in Mask, the flat index (h * W + w)
    of each window's maximum in the unpadded input; the first maximum
    of a window wins a tie (as `jnp.argmax`), and Out's gradient is
    shared among tied cells (as `jnp.max`)."""
    x = ins["X"][0]
    kh, kw = _pair(attrs.get("ksize", [2, 2]))
    sh, sw = _pair(attrs.get("strides", [kh, kw]))
    ph, pw = _pair(attrs.get("paddings", [0, 0]))
    w = x.shape[3]
    xp = F.pad(x, (pw, pw, ph, ph), value=float("-inf"))
    # [n, c, oh, ow, kh * kw]
    wins = xp.unfold(2, kh, sh).unfold(3, kw, sw).flatten(-2)
    amax = torch.argmax(wins, dim=-1).to(torch.int32)
    oh, ow = wins.shape[2], wins.shape[3]
    row0 = torch.arange(oh, dtype=torch.int32, device=x.device) * sh - ph
    col0 = torch.arange(ow, dtype=torch.int32, device=x.device) * sw - pw
    rh = torch.div(amax, kw, rounding_mode="floor") + row0[:, None]
    rw = torch.remainder(amax, kw) + col0[None, :]
    return {"Out": torch.amax(wins, dim=-1), "Mask": rh * w + rw}


@register_op("interp_nearest")
def _interp_nearest(ins, attrs):
    """Nearest resampling of NCHW X to (out_h, out_w): source row
    floor(i * (H / out_h)) in float32, as the reference computes it
    (not `F.interpolate(mode="nearest")`'s rule at every size), the
    indices made on X's device."""
    x = ins["X"][0]

    def src(n_in, n_out):
        scale = float(torch.tensor(n_in / n_out, dtype=torch.float32))
        return (torch.arange(n_out, dtype=torch.float32, device=x.device)
                * scale).long()

    rows, cols = src(x.shape[2], attrs["out_h"]), src(x.shape[3],
                                                      attrs["out_w"])
    return {"Out": x[:, :, rows][:, :, :, cols]}


@register_op("one_hot_v2")
def _one_hot_v2(ins, attrs):
    """[...] ids -> [..., depth] float32 rows (an id outside [0, depth)
    a row of zeros)."""
    ids = ins["X"][0].to(torch.int32)
    classes = torch.arange(attrs["depth"], dtype=torch.int32,
                           device=ids.device)
    return {"Out": (ids.unsqueeze(-1) == classes).to(torch.float32)}


def _channel_affine(y, ins, x_ndim):
    cshape = (1, -1) + (1,) * (x_ndim - 2)
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(cshape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(cshape)
    return y


@register_op("instance_norm")
def _instance_norm(ins, attrs):
    """Normalizes each (sample, channel) over its spatial cells (biased
    variance), then the optional per-channel Scale and Bias; SavedMean
    and SavedVariance (1 / sqrt(var + eps)) are [N, C]."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(2, x.ndim))
    mean = torch.mean(x, dim=axes, keepdim=True)
    std = torch.sqrt(torch.var(x, dim=axes, unbiased=False, keepdim=True)
                     + eps)
    y = _channel_affine((x - mean) / std, ins, x.ndim)
    return {"Y": y, "SavedMean": mean.reshape(x.shape[:2]),
            "SavedVariance": (1.0 / std).reshape(x.shape[:2])}


@register_op("group_norm")
def _group_norm(ins, attrs):
    """Normalizes each sample's `groups` channel groups (biased
    variance), then the optional per-channel Scale and Bias; Mean and
    Variance are [N, groups]."""
    x = ins["X"][0]
    groups = attrs.get("groups", 1)
    eps = attrs.get("epsilon", 1e-5)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.ndim))
    mean = torch.mean(xg, dim=axes, keepdim=True)
    var = torch.var(xg, dim=axes, unbiased=False, keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    return {"Y": _channel_affine(y, ins, x.ndim),
            "Mean": mean.reshape(n, groups),
            "Variance": var.reshape(n, groups)}


@register_op("lstm_seq")
def _lstm_seq(ins, attrs):
    """One LSTM layer over batch-major [B, T, D] (gates i, f, g, o along
    4H, as `torch.nn.LSTM`, one combined Bias): `cudnn_lstm`'s
    recurrence over one direction; `is_reverse` runs from the last
    step."""
    reverse = attrs.get("is_reverse", False)
    ys, h, c = _cudnn_dir(_time_major(ins["Input"][0], reverse),
                          ins["WeightIh"][0], ins["WeightHh"][0],
                          ins["Bias"][0], ins["InitH"][0], ins["InitC"][0],
                          None)
    return {"Out": _batch_major(ys, reverse), "LastH": h, "LastC": c}


@register_op("gru_seq")
def _gru_seq(ins, attrs):
    """One GRU layer over batch-major [B, T, D] (gates r, z, n along 3H,
    as `torch.nn.GRU`)."""
    w_hh, b_hh = ins["WeightHh"][0], ins["BiasHh"][0]
    reverse = attrs.get("is_reverse", False)
    xp = torch.matmul(_time_major(ins["Input"][0], reverse),
                      ins["WeightIh"][0].t()) + ins["BiasIh"][0]
    h = ins["InitH"][0]
    ys = []
    for xt in torch.unbind(xp):
        xr, xz, xn = torch.chunk(xt, 3, dim=-1)
        hr, hz, hn = torch.chunk(h @ w_hh.t() + b_hh, 3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        ys.append(h)
    return {"Out": _batch_major(ys, reverse), "LastH": h}


@register_op("maxout")
def _maxout(ins, attrs):
    x = ins["X"][0]
    groups = attrs["groups"]
    axis = attrs.get("axis", 1) % x.ndim
    shape = (tuple(x.shape[:axis]) + (x.shape[axis] // groups, groups)
             + tuple(x.shape[axis + 1:]))
    return {"Out": torch.amax(x.reshape(shape), dim=axis + 1)}


@register_op("norm")
def _norm(ins, attrs):
    """X / sqrt(sum(X^2) + eps) along `axis`, and that Norm."""
    x = ins["X"][0]
    n = torch.sqrt(torch.sum(torch.square(x), dim=attrs.get("axis", -1),
                             keepdim=True) + attrs.get("epsilon", 1e-10))
    return {"Out": x / n, "Norm": n}


@register_op("lrn")
def _lrn(ins, attrs):
    """Local response norm across NCHW channels: MidOut = k + alpha *
    (the sum of squares over the n channels around each), Out = X /
    MidOut^beta."""
    x = ins["X"][0]
    n = attrs.get("n", 5)
    half = n // 2
    sq = F.pad(torch.square(x), (0, 0, 0, 0, half, half))
    c = x.shape[1]
    acc = sq[:, 0:c]
    for i in range(1, n):
        acc = acc + sq[:, i:i + c]
    mid = attrs.get("k", 2.0) + attrs.get("alpha", 1e-4) * acc
    return {"Out": x / torch.pow(mid, attrs.get("beta", 0.75)),
            "MidOut": mid}


@register_op("spectral_norm")
def _spectral_norm(ins, attrs):
    """Weight / sigma, sigma its largest singular value estimated by
    `power_iters` power iterations from U and V (U and V are not
    updated: the op writes no state, as the reference's)."""
    w, u, v = ins["Weight"][0], ins["U"][0], ins["V"][0]
    dim = attrs.get("dim", 0)
    eps = attrs.get("eps", 1e-12)
    wm = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
    for _ in range(max(attrs.get("power_iters", 1), 0)):
        v = wm.t() @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = wm @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    return {"Out": w / (u @ wm @ v)}


@register_op("data_norm")
def _data_norm(ins, attrs):
    """(X - mean) * scale from the accumulated BatchSize, BatchSum and
    BatchSquareSum (not updated: the op writes no state, as the
    reference's)."""
    x = ins["X"][0]
    size, sums = ins["BatchSize"][0], ins["BatchSum"][0]
    mean = sums / size
    scale = torch.sqrt(size / (ins["BatchSquareSum"][0]
                               - size * torch.square(mean)
                               + attrs.get("epsilon", 1e-4)))
    return {"Y": (x - mean) * scale, "Means": mean.expand(x.shape),
            "Scales": scale.expand(x.shape)}


@register_op("row_conv")
def _row_conv(ins, attrs):
    """The lookahead convolution over [B, T, D]: Out[t] = sum over i of
    X[t + i] * Filter[i] (zeros past the end)."""
    x, filt = ins["X"][0], ins["Filter"][0]
    t = x.shape[1]
    pad = F.pad(x, (0, 0, 0, filt.shape[0] - 1))
    out = pad[:, 0:t] * filt[0]
    for i in range(1, filt.shape[0]):
        out = out + pad[:, i:i + t] * filt[i]
    return {"Out": out}


@register_op("affine_channel")
def _affine_channel(ins, attrs):
    x = ins["X"][0]
    if attrs.get("data_layout", "NCHW") == "NCHW":
        shape = (1, -1) + (1,) * (x.ndim - 2)
    else:
        shape = (1,) * (x.ndim - 1) + (-1,)
    return {"Out": x * ins["Scale"][0].reshape(shape)
            + ins["Bias"][0].reshape(shape)}


@register_op("fsp")
def _fsp(ins, attrs):
    """The flow-of-solution matrix: X [N, Cx, H, W] and Y [N, Cy, H, W]
    -> [N, Cx, Cy], each entry a mean over the H * W cells."""
    x, y = ins["X"][0], ins["Y"][0]
    hw = x.shape[2] * x.shape[3]
    return {"Out": torch.matmul(x.reshape(x.shape[0], x.shape[1], hw),
                                y.reshape(y.shape[0], y.shape[1], hw)
                                .transpose(1, 2)) / hw}


@register_op("pixel_shuffle")
def _pixel_shuffle(ins, attrs):
    x = ins["X"][0]
    r = attrs.get("upscale_factor", 1)
    n, c, h, w = x.shape
    out = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return {"Out": out.reshape(n, c // (r * r), h * r, w * r)}


@register_op("shuffle_channel")
def _shuffle_channel(ins, attrs):
    x = ins["X"][0]
    group = attrs.get("group", 1)
    n, c, h, w = x.shape
    return {"Out": x.reshape(n, group, c // group, h, w).transpose(1, 2)
            .reshape(n, c, h, w)}


@register_op("space_to_depth")
def _space_to_depth(ins, attrs):
    x = ins["X"][0]
    b = attrs.get("blocksize", 1)
    n, c, h, w = x.shape
    out = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return {"Out": out.reshape(n, c * b * b, h // b, w // b)}


@register_op("temporal_shift")
def _temporal_shift(ins, attrs):
    """[N * seg, C, H, W]: the first C * ratio channels move one segment
    back in time, the next C * ratio one forward (zeros enter), the
    rest stay."""
    x = ins["X"][0]
    seg = attrs.get("seg_num", 1)
    ratio = attrs.get("shift_ratio", 0.25)
    nt, c, h, w = x.shape
    xr = x.reshape(nt // seg, seg, c, h, w)
    c1, c2 = int(c * ratio), int(c * 2 * ratio)
    fwd = F.pad(xr[:, 1:, :c1], (0, 0, 0, 0, 0, 0, 0, 1))
    back = F.pad(xr[:, :-1, c1:c2], (0, 0, 0, 0, 0, 0, 1, 0))
    return {"Out": torch.cat([fwd, back, xr[:, :, c2:]], dim=2)
            .reshape(nt, c, h, w)}


@register_op("grid_sampler")
def _grid_sampler(ins, attrs):
    """Bilinear sampling of NCHW X at Grid [N, Ho, Wo, 2] (x, y in [-1,
    1], the corners at the edge cells' centres), zero outside."""
    x, grid = ins["X"][0], ins["Grid"][0]
    return {"Output": F.grid_sample(x, grid.to(x.dtype), mode="bilinear",
                                    padding_mode="zeros",
                                    align_corners=True)}


@register_op("affine_grid")
def _affine_grid(ins, attrs):
    """The [N, H, W, 2] sampling grid of affine Theta [N, 2, 3] over
    `output_shape` [N, C, H, W] (corners aligned; where the attr is
    absent, the OutputShape tensor, read on the host, so that its block
    runs eagerly: `fluid/lowering.py capture_blocker`)."""
    theta = ins["Theta"][0]
    out_shape = attrs.get("output_shape")
    if out_shape is None and ins.get("OutputShape"):
        out_shape = [int(v) for v in ins["OutputShape"][0].tolist()]
    _, c, h, w = out_shape
    return {"Output": F.affine_grid(theta, [theta.shape[0], c, h, w],
                                    align_corners=True)}


def _pads4(p):
    """[top, left, bottom, right] (or [h, w]) -> F.pad's (left, right,
    top, bottom)."""
    p = list(p)
    if len(p) == 2:
        p = [p[0], p[1], p[0], p[1]]
    return (p[1], p[3], p[0], p[2])


@register_op("unfold")
def _unfold(ins, attrs):
    """im2col: [N, C, H, W] -> [N, C * kh * kw, L]; `paddings` [top,
    left, bottom, right]."""
    x = F.pad(ins["X"][0], _pads4(attrs.get("paddings", [0, 0, 0, 0])))
    return {"Y": F.unfold(x, _pair(attrs["kernel_sizes"]),
                          dilation=_pair(attrs.get("dilations", [1, 1])),
                          stride=_pair(attrs.get("strides", [1, 1])))}


@register_op("im2sequence")
def _im2sequence(ins, attrs):
    """Image patches as rows: [N, C, H, W] -> [N * oh * ow, C * kh *
    kw]; `paddings` [top, left, bottom, right]."""
    x = F.pad(ins["X"][0], _pads4(attrs.get("paddings", [0, 0, 0, 0])))
    cols = F.unfold(x, _pair(attrs["kernels"]),
                    stride=_pair(attrs.get("strides", [1, 1])))
    return {"Out": cols.transpose(1, 2).reshape(-1, cols.shape[1])}


@register_op("spp")
def _spp(ins, attrs):
    """Spatial pyramid pooling: level p pools to 2^p x 2^p bins (kernel
    ceil(dim / bins), padding (kernel * bins - dim + 1) // 2) through
    `pool2d`; the levels flattened and concatenated."""
    x = ins["X"][0]
    n, c, h, w = x.shape
    outs = []
    for p in range(int(attrs.get("pyramid_height", 1))):
        bins = 2 ** p
        kh, kw = -(-h // bins), -(-w // bins)
        lvl = _pool2d({"X": [x]}, {
            "pooling_type": attrs.get("pooling_type", "max"),
            "ksize": [kh, kw], "strides": [kh, kw],
            "paddings": [(kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2],
            "exclusive": True})["Out"]
        outs.append(lvl.reshape(n, c * bins * bins))
    return {"Out": torch.cat(outs, dim=1)}
