"""Neural-network operators of the slice (counterpart:
`paddle_tpu/ops/nn_ops.py`): `relu`, `sigmoid`, `tanh`, `gelu`, `sign`,
`exp`, `floor`, `cos` and the reference's 44 other unary elementwise
types (`_UNARY`, attrs and defaults as the reference reads them),
`softmax`, `log_softmax`, `softmax_with_cross_entropy` (hard labels with
`ignore_index`, or soft labels), `one_hot`, `label_smooth`, `conv2d` / `depthwise_conv2d`, `pool2d`, `batch_norm`,
`layer_norm`, `dropout`, `pad`, `pad2d`, the embedding lookups and
`scaled_dot_product_attention`.

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
    return {"Out": F.pad(x, [l, r, t, b],
                         mode={"reflect": "reflect",
                               "edge": "replicate"}[mode])}


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
        was = torch.are_deterministic_algorithms_enabled()
        warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            gw = torch.ops.aten.embedding_dense_backward(
                g, ids, ctx.rows, -1, False)
        finally:
            torch.use_deterministic_algorithms(was, warn_only=warn_only)
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
