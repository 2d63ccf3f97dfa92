"""fluid.nets: composite network builders (counterpart:
`paddle_tpu/fluid/nets.py`).

Reference parity: `python/paddle/fluid/nets.py`: simple_img_conv_pool,
img_conv_group, sequence_conv_pool, glu, scaled_dot_product_attention.
Pure compositions of `fluid.layers` builders. As in the reference,
`sequence_conv_pool` adds no bias and pools without a Length (ROADMAP
Queue 3, reference-side).
"""
from __future__ import annotations

from . import layers


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1,
                         conv_padding=0, conv_dilation=1, conv_groups=1,
                         param_attr=None, bias_attr=None, act=None,
                         use_cudnn=True):
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act)
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    tmp = input
    if isinstance(conv_num_filter, int):
        conv_num_filter = [conv_num_filter]

    def _expand(v):
        return v if isinstance(v, (list, tuple)) else \
            [v] * len(conv_num_filter)

    paddings = _expand(conv_padding)
    fsizes = _expand(conv_filter_size)
    with_bn = _expand(conv_with_batchnorm)
    drop_rates = _expand(conv_batchnorm_drop_rate)
    pattrs = param_attr if isinstance(param_attr, (list, tuple)) else \
        [param_attr] * len(conv_num_filter)

    for i, nf in enumerate(conv_num_filter):
        act = conv_act if not with_bn[i] else None
        tmp = layers.conv2d(input=tmp, num_filters=nf,
                            filter_size=fsizes[i], padding=paddings[i],
                            param_attr=pattrs[i], act=act)
        if with_bn[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            if drop_rates[i]:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rates[i])
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", bias_attr=None):
    from .layer_helper import LayerHelper, apply_op

    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act)
    d = int(input.shape[-1])
    filt = helper.create_parameter(
        helper.param_attr, shape=[filter_size * d, num_filters],
        dtype=input.dtype)
    conv = apply_op(helper, "sequence_conv",
                    {"X": [input], "Filter": [filt]},
                    {"contextLength": filter_size,
                     "contextStart": -(filter_size // 2)},
                    ["Out"], out_dtype=input.dtype)[0]
    conv = helper.append_activation(conv)
    return layers.sequence_pool(input=conv, pool_type=pool_type)


def glu(input, dim=-1):
    """Gated linear unit (reference: nets.py glu): split + sigmoid gate."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Reference: nets.py scaled_dot_product_attention over [B, S, D]."""
    from .layer_helper import apply_op

    b = queries.shape[0]
    sq = queries.shape[1]
    d = int(queries.shape[-1])
    dh = d // num_heads

    def to_heads(x):
        s = x.shape[1]
        x = layers.reshape(x, [b if b > 0 else -1, s, num_heads, dh])
        return layers.transpose(x, [0, 2, 1, 3])

    q, k, v = to_heads(queries), to_heads(keys), to_heads(values)
    ctx = apply_op("scaled_dot_product_attention",
                   "scaled_dot_product_attention",
                   {"Q": [q], "K": [k], "V": [v]},
                   {"attn_dropout_prob": dropout_rate}, ["Out"],
                   out_dtype=queries.dtype)[0]
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    return layers.reshape(ctx, [b if b > 0 else -1, sq, d])
