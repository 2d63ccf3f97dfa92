"""BERT pretraining in the fluid static graph (counterpart:
`paddle_tpu/models/bert.py`, BASELINE.json config 3): embeddings, an
encoder of matmul / layer_norm / attention / dropout layers, and the
masked-LM and next-sentence heads, trained with Adam.

The encoder is built unrolled (`encoder_layer` per layer) or as one
`layers.Scan` over stacked [L, ...] parameters (`_scan_encoder_stack`,
q/k/v fused into one [H, 3H] projection), as the reference's bench
builds it. Attention is the `scaled_dot_product_attention` op: on the
card at key lengths of at least `FLAGS_flash_attention_min_seq` it runs
the flash kernels (`ops/kernels/flash_attention.py`), else the composite
path. `attention_impl="reference"` makes those flash calls run the
kernels' plain version instead (for holding one against the other).
"""
from __future__ import annotations

import math

from .. import fluid
from ..fluid import layers
from ..fluid.param_attr import ParamAttr


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, max_position_embeddings=512,
                 type_vocab_size=2, hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1, initializer_range=0.02):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.initializer_range = initializer_range

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def tiny():
        return BertConfig(vocab_size=1024, hidden_size=64,
                          num_hidden_layers=2, num_attention_heads=4,
                          intermediate_size=128,
                          max_position_embeddings=64)


def _init(cfg):
    return fluid.initializer.TruncatedNormal(0.0, cfg.initializer_range)


def _attention(q, k, v, attn_bias, cfg, is_test, attention_impl):
    return layers.scaled_dot_product_attention(
        q, k, v, key_bias=attn_bias, causal=False,
        sm_scale=1.0 / math.sqrt(cfg.hidden_size // cfg.num_attention_heads),
        attn_dropout_prob=cfg.attention_probs_dropout_prob,
        is_test=is_test, flash_impl=attention_impl)


def multi_head_attention(x, attn_bias, cfg, name, is_test=False,
                         attention_impl="auto"):
    """x: [B, S, H]; attn_bias: [B, S] additive key bias (0 for live
    tokens, -1e4 for padding)."""
    h = cfg.hidden_size
    n_head = cfg.num_attention_heads
    d_head = h // n_head

    def proj(inp, pname):
        return layers.fc(input=inp, size=h, num_flatten_dims=2,
                         param_attr=ParamAttr(name=name + pname + ".w",
                                              initializer=_init(cfg)),
                         bias_attr=ParamAttr(name=name + pname + ".b"))

    q, k, v = proj(x, "_q"), proj(x, "_k"), proj(x, "_v")

    def to_heads(t):
        t = layers.reshape(t, [0, 0, n_head, d_head])
        return layers.transpose(t, [0, 2, 1, 3])  # [B, nH, S, dH]

    ctx = _attention(to_heads(q), to_heads(k), to_heads(v), attn_bias, cfg,
                     is_test, attention_impl)
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    ctx = layers.reshape(ctx, [0, 0, h])
    return proj(ctx, "_out")


def encoder_layer(x, attn_bias, cfg, name, is_test=False,
                  attention_impl="auto"):
    attn = multi_head_attention(x, attn_bias, cfg, name + "_attn",
                                is_test=is_test,
                                attention_impl=attention_impl)
    attn = layers.dropout(attn, cfg.hidden_dropout_prob, is_test=is_test,
                          dropout_implementation="upscale_in_train")
    x = layers.layer_norm(
        layers.elementwise_add(x, attn), begin_norm_axis=2,
        param_attr=ParamAttr(name=name + "_post_att_ln.scale"),
        bias_attr=ParamAttr(name=name + "_post_att_ln.bias"))
    ffn = layers.fc(input=x, size=cfg.intermediate_size, num_flatten_dims=2,
                    act="gelu",
                    param_attr=ParamAttr(name=name + "_ffn0.w",
                                         initializer=_init(cfg)),
                    bias_attr=ParamAttr(name=name + "_ffn0.b"))
    ffn = layers.fc(input=ffn, size=cfg.hidden_size, num_flatten_dims=2,
                    param_attr=ParamAttr(name=name + "_ffn1.w",
                                         initializer=_init(cfg)),
                    bias_attr=ParamAttr(name=name + "_ffn1.b"))
    ffn = layers.dropout(ffn, cfg.hidden_dropout_prob, is_test=is_test,
                         dropout_implementation="upscale_in_train")
    return layers.layer_norm(
        layers.elementwise_add(x, ffn), begin_norm_axis=2,
        param_attr=ParamAttr(name=name + "_post_ffn_ln.scale"),
        bias_attr=ParamAttr(name=name + "_post_ffn_ln.bias"))


def _scan_encoder_stack(x, attn_bias, cfg, is_test=False, remat=False,
                        attention_impl="auto"):
    """The encoder stack as one `layers.Scan` over stacked [L, ...]
    parameters, with q/k/v fused into one [H, 3H] projection; the math
    of the unrolled stack. remat=True recomputes each layer's
    activations in the backward."""
    L, h = cfg.num_hidden_layers, cfg.hidden_size
    f = cfg.intermediate_size
    n_head = cfg.num_attention_heads
    d_head = h // n_head
    zeros = fluid.initializer.Constant(0.0)
    ones = fluid.initializer.Constant(1.0)

    def par(name, shape, init=None):
        return layers.create_parameter(
            shape=shape, dtype="float32", name=name,
            attr=ParamAttr(name=name, initializer=init or _init(cfg)))

    stacked = (
        par("enc_qkv.w", [L, h, 3 * h]), par("enc_qkv.b", [L, 3 * h], zeros),
        par("enc_attn_out.w", [L, h, h]), par("enc_attn_out.b", [L, h], zeros),
        par("enc_post_att_ln.scale", [L, h], ones),
        par("enc_post_att_ln.bias", [L, h], zeros),
        par("enc_ffn0.w", [L, h, f]), par("enc_ffn0.b", [L, f], zeros),
        par("enc_ffn1.w", [L, f, h]), par("enc_ffn1.b", [L, h], zeros),
        par("enc_post_ffn_ln.scale", [L, h], ones),
        par("enc_post_ffn_ln.bias", [L, h], zeros))

    scan = layers.Scan(n=L, remat=remat)
    with scan.block():
        (wqkv, bqkv, wo, bo, l1s, l1b, wf0, bf0, wf1, bf1, l2s,
         l2b) = [scan.slice_input(p) for p in stacked]
        qkv = layers.elementwise_add(layers.matmul(x, wqkv), bqkv)
        q = layers.slice(qkv, axes=[2], starts=[0], ends=[h])
        k = layers.slice(qkv, axes=[2], starts=[h], ends=[2 * h])
        v = layers.slice(qkv, axes=[2], starts=[2 * h], ends=[3 * h])

        def to_heads(t):
            t = layers.reshape(t, [0, 0, n_head, d_head])
            return layers.transpose(t, [0, 2, 1, 3])

        ctx = _attention(to_heads(q), to_heads(k), to_heads(v), attn_bias,
                         cfg, is_test, attention_impl)
        ctx = layers.reshape(layers.transpose(ctx, [0, 2, 1, 3]),
                             [0, 0, h])
        attn = layers.elementwise_add(layers.matmul(ctx, wo), bo)
        attn = layers.dropout(attn, cfg.hidden_dropout_prob,
                              is_test=is_test,
                              dropout_implementation="upscale_in_train")
        y = layers.layer_norm(layers.elementwise_add(x, attn),
                              begin_norm_axis=2, scale=l1s, shift=l1b)
        ffn = layers.gelu(
            layers.elementwise_add(layers.matmul(y, wf0), bf0))
        ffn = layers.elementwise_add(layers.matmul(ffn, wf1), bf1)
        ffn = layers.dropout(ffn, cfg.hidden_dropout_prob,
                             is_test=is_test,
                             dropout_implementation="upscale_in_train")
        new_x = layers.layer_norm(layers.elementwise_add(y, ffn),
                                  begin_norm_axis=2, scale=l2s,
                                  shift=l2b)
        layers.assign(new_x, output=x)
    return x


def bert_encoder(src_ids, pos_ids, sent_ids, input_mask, cfg,
                 is_test=False, checkpoints_out=None, scan_layers=False,
                 scan_remat=False, attention_impl="auto"):
    """Returns the [B, S, H] sequence output. With a `checkpoints_out`
    list, each unrolled encoder layer's output var is appended to it."""
    emb = layers.embedding(src_ids, size=[cfg.vocab_size, cfg.hidden_size],
                           param_attr=ParamAttr(name="word_embedding",
                                                initializer=_init(cfg)))
    pos = layers.embedding(pos_ids,
                           size=[cfg.max_position_embeddings,
                                 cfg.hidden_size],
                           param_attr=ParamAttr(name="pos_embedding",
                                                initializer=_init(cfg)))
    sent = layers.embedding(sent_ids,
                            size=[cfg.type_vocab_size, cfg.hidden_size],
                            param_attr=ParamAttr(name="sent_embedding",
                                                 initializer=_init(cfg)))
    x = layers.elementwise_add(layers.elementwise_add(emb, pos), sent)
    x = layers.layer_norm(x, begin_norm_axis=2,
                          param_attr=ParamAttr(name="pre_encoder_ln.scale"),
                          bias_attr=ParamAttr(name="pre_encoder_ln.bias"))
    x = layers.dropout(x, cfg.hidden_dropout_prob, is_test=is_test,
                       dropout_implementation="upscale_in_train")

    # additive [B, S] key bias from the [B, S] mask: (1-m) * -1e4
    attn_bias = layers.scale(input_mask, scale=-10000.0, bias=10000.0)

    if scan_layers:
        return _scan_encoder_stack(x, attn_bias, cfg, is_test=is_test,
                                   remat=scan_remat,
                                   attention_impl=attention_impl)
    for i in range(cfg.num_hidden_layers):
        x = encoder_layer(x, attn_bias, cfg, "layer_%d" % i,
                          is_test=is_test, attention_impl=attention_impl)
        if checkpoints_out is not None:
            checkpoints_out.append(x)
    return x


def bert_pretrain_loss(cfg, seq_len, is_test=False,
                       checkpoints_out=None, scan_layers=False,
                       scan_remat=False, attention_impl="auto"):
    """Masked-LM + next-sentence pretraining loss over feed vars:
    (total, mlm_loss, nsp_loss, feed names).

    Masked positions are a dense [B, max_pred] index tensor with a
    [B, max_pred] weight mask (padded slots weigh 0), gathered with a
    batched take_along_axis on [B, S, H]. The vocab head is the
    fused_linear_softmax_xent op, so the [tokens, vocab] logits are
    never held."""
    src = layers.data(name="src_ids", shape=[seq_len], dtype="int64")
    pos = layers.data(name="pos_ids", shape=[seq_len], dtype="int64")
    sent = layers.data(name="sent_ids", shape=[seq_len], dtype="int64")
    mask = layers.data(name="input_mask", shape=[seq_len], dtype="float32")
    mask_pos = layers.data(name="mask_pos", shape=[None], dtype="int64")
    mask_label = layers.data(name="mask_label", shape=[None], dtype="int64")
    mask_weight = layers.data(name="mask_weight", shape=[None],
                              dtype="float32")
    nsp_label = layers.data(name="nsp_label", shape=[1], dtype="int64")

    seq_out = bert_encoder(src, pos, sent, mask, cfg, is_test=is_test,
                           checkpoints_out=checkpoints_out,
                           scan_layers=scan_layers,
                           scan_remat=scan_remat,
                           attention_impl=attention_impl)

    # -- masked LM head (batched take_along_axis of masked positions) --
    idx = layers.reshape(mask_pos, [0, -1, 1])  # [B, P, 1]
    picked = layers.take_along_axis(seq_out, idx, axis=1)  # [B, P, H]
    picked = layers.reshape(picked, [-1, cfg.hidden_size])
    trans = layers.fc(input=picked, size=cfg.hidden_size, act="gelu",
                      param_attr=ParamAttr(name="mlm_trans.w",
                                           initializer=_init(cfg)),
                      bias_attr=ParamAttr(name="mlm_trans.b"))
    trans = layers.layer_norm(trans, begin_norm_axis=1,
                              param_attr=ParamAttr(name="mlm_ln.scale"),
                              bias_attr=ParamAttr(name="mlm_ln.bias"))
    per_tok = layers.loss.fused_linear_softmax_xent(
        trans, layers.reshape(mask_label, [-1, 1]), cfg.vocab_size,
        param_attr=ParamAttr(name="mlm_out.w", initializer=_init(cfg)),
        bias_attr=ParamAttr(name="mlm_out.b"))  # [B*P, 1]
    w_flat = layers.reshape(mask_weight, [-1, 1])
    denom = layers.scale(layers.reduce_sum(w_flat), bias=1e-6)
    mlm_loss = layers.elementwise_div(
        layers.reduce_sum(layers.elementwise_mul(per_tok, w_flat)), denom)

    # -- next sentence head over [CLS] --
    cls = layers.slice(seq_out, axes=[1], starts=[0], ends=[1])
    cls = layers.reshape(cls, [-1, cfg.hidden_size])
    pooled = layers.fc(input=cls, size=cfg.hidden_size, act="tanh",
                       param_attr=ParamAttr(name="pooler.w",
                                            initializer=_init(cfg)),
                       bias_attr=ParamAttr(name="pooler.b"))
    nsp_logits = layers.fc(input=pooled, size=2,
                           param_attr=ParamAttr(name="nsp.w",
                                                initializer=_init(cfg)),
                           bias_attr=ParamAttr(name="nsp.b"))
    nsp_loss = layers.mean(
        layers.softmax_with_cross_entropy(nsp_logits, nsp_label))

    total = layers.elementwise_add(mlm_loss, nsp_loss)
    feeds = ["src_ids", "pos_ids", "sent_ids", "input_mask", "mask_pos",
             "mask_label", "mask_weight", "nsp_label"]
    return total, mlm_loss, nsp_loss, feeds


def build_bert_pretrain(cfg=None, seq_len=128, lr=1e-4, use_lamb=False,
                        weight_decay=0.01, is_test=False):
    """The pretraining loss with its Adam update appended (unless
    `is_test`). LAMB is not ported yet."""
    if use_lamb:
        raise NotImplementedError(
            "build_bert_pretrain(use_lamb=True): LambOptimizer and the lamb "
            "op are not ported yet (ROADMAP Queue 1 #5)")
    cfg = cfg or BertConfig.base()
    total, mlm_loss, nsp_loss, feeds = bert_pretrain_loss(
        cfg, seq_len, is_test=is_test)
    if not is_test:
        fluid.optimizer.AdamOptimizer(learning_rate=lr).minimize(total)
    return total, mlm_loss, nsp_loss, feeds


def bert_feed(cfg, batch, seq_len, max_pred=None, seed=0):
    """Synthetic masked-LM batch in the layout `bert_pretrain_loss`
    feeds: every token live, `max_pred` (default seq_len // 8) masked
    positions per sequence with weight 1, from a numpy RandomState of
    `seed` (the same draws as the reference's feed builder at seed 0)."""
    import numpy as np

    r = np.random.RandomState(seed)
    max_pred = max(1, max_pred if max_pred is not None else seq_len // 8)
    mask_pos = np.stack([
        r.choice(seq_len, max_pred, replace=False)
        for _ in range(batch)]).astype("int64")
    return {
        "src_ids": r.randint(0, cfg.vocab_size,
                             (batch, seq_len)).astype("int64"),
        "pos_ids": np.tile(np.arange(seq_len),
                           (batch, 1)).astype("int64"),
        "sent_ids": np.zeros((batch, seq_len), "int64"),
        "input_mask": np.ones((batch, seq_len), "float32"),
        "mask_pos": mask_pos,
        "mask_label": r.randint(0, cfg.vocab_size,
                                (batch, max_pred)).astype("int64"),
        "mask_weight": np.ones((batch, max_pred), "float32"),
        "nsp_label": r.randint(0, 2, (batch, 1)).astype("int64"),
    }
