"""Transformer seq2seq for WMT en-de in the fluid static graph
(counterpart: `paddle_tpu/models/transformer.py`, BASELINE.json config
4): teacher-forced training with label smoothing, the noam schedule and
Adam, and beam-search decoding over the trained scope.

The encoder and decoder are built unrolled or as one `layers.Scan` each
over stacked [L, ...] parameters (`_scan_stack`). Attention is the
explicit matmul-softmax-matmul of `_attention_core` (the flash kernels
are for far longer keys). `beam_search_decode` is a plain torch function
over the scope's tensors: a static [B*K, H, T, Dh] self-attention cache
per layer, cross-attention keys and values computed once, and a Python
loop over decode steps that stops when every beam has finished (the
reference's `lax.while_loop`; a step over finished beams changes
nothing, so stopping early gives the same result).
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch

from .. import fluid
from ..fluid import layers
from ..fluid.param_attr import ParamAttr


class TransformerConfig:
    def __init__(self, src_vocab=32000, tgt_vocab=32000, max_len=256,
                 d_model=512, n_head=8, d_ff=2048, n_layer=6, dropout=0.1):
        self.src_vocab = src_vocab
        self.tgt_vocab = tgt_vocab
        self.max_len = max_len
        self.d_model = d_model
        self.n_head = n_head
        self.d_ff = d_ff
        self.n_layer = n_layer
        self.dropout = dropout

    @staticmethod
    def big():
        return TransformerConfig(d_model=1024, n_head=16, d_ff=4096)

    @staticmethod
    def tiny():
        return TransformerConfig(src_vocab=128, tgt_vocab=128, max_len=16,
                                 d_model=32, n_head=4, d_ff=64, n_layer=2,
                                 dropout=0.0)


def _init():
    return fluid.initializer.Xavier(uniform=True)


def _proj(x, size, name, act=None):
    return layers.fc(input=x, size=size, num_flatten_dims=2, act=act,
                     param_attr=ParamAttr(name=name + ".w",
                                          initializer=_init()),
                     bias_attr=ParamAttr(name=name + ".b"))


def _attention_core(q, k, v, bias, cfg, is_test, out_proj):
    """softmax(QK^T/sqrt(d_head)+bias)V over heads; q/k/v are already
    [B, S, d_model] projections, out_proj maps the context back. ONE
    copy of the weight-parity-critical math shared by the unrolled path
    and the scan body."""
    d_head = cfg.d_model // cfg.n_head

    def heads(t):
        t = layers.reshape(t, [0, 0, cfg.n_head, d_head])
        return layers.transpose(t, [0, 2, 1, 3])

    q, k, v = heads(q), heads(k), heads(v)
    scores = layers.matmul(q, k, transpose_y=True,
                           alpha=1.0 / math.sqrt(d_head))
    if bias is not None:
        scores = layers.elementwise_add(scores, bias)
    probs = layers.softmax(scores)
    if cfg.dropout and not is_test:
        probs = layers.dropout(probs, cfg.dropout, is_test=is_test,
                               dropout_implementation="upscale_in_train")
    ctx = layers.transpose(layers.matmul(probs, v), [0, 2, 1, 3])
    ctx = layers.reshape(ctx, [0, 0, cfg.d_model])
    return out_proj(ctx)


def _attention(q_in, kv_in, bias, cfg, name, is_test):
    return _attention_core(
        _proj(q_in, cfg.d_model, name + "_q"),
        _proj(kv_in, cfg.d_model, name + "_k"),
        _proj(kv_in, cfg.d_model, name + "_v"),
        bias, cfg, is_test,
        lambda ctx: _proj(ctx, cfg.d_model, name + "_o"))


def _ln(x, name):
    return layers.layer_norm(
        x, begin_norm_axis=2,
        param_attr=ParamAttr(name=name + ".scale"),
        bias_attr=ParamAttr(name=name + ".bias"))


def _ffn(x, cfg, name):
    h = _proj(x, cfg.d_ff, name + "_fc0", act="relu")
    return _proj(h, cfg.d_model, name + "_fc1")


def _embed(ids, vocab, cfg, name, pos_name="pos_enc"):
    emb = layers.embedding(ids, size=[vocab, cfg.d_model],
                           param_attr=ParamAttr(name=name,
                                                initializer=_init()))
    emb = layers.scale(emb, scale=math.sqrt(cfg.d_model))
    seq_len = emb.shape[1]
    pe = _positional_encoding(cfg.max_len, cfg.d_model)
    pe_var = layers.assign(pe[:seq_len])
    return layers.elementwise_add(emb, layers.unsqueeze(pe_var, [0]))


def _positional_encoding(max_len, d_model):
    pos = np.arange(max_len)[:, None].astype("float32")
    i = np.arange(d_model // 2)[None, :].astype("float32")
    angle = pos / np.power(10000.0, 2 * i / d_model)
    pe = np.zeros((max_len, d_model), "float32")
    pe[:, 0::2] = np.sin(angle)
    pe[:, 1::2] = np.cos(angle)
    return pe


def encoder(src_ids, src_bias, cfg, is_test=False, scan_layers=False,
            scan_remat=False):
    x = _embed(src_ids, cfg.src_vocab, cfg, "src_word_emb")
    if scan_layers:
        return _scan_stack(x, cfg, "enc", is_test, self_bias=src_bias,
                           remat=scan_remat)
    for i in range(cfg.n_layer):
        nm = "enc_%d" % i
        attn = _attention(x, x, src_bias, cfg, nm + "_selfattn", is_test)
        x = _ln(layers.elementwise_add(x, attn), nm + "_ln0")
        ffn = _ffn(x, cfg, nm + "_ffn")
        x = _ln(layers.elementwise_add(x, ffn), nm + "_ln1")
    return x


def decoder(tgt_ids, enc_out, self_bias, cross_bias, cfg, is_test=False,
            scan_layers=False, scan_remat=False):
    x = _embed(tgt_ids, cfg.tgt_vocab, cfg, "tgt_word_emb")
    if scan_layers:
        x = _scan_stack(x, cfg, "dec", is_test, self_bias=self_bias,
                        cross_kv=enc_out, cross_bias=cross_bias,
                        remat=scan_remat)
        return _proj(x, cfg.tgt_vocab, "dec_out_proj")
    for i in range(cfg.n_layer):
        nm = "dec_%d" % i
        attn = _attention(x, x, self_bias, cfg, nm + "_selfattn", is_test)
        x = _ln(layers.elementwise_add(x, attn), nm + "_ln0")
        cross = _attention(x, enc_out, cross_bias, cfg, nm + "_crossattn",
                           is_test)
        x = _ln(layers.elementwise_add(x, cross), nm + "_ln1")
        ffn = _ffn(x, cfg, nm + "_ffn")
        x = _ln(layers.elementwise_add(x, ffn), nm + "_ln2")
    return _proj(x, cfg.tgt_vocab, "dec_out_proj")


def _scan_stack(x, cfg, prefix, is_test, self_bias=None, cross_kv=None,
                cross_bias=None, remat=False):
    """Encoder/decoder layer stack as ONE layers.Scan over stacked
    [L, ...] params (see models/bert._scan_encoder_stack). Stacked
    names mirror the unrolled ones with the layer index replaced by
    'stack' (enc_0_selfattn_q.w -> enc_stack_selfattn_q.w [L, d, d]),
    so beam_search_decode can expand them back per layer."""
    from ..fluid.layers import Scan

    L, d, f = cfg.n_layer, cfg.d_model, cfg.d_ff
    zeros = fluid.initializer.Constant(0.0)
    ones = fluid.initializer.Constant(1.0)

    def par(suffix, shape, init=None):
        name = "%s_stack%s" % (prefix, suffix)
        if init is None and len(shape) == 3:
            # Xavier fan must come from the per-LAYER 2D slice, not the
            # stacked 3D shape (which would under-scale the init ~16x
            # vs the unrolled path this stack is weight-parity with)
            init = fluid.initializer.Xavier(
                uniform=True, fan_in=shape[1], fan_out=shape[2])
        return layers.create_parameter(
            shape=shape, dtype="float32", name=name,
            attr=ParamAttr(name=name, initializer=init or _init()))

    def attn_pack(kind):
        return {p: (par("%s_%s.w" % (kind, p), [L, d, d]),
                    par("%s_%s.b" % (kind, p), [L, d], zeros))
                for p in ("q", "k", "v", "o")}

    packs = {"_selfattn": attn_pack("_selfattn")}
    lns = [("_ln0", par("_ln0.scale", [L, d], ones),
            par("_ln0.bias", [L, d], zeros)),
           ("_ln1", par("_ln1.scale", [L, d], ones),
            par("_ln1.bias", [L, d], zeros))]
    if cross_kv is not None:
        packs["_crossattn"] = attn_pack("_crossattn")
        lns.append(("_ln2", par("_ln2.scale", [L, d], ones),
                    par("_ln2.bias", [L, d], zeros)))
    w_f0 = par("_ffn_fc0.w", [L, d, f])
    b_f0 = par("_ffn_fc0.b", [L, f], zeros)
    w_f1 = par("_ffn_fc1.w", [L, f, d])
    b_f1 = par("_ffn_fc1.b", [L, d], zeros)

    scan = Scan(n=L, remat=remat)
    with scan.block():
        sl = {}
        for kind, pk in packs.items():
            sl[kind] = {p: (scan.slice_input(w), scan.slice_input(b))
                        for p, (w, b) in pk.items()}
        ln_sl = [(nm, scan.slice_input(s), scan.slice_input(b))
                 for nm, s, b in lns]
        f0w, f0b = scan.slice_input(w_f0), scan.slice_input(b_f0)
        f1w, f1b = scan.slice_input(w_f1), scan.slice_input(b_f1)

        def proj(inp, w, b):
            return layers.elementwise_add(layers.matmul(inp, w), b)

        # _attention_core: ONE copy of the math (weight-parity with the
        # unrolled path); the fused scaled_dot_product_attention path
        # only changes the lowering at seq >=
        # FLAGS_flash_attention_min_seq (4096), far above WMT's max_len
        def attn(q_in, kv_in, bias, kind):
            s = sl[kind]
            return _attention_core(
                proj(q_in, *s["q"]), proj(kv_in, *s["k"]),
                proj(kv_in, *s["v"]), bias, cfg, is_test,
                lambda ctx: proj(ctx, *s["o"]))

        def ln_i(inp, i):
            _, s, b = ln_sl[i]
            return layers.layer_norm(inp, begin_norm_axis=2, scale=s,
                                     shift=b)

        y = ln_i(layers.elementwise_add(
            x, attn(x, x, self_bias, "_selfattn")), 0)
        nxt = 1
        if cross_kv is not None:
            y = ln_i(layers.elementwise_add(
                y, attn(y, cross_kv, cross_bias, "_crossattn")), 1)
            nxt = 2
        ffn = layers.elementwise_add(
            layers.matmul(layers.relu(proj(y, f0w, f0b)), f1w), f1b)
        new_x = ln_i(layers.elementwise_add(y, ffn), nxt)
        layers.assign(new_x, output=x)
    return x


def build_transformer_train(cfg=None, src_len=32, tgt_len=32, lr=1e-3,
                            warmup=4000, label_smooth_eps=0.1,
                            is_test=False, scan_layers=False,
                            scan_remat=False):
    """Teacher-forced training graph. Returns (avg_loss, feeds)."""
    cfg = cfg or TransformerConfig()
    src = layers.data(name="src_ids", shape=[src_len], dtype="int64")
    tgt = layers.data(name="tgt_ids", shape=[tgt_len], dtype="int64")
    lbl = layers.data(name="lbl_ids", shape=[tgt_len], dtype="int64")
    src_mask = layers.data(name="src_mask", shape=[src_len],
                           dtype="float32")
    tgt_mask = layers.data(name="tgt_mask", shape=[tgt_len],
                           dtype="float32")

    src_bias = layers.unsqueeze(layers.unsqueeze(
        layers.scale(src_mask, scale=-1e4, bias=1e4), [1]), [1])
    # causal + padding bias for decoder self-attention
    causal = np.triu(np.full((tgt_len, tgt_len), -1e4, "float32"), k=1)
    causal_var = layers.assign(causal)
    pad_bias = layers.unsqueeze(layers.unsqueeze(
        layers.scale(tgt_mask, scale=-1e4, bias=1e4), [1]), [1])
    self_bias = layers.elementwise_add(pad_bias, causal_var)
    cross_bias = src_bias

    enc_out = encoder(src, src_bias, cfg, is_test,
                      scan_layers=scan_layers, scan_remat=scan_remat)
    logits = decoder(tgt, enc_out, self_bias, cross_bias, cfg, is_test,
                     scan_layers=scan_layers, scan_remat=scan_remat)

    if label_smooth_eps:
        oh = layers.one_hot(layers.unsqueeze(lbl, [2]), cfg.tgt_vocab)
        smoothed = layers.label_smooth(oh, epsilon=label_smooth_eps)
        loss = layers.softmax_with_cross_entropy(logits, smoothed,
                                                 soft_label=True)
    else:
        loss = layers.softmax_with_cross_entropy(
            logits, layers.unsqueeze(lbl, [2]))
    w = layers.unsqueeze(tgt_mask, [2])
    loss = layers.elementwise_mul(loss, w)
    avg_loss = layers.elementwise_div(
        layers.reduce_sum(loss), layers.reduce_sum(w) + 1e-9)
    if not is_test:
        lr_var = layers.noam_decay(cfg.d_model, warmup, lr)
        opt = fluid.optimizer.AdamOptimizer(
            learning_rate=lr_var, beta1=0.9, beta2=0.997, epsilon=1e-9)
        opt.minimize(avg_loss)
    return avg_loss, ["src_ids", "tgt_ids", "lbl_ids", "src_mask",
                      "tgt_mask"]


# ---------------------------------------------------------------------------
# beam-search decoding over the trained scope
# ---------------------------------------------------------------------------

def _np_params(scope, names):
    """The params by their unrolled names. A scope trained with
    `scan_layers=True` holds the stacked '<pre>_stack*' tensors instead:
    the per-layer name 'pre_i_rest' is then row i of the stack."""
    out = {}
    for n in names:
        v = scope.find_var(n)
        if v is None:
            m = re.match(r"^(enc|dec)_(\d+)(_.*)$", n)
            if m:
                stacked = scope.find_var(
                    "%s_stack%s" % (m.group(1), m.group(3)))
                if stacked is not None:
                    out[n] = stacked[int(m.group(2))]
                    continue
            raise RuntimeError("param %r missing from scope" % n)
        out[n] = v
    return out


def layer_param_suffixes(pre):
    """The per-layer parameter suffixes of an encoder ('enc') or decoder
    ('dec') layer: the unrolled names are 'enc_3' + suffix, the stacked
    ones 'enc_stack' + suffix."""
    kinds = ["_selfattn"] + (["_crossattn"] if pre == "dec" else [])
    sufs = []
    for a in kinds:
        for p in ("_q", "_k", "_v", "_o"):
            sufs += [a + p + ".w", a + p + ".b"]
    for f in ("_ffn_fc0", "_ffn_fc1"):
        sufs += [f + ".w", f + ".b"]
    lns = ("_ln0", "_ln1") if pre == "enc" else ("_ln0", "_ln1", "_ln2")
    for ln in lns:
        sufs += [ln + ".scale", ln + ".bias"]
    return sufs


def _collect_param_names(cfg):
    names = ["src_word_emb", "tgt_word_emb"]
    for pre in ("enc", "dec"):
        for i in range(cfg.n_layer):
            names += ["%s_%d%s" % (pre, i, suf)
                      for suf in layer_param_suffixes(pre)]
    names += ["dec_out_proj.w", "dec_out_proj.b"]
    return names


_TABLES = ("src_word_emb", "tgt_word_emb")


@torch.no_grad()
def beam_search_decode(scope, src_ids, src_mask, cfg, beam_size=4,
                       max_out_len=32, bos_id=0, eos_id=1, alpha=0.6,
                       device=None, stats=None):
    """Beam search over the trained scope's params.

    src_ids: [B, S] int; src_mask: [B, S] float (numpy arrays or
    tensors). Returns (seqs [B, beam, T + 1] int32 with seqs[..., 0] ==
    bos_id, scores [B, beam] float32: each beam's log-probability over
    the GNMT length penalty ((5 + length) / 6) ** alpha), tensors on the
    device. `device` is where the scope's params live (``None``: the
    card; ``"cpu"`` to decode on the CPU); a param elsewhere raises.

    Each step keeps the K best of the K * V continuations of every
    sentence (equal scores: the lower index first, as `lax.top_k`); a
    finished beam continues only with eos at no cost. The loop reads on
    the host after each step whether every beam has finished. With a
    `stats` dict it also records per sentence the smallest gap between
    adjacent scores among the K + 1 best candidates of any step
    (`stats["min_topk_margin"]`, a [B] tensor) and the steps run.
    """
    from ..core.place import resolve_device

    dev = resolve_device(device)
    p = _np_params(scope, _collect_param_names(cfg))
    for n, v in p.items():
        if v.device != dev:
            raise RuntimeError(
                "param %r is on %s, not on the decode device %s"
                % (n, v.device, dev))
    # the products promote bf16 params to float32 as jnp does (the
    # activations are float32 from the positional encoding on); the
    # tables keep their dtype, so a lookup rounds as the reference's
    p = {n: v if n in _TABLES or not v.is_floating_point()
         else v.to(torch.promote_types(v.dtype, torch.float32))
         for n, v in p.items()}
    d_head = cfg.d_model // cfg.n_head
    pe = torch.as_tensor(_positional_encoding(cfg.max_len, cfg.d_model),
                         device=dev)

    def ln(x, nm):
        mu = torch.mean(x, -1, keepdim=True)
        var = torch.mean(torch.square(x - mu), -1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * p[nm + ".scale"] \
            + p[nm + ".bias"]

    def proj(x, nm):
        return x @ p[nm + ".w"] + p[nm + ".b"]

    def heads(t):
        return t.reshape(t.shape[:-1] + (cfg.n_head, d_head)) \
            .transpose(-3, -2)

    def attn(q_in, k, v, bias, nm):
        q = heads(proj(q_in, nm + "_q"))
        s = q @ k.transpose(-1, -2) / math.sqrt(d_head)
        if bias is not None:
            s = s + bias
        ctx = (torch.softmax(s, -1) @ v).transpose(-3, -2)
        return proj(ctx.reshape(ctx.shape[:-2] + (cfg.d_model,)),
                    nm + "_o")

    def embed(ids, table, offset):
        e = p[table][ids.long()] * math.sqrt(cfg.d_model)
        return e + pe[offset:offset + ids.shape[-1]]

    src = torch.as_tensor(np.asarray(src_ids, "int32"), device=dev) \
        if not isinstance(src_ids, torch.Tensor) else src_ids.to(dev)
    mask = torch.as_tensor(np.asarray(src_mask, "float32"), device=dev) \
        if not isinstance(src_mask, torch.Tensor) else src_mask.to(dev)
    B, _ = src.shape
    K, T, V = beam_size, max_out_len, cfg.tgt_vocab
    src_bias = ((1.0 - mask) * -1e4)[:, None, None, :]

    x = embed(src, "src_word_emb", 0)
    for i in range(cfg.n_layer):
        nm = "enc_%d" % i
        k = heads(proj(x, nm + "_selfattn_k"))
        v = heads(proj(x, nm + "_selfattn_v"))
        x = ln(x + attn(x, k, v, src_bias, nm + "_selfattn"), nm + "_ln0")
        h = torch.relu(proj(x, nm + "_ffn_fc0"))
        x = ln(x + proj(h, nm + "_ffn_fc1"), nm + "_ln1")

    # beams: row b * K + j is beam j of sentence b
    enc_b = torch.repeat_interleave(x, K, dim=0)
    bias_b = torch.repeat_interleave(src_bias, K, dim=0)
    cross_kv = [(heads(proj(enc_b, "dec_%d_crossattn_k" % i)),
                 heads(proj(enc_b, "dec_%d_crossattn_v" % i)))
                for i in range(cfg.n_layer)]
    seqs = torch.full((B * K, T + 1), eos_id, dtype=torch.int32,
                      device=dev)
    seqs[:, 0] = bos_id
    # the first beam starts at 0, the rest at -1e9, so the first step
    # picks K distinct continuations of the first
    scores = torch.tensor([0.0] + [-1e9] * (K - 1),
                          device=dev).repeat(B)
    finished = torch.zeros(B * K, dtype=torch.bool, device=dev)
    cache = [(torch.zeros(B * K, cfg.n_head, T, d_head, device=dev),
              torch.zeros(B * K, cfg.n_head, T, d_head, device=dev))
             for _ in range(cfg.n_layer)]
    eos_only = torch.full((V,), -1e9, device=dev)
    eos_only[eos_id] = 0.0
    positions = torch.arange(T, device=dev)
    row0 = torch.arange(B, device=dev)[:, None] * K
    margin = torch.full((B,), float("inf"), device=dev) \
        if stats is not None else None

    t = 0
    while t < T and not bool(finished.all()):
        x = embed(seqs[:, t:t + 1], "tgt_word_emb", t)
        # causal: positions after t are masked
        tmask = ((positions > t) * -1e9)[None, None, None, :]
        for i in range(cfg.n_layer):
            nm = "dec_%d" % i
            ck, cv = cache[i]
            ck[:, :, t:t + 1] = heads(proj(x, nm + "_selfattn_k"))
            cv[:, :, t:t + 1] = heads(proj(x, nm + "_selfattn_v"))
            x = ln(x + attn(x, ck, cv, tmask, nm + "_selfattn"),
                   nm + "_ln0")
            ki, vi = cross_kv[i]
            x = ln(x + attn(x, ki, vi, bias_b, nm + "_crossattn"),
                   nm + "_ln1")
            h = torch.relu(proj(x, nm + "_ffn_fc0"))
            x = ln(x + proj(h, nm + "_ffn_fc1"), nm + "_ln2")
        logp = torch.log_softmax(proj(x[:, 0], "dec_out_proj"), -1)
        logp = torch.where(finished[:, None], eos_only[None, :], logp)
        cand = (scores[:, None] + logp).reshape(B, K * V)
        # the K best, the lower index first among equal scores
        vals, idx = torch.sort(cand, dim=-1, descending=True, stable=True)
        top_scores, top_idx = vals[:, :K], idx[:, :K]
        if margin is not None:
            gaps = vals[:, :K] - vals[:, 1:K + 1]
            margin = torch.minimum(margin, gaps.min(-1).values)
        flat_beam = (torch.div(top_idx, V, rounding_mode="floor")
                     + row0).reshape(-1)
        tok = (top_idx % V).to(torch.int32).reshape(-1)
        seqs = seqs[flat_beam]
        seqs[:, t + 1] = tok
        scores = top_scores.reshape(-1)
        finished = finished[flat_beam] | (tok == eos_id)
        cache = [(ck[flat_beam], cv[flat_beam]) for ck, cv in cache]
        t += 1

    lengths = torch.sum((seqs[:, 1:] != eos_id).to(torch.float32), -1) + 1.0
    lp = torch.pow((5.0 + lengths) / 6.0, alpha)
    if stats is not None:
        stats.update(min_topk_margin=margin, steps=t)
    return seqs.reshape(B, K, T + 1), (scores / lp).reshape(B, K)
