"""Decode-step model over the paged KV cache (counterpart:
`paddle_tpu/serving/model.py`).

`TinyDecoderLM` is a small pre-LN transformer LM written directly
against the paged cache: one `forward` serves BOTH prefill (T > 1
query tokens per sequence) and decode (T == 1) — the new tokens' K/V
are written into the sequence's pages first (invalid rows skipped), then
`ragged_paged_attention` attends through the block table. Every shape
is fixed per (batch, T) bucket.

The page tensors are updated IN PLACE: every row's K/V is `index_put_`
into the resident pages, the inactive rows' into the pool's scratch page
(the last page of the page tensors, `KVCacheConfig.scratch_page`, which
the pool never hands out and no block table names). The JAX package
rebuilt the page arrays each step with a scatter in ``mode="drop"``;
writing a fixed number of rows keeps every shape fixed per bucket and
the step free of host reads, so a bucket can be captured as a CUDA graph
(`serving/aot.py`). Greedy selection (argmax) runs inside the step;
sampled rows are drawn after it by `sample_tokens`, on the host.

`dense_decode_reference` greedy-decodes one prompt with dense causal
attention and NO paging/engine at all — the independent golden the
engine's token streams are checked against.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..ops.kernels.flash_attention import reference_attention
from ..ops.kernels.ragged_paged_attention import ragged_paged_attention
from .kv_cache import KVCacheConfig

__all__ = ["TinyLMConfig", "TinyDecoderLM", "dense_decode_reference",
           "sample_tokens"]


def _row_seed(seed: int, step: int) -> int:
    """The generator seed of one sampled token: a pure function of
    (request seed, token index), never of the batch packing. The CPU
    generator keeps only 32 bits of its seed, so the pair is mixed
    (splitmix64) and folded to 32 bits."""
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    z ^= z >> 31
    return (z ^ (z >> 32)) & 0xFFFFFFFF


def sample_tokens(last_logits, temps, top_ks, top_ps, seeds, steps):
    """Per-row token selection beyond greedy argmax: temperature /
    top-k / top-p sampling, batch-size independent by construction.

    last_logits [S, V] f32; temps [S] f32 (0 = greedy argmax for that
    row); top_ks [S] i32 (0 = no top-k filter); top_ps [S] f32 (1 = no
    nucleus filter); seeds [S] i32 per-request keys; steps [S] i32 the
    stream index of the token being drawn.

    Each sampled row draws on the host from a `torch.Generator` seeded
    by (seed, step) alone, and every other op is row-wise, so a sampled
    stream is reproducible per seed and identical whether decoded
    batched, sequentially, preempted or migrated. The draws cannot match
    the JAX package's `jax.random` bits; greedy rows (temps == 0) can."""
    V = last_logits.shape[-1]
    greedy = last_logits.argmax(dim=-1).to(torch.int32)
    t = torch.where(temps > 0, temps, torch.ones_like(temps))[:, None]
    scaled = last_logits / t
    order = torch.argsort(-scaled, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    k_eff = torch.where(top_ks > 0, top_ks.clamp(max=V),
                        torch.full_like(top_ks, V))[:, None]
    keep_k = ranks < k_eff
    sorted_probs = torch.softmax(torch.gather(scaled, -1, order), dim=-1)
    # exclusive cumulative mass < p keeps the smallest prefix whose
    # mass reaches p (the top-1 row always survives)
    excl = torch.cumsum(sorted_probs, dim=-1) - sorted_probs
    p_eff = torch.where((top_ps > 0) & (top_ps < 1), top_ps,
                        torch.ones_like(top_ps))[:, None]
    keep_p = torch.gather(excl < p_eff, -1, ranks)
    masked = torch.where(keep_k & keep_p, scaled,
                         torch.full_like(scaled, float("-inf")))
    out = greedy.clone()
    temps_h = temps.cpu().tolist()
    for b in [b for b, tb in enumerate(temps_h) if tb > 0]:
        gen = torch.Generator().manual_seed(
            _row_seed(int(seeds[b]), int(steps[b])))
        probs = torch.softmax(masked[b].float().cpu(), dim=-1)
        out[b] = int(torch.multinomial(probs, 1, generator=gen))
    return out


@dataclass(frozen=True)
class TinyLMConfig:
    vocab: int = 64
    embed: int = 32
    layers: int = 2
    heads: int = 2          # query heads
    kv_heads: int = 2       # Hq % Hkv == 0 (GQA groups = Hq // Hkv)
    head_dim: int = 16
    ffn: int = 64
    max_seq: int = 64

    def __post_init__(self):
        if self.heads % self.kv_heads:
            raise ValueError("heads %d not a multiple of kv_heads %d"
                             % (self.heads, self.kv_heads))


def _param(*shape):
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


class _Layer(nn.Module):
    def __init__(self, c: TinyLMConfig):
        super().__init__()
        hq, hkv, d = c.heads, c.kv_heads, c.head_dim
        self.ln1_g = _param(c.embed)
        self.ln1_b = _param(c.embed)
        self.wq = _param(c.embed, hq * d)
        self.wk = _param(c.embed, hkv * d)
        self.wv = _param(c.embed, hkv * d)
        self.wo = _param(hq * d, c.embed)
        self.ln2_g = _param(c.embed)
        self.ln2_b = _param(c.embed)
        self.w1 = _param(c.embed, c.ffn)
        self.w2 = _param(c.ffn, c.embed)


def _ln(x, g, b):
    """`forward`'s LayerNorm: multiply by rsqrt, as the JAX model does."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * g + b


def _ln_div(x, g, b):
    """`dense_decode_reference`'s LayerNorm: divide by sqrt, as written
    in the JAX reference."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-6) * g + b


class TinyDecoderLM(nn.Module):
    """The serving model as an `nn.Module`. Parameter names follow the
    JAX params dict: ``emb``, ``pos``, ``lnf_g``, ``lnf_b`` and
    ``layers.{i}.{ln1_g,ln1_b,wq,wk,wv,wo,ln2_g,ln2_b,w1,w2}``. Weights
    are created as zeros; `init_params(seed)` or
    `convert.load_jax_params` fills them."""

    def __init__(self, config: Optional[TinyLMConfig] = None,
                 attention_impl: str = "auto"):
        super().__init__()
        self.config = c = config or TinyLMConfig()
        self.attention_impl = attention_impl
        self.emb = _param(c.vocab, c.embed)
        self.pos = _param(c.max_seq, c.embed)
        self.lnf_g = _param(c.embed)
        self.lnf_b = _param(c.embed)
        self.layers = nn.ModuleList(_Layer(c) for _ in range(c.layers))

    def kv_cache_spec(self, num_pages: int, page_size: int,
                      pages_per_seq: int,
                      dtype: str = "float32") -> KVCacheConfig:
        c = self.config
        return KVCacheConfig(
            num_pages=num_pages, page_size=page_size,
            pages_per_seq=pages_per_seq, num_layers=c.layers,
            num_kv_heads=c.kv_heads, head_dim=c.head_dim, dtype=dtype)

    @torch.no_grad()
    def init_params(self, seed: int = 0) -> "TinyDecoderLM":
        """Fill the weights in place from a `torch.Generator` seeded with
        `seed`, on the parameters' device: N(0, 0.02) for matrices, ones
        and zeros for LayerNorm gains and biases (the JAX scheme; the
        random streams differ)."""
        gen = torch.Generator(device=self.emb.device).manual_seed(int(seed))
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("_g"):
                p.fill_(1.0)
            elif leaf.endswith("_b"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=gen)
        return self

    # -- the (pre|de)fill step --------------------------------------------
    @torch.no_grad()
    def forward(self, tokens, pages, block_tables, context_lens, q_lens,
                sampling=None):
        """One serving step over a fixed-shape bucket.

        tokens [S, T] int32; pages: list of (k_pages, v_pages) per
        layer — or (k_pages, v_pages, k_scale, v_scale) 4-tuples from
        an int8 pool, in which case new K/V rows quantize on write
        (per-token-row abs-max / 127, the scale written alongside) and
        attention dequantizes through the same block table;
        block_tables [S, pages_per_seq] int32; context_lens [S] int32
        (INCLUDING this call's q_lens tokens); q_lens [S] int32 (0 =
        inactive slot: nothing written, zero logits, token 0). All on
        the parameters' device. The page tensors' last page is the
        scratch page the inactive rows are written to.

        `sampling`, when given, is the per-row 5-tuple (temps, top_ks,
        top_ps, seeds, steps) routed to `sample_tokens`; None is
        pure-greedy selection (identical to temps == 0).

        Returns (next_tokens [S] int32, last_logits [S, vocab] f32,
        pages) — `pages` is the same list, written in place."""
        c = self.config
        S, T = tokens.shape
        page_size = pages[0][0].shape[1]
        dev = tokens.device

        rowi = torch.arange(T, device=dev, dtype=torch.int32)[None, :]
        pos = (context_lens - q_lens)[:, None] + rowi          # [S, T]
        valid = rowi < q_lens[:, None]
        pos_c = pos.clamp(0, c.max_seq - 1).long()
        page_of = torch.gather(
            block_tables.long(), 1,
            (pos_c // page_size).clamp(0, block_tables.shape[1] - 1))
        # every row is written; the inactive ones to the scratch page
        scratch = pages[0][0].shape[0] - 1
        w_page = torch.where(valid, page_of,
                             torch.full_like(page_of, scratch)).reshape(-1)
        w_slot = (pos_c % page_size).reshape(-1)

        x = self.emb[tokens.long()] + self.pos[pos_c]           # [S, T, E]
        for layer, entry in zip(self.layers, pages):
            h = _ln(x, layer.ln1_g, layer.ln1_b)
            q = (h @ layer.wq).reshape(S, T, c.heads, c.head_dim)
            k = (h @ layer.wk).reshape(S * T, c.kv_heads, c.head_dim)
            v = (h @ layer.wv).reshape(S * T, c.kv_heads, c.head_dim)
            if len(entry) == 4:
                # int8 pool: per-token-row abs-max quantize-on-write
                k_pages, v_pages, k_scale, v_scale = entry
                ks = k.abs().amax(dim=(1, 2)) / 127.0           # [S*T]
                vs = v.abs().amax(dim=(1, 2)) / 127.0
                ks = torch.where(ks > 0, ks, torch.ones_like(ks))
                vs = torch.where(vs > 0, vs, torch.ones_like(vs))
                kq = torch.round(k / ks[:, None, None]).clamp(
                    -127, 127).to(torch.int8)
                vq = torch.round(v / vs[:, None, None]).clamp(
                    -127, 127).to(torch.int8)
                k_pages.index_put_((w_page, w_slot), kq)
                v_pages.index_put_((w_page, w_slot), vq)
                k_scale.index_put_((w_page, w_slot), ks)
                v_scale.index_put_((w_page, w_slot), vs)
                attn = ragged_paged_attention(
                    q, k_pages, v_pages, block_tables, context_lens,
                    q_lens, impl=self.attention_impl,
                    k_scale=k_scale, v_scale=v_scale)
            else:
                k_pages, v_pages = entry
                k_pages.index_put_((w_page, w_slot), k.to(k_pages.dtype))
                v_pages.index_put_((w_page, w_slot), v.to(v_pages.dtype))
                attn = ragged_paged_attention(
                    q, k_pages, v_pages, block_tables, context_lens,
                    q_lens, impl=self.attention_impl)
            x = x + attn.reshape(S, T, c.heads * c.head_dim) @ layer.wo
            h2 = _ln(x, layer.ln2_g, layer.ln2_b)
            x = x + torch.relu(h2 @ layer.w1) @ layer.w2

        # only each sequence's last valid row reaches the LM head
        last = (q_lens - 1).clamp(0, T - 1).long()
        xl = _ln(x[torch.arange(S, device=dev), last],
                 self.lnf_g, self.lnf_b)
        last_logits = xl @ self.emb.T                           # [S, V]
        last_logits = torch.where((q_lens > 0)[:, None], last_logits,
                                  torch.zeros_like(last_logits))
        if sampling is not None:
            next_tokens = sample_tokens(last_logits, *sampling)
        else:
            next_tokens = last_logits.argmax(dim=-1).to(torch.int32)
        return next_tokens, last_logits, pages


@torch.no_grad()
def dense_decode_reference(model: TinyDecoderLM, prompt,
                           max_new_tokens: int,
                           eos_id: Optional[int] = None,
                           temperature: float = 0.0, top_k: int = 0,
                           top_p: float = 1.0,
                           seed: int = 0) -> List[int]:
    """Decode ONE prompt with dense causal attention and no paging —
    full-context logits recomputed per token (O(T^2); golden only), with
    the module's own weights on their device. Matches the serving
    semantics: the first generated token comes from the last prompt
    position, and sampling draws through the same `sample_tokens`
    schedule the engine uses (token index n draws with step n)."""
    c = model.config
    dev = model.emb.device

    def logits_for(ids) -> torch.Tensor:
        T = len(ids)
        x = model.emb[torch.as_tensor(ids, device=dev)] + model.pos[:T]
        g = c.heads // c.kv_heads
        for layer in model.layers:
            h = _ln_div(x, layer.ln1_g, layer.ln1_b)
            q = (h @ layer.wq).reshape(T, c.heads, c.head_dim)
            k = (h @ layer.wk).reshape(T, c.kv_heads, c.head_dim)
            v = (h @ layer.wv).reshape(T, c.kv_heads, c.head_dim)
            k = k.repeat_interleave(g, dim=1)
            v = v.repeat_interleave(g, dim=1)
            o = reference_attention(
                q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                v.transpose(0, 1)[None], causal=True)
            x = x + o[0].transpose(0, 1).reshape(
                T, c.heads * c.head_dim) @ layer.wo
            h2 = _ln_div(x, layer.ln2_g, layer.ln2_b)
            x = x + torch.relu(h2 @ layer.w1) @ layer.w2
        x = _ln_div(x, model.lnf_g, model.lnf_b)
        return x[-1] @ model.emb.T

    ids = [int(t) for t in np.asarray(prompt).reshape(-1)]
    out: List[int] = []
    for n in range(int(max_new_tokens)):
        lg = logits_for(ids)
        if temperature > 0:
            tok = int(sample_tokens(
                lg[None].float(),
                torch.tensor([temperature], dtype=torch.float32,
                             device=dev),
                torch.tensor([top_k], dtype=torch.int32, device=dev),
                torch.tensor([top_p], dtype=torch.float32, device=dev),
                torch.tensor([seed], dtype=torch.int32, device=dev),
                torch.tensor([n], dtype=torch.int32, device=dev))[0])
        else:
            tok = int(lg.argmax())
        out.append(tok)
        if eos_id is not None and tok == eos_id:
            break
        ids.append(tok)
    return out
