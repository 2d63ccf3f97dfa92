"""The transformer trainer on PyTorch (counterpart:
`paddle_tpu/parallel/transformer.py`).

A GPT-style causal LM with a tied LM head, trained with the reference's
own Adam, in one eager PyTorch step on explicit tensors: embedding, then
``n_layers`` pre-LayerNorm blocks (flash attention on the card), then the
float32 loss head, `torch.autograd` for the gradients, and the update.

The reference runs one `shard_map`ped, jitted program over a
("dp", "pp", "tp") mesh. The port runs dp = pp = tp = 1 with
``sp_mode="megatron"`` only: the mesh collectives come with
`torch.distributed` (ROADMAP Queue 1 #7), and Ulysses and ring attention
with the scale-out slice (Queue 1 #10). Parameters keep the reference's
tree and its stacked ``[pp, layers_per_stage, ...]`` layer leaves, so
`params_from_numpy` / `params_to_numpy` carry a JAX tree across key by
key.

    cfg = SPMDConfig()
    params = init_params(cfg, seed=0)              # on cuda:0
    opt = init_opt_state(params)
    step = make_train_step(cfg)
    tokens, labels = demo_batch(cfg, batch_global=8)
    for i in range(n):
        params, opt, loss = step(params, opt, tokens, labels, i)
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.place import resolve_device
from ..ops.kernels.flash_attention import flash_attention

__all__ = ["SPMDConfig", "init_params", "init_opt_state", "make_train_step",
           "demo_batch", "params_from_numpy", "params_to_numpy"]

# Adam of the reference (`make_train_step`): b1, b2, eps and base lr
_B1, _B2, _EPS, _LR = 0.9, 0.95, 1e-8, 1e-4


@dataclasses.dataclass(frozen=True)
class SPMDConfig:
    vocab: int = 32000
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072
    seq_len: int = 512
    n_layers: int = 12          # total across all pp stages
    dp: int = 1
    pp: int = 1
    tp: int = 1
    n_micro: int = 1            # microbatches per step
    dropout: float = 0.0        # unused by the block, as in the reference
    dtype: str = "bfloat16"     # compute dtype (params/opt state fp32)
    remat: bool = True          # recompute each layer in backward
    use_flash: bool = None      # flash attention (None = on a CUDA device)
    sp_mode: str = "megatron"   # "megatron" | "ulysses" (not ported)

    def __post_init__(self):
        if self.sp_mode not in ("megatron", "ulysses"):
            raise ValueError(
                "sp_mode must be 'megatron' or 'ulysses', got %r"
                % (self.sp_mode,))

    @property
    def layers_per_stage(self):
        assert self.n_layers % self.pp == 0
        return self.n_layers // self.pp

    @property
    def d_head(self):
        return self.d_model // self.n_heads


def _check_ported(cfg):
    if (cfg.dp, cfg.pp, cfg.tp) != (1, 1, 1):
        raise NotImplementedError(
            "dp/pp/tp = %d/%d/%d: the trainer runs one device; its mesh "
            "over torch.distributed comes with the second half of ROADMAP "
            "Queue 1 #7"
            % (cfg.dp, cfg.pp, cfg.tp))
    if cfg.sp_mode != "megatron":
        raise NotImplementedError(
            "sp_mode=%r: Ulysses and ring attention are not ported yet "
            "(ROADMAP Queue 1 #10)" % (cfg.sp_mode,))


def _compute_dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg, seed=0, device=None):
    """The reference's tree, shapes and scales (normal * 0.02; the output
    projections * 0.02 / sqrt(2 n_layers); LayerNorm 1 and 0), drawn from
    a torch generator on `device` (default cuda:0). The values cannot
    match `jax.random`'s; carry a JAX tree across with
    `params_from_numpy` to compare."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    D, Fd, V, S = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.seq_len
    P_, L = cfg.pp, cfg.layers_per_stage
    std = 0.02
    out_std = std / math.sqrt(2 * cfg.n_layers)

    def nrm(shape, scale=std):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def const(shape, value):
        return torch.full(shape, float(value), device=dev)

    return {
        "embed": nrm((V, D)),
        "pos": nrm((S, D)),
        "ln_f": {"scale": const((D,), 1.0), "bias": const((D,), 0.0)},
        "layers": {
            "ln1_s": const((P_, L, D), 1.0),
            "ln1_b": const((P_, L, D), 0.0),
            "wqkv": nrm((P_, L, D, 3, D)),
            "wo": nrm((P_, L, D, D), out_std),
            "ln2_s": const((P_, L, D), 1.0),
            "ln2_b": const((P_, L, D), 0.0),
            "w1": nrm((P_, L, D, Fd)),
            "b1": const((P_, L, Fd), 0.0),
            "w2": nrm((P_, L, Fd, D), out_std),
            "b2": const((P_, L, D), 0.0),
        },
    }


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_opt_state(params):
    """Adam's first and second moments: float32 zeros like every leaf."""
    return (_tree_map(torch.zeros_like, params),
            _tree_map(torch.zeros_like, params))


def params_from_numpy(tree, device=None):
    """A tree of arrays (e.g. the JAX `init_params`) as float32 tensors on
    `device` (default cuda:0), keys and shapes unchanged."""
    dev = resolve_device(device)
    return _tree_map(lambda a: torch.tensor(
        np.asarray(a, dtype=np.float32), device=dev), tree)


def params_to_numpy(params):
    """The tree as numpy float32 arrays, for the JAX side."""
    return _tree_map(lambda t: t.detach().float().cpu().numpy(), params)


def demo_batch(cfg, batch_global, seed=0):
    r = np.random.RandomState(seed)
    tokens = r.randint(0, cfg.vocab,
                       (cfg.n_micro, batch_global, cfg.seq_len))
    labels = np.roll(tokens, -1, axis=-1)
    return tokens.astype(np.int32), labels.astype(np.int32)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _layer_norm(x, scale, bias):
    """float32 LayerNorm, eps 1e-5 (the reference's `ln`, before its cast)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + 1e-5) * scale + bias


def _layer_fn(cfg, attn_impl, x, ln1_s, ln1_b, wqkv, wo, ln2_s, ln2_b, w1,
              b1, w2, b2):
    """One pre-LN block on x [B, S, D] in the compute dtype (the
    reference's `_layer_fn` at tp = 1)."""
    cdt = _compute_dtype(cfg)
    B, S, D = x.shape
    H, dh = cfg.n_heads, cfg.d_head

    h = _layer_norm(x, ln1_s, ln1_b).to(cdt)
    qkv = torch.einsum("bsd,dke->bske", h, wqkv.to(cdt))  # [B, S, 3, D]

    def to_heads(t):
        return t.reshape(B, S, H, dh).transpose(1, 2)

    q, k, v = (to_heads(qkv[:, :, i]) for i in range(3))
    if cfg.use_flash:
        ctx = flash_attention(q, k, v, causal=True,
                              sm_scale=1.0 / math.sqrt(dh),
                              impl=attn_impl).to(cdt)
    else:
        scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(dh)
        causal = torch.triu(torch.full((S, S), -1e9, dtype=torch.float32,
                                       device=x.device), diagonal=1)
        probs = torch.softmax(scores + causal, dim=-1).to(cdt)
        ctx = (probs @ v).to(cdt)
    ctx = ctx.transpose(1, 2).reshape(B, S, D)
    x = x + ctx @ wo.to(cdt)

    h = _layer_norm(x, ln2_s, ln2_b).to(cdt)
    a = F.gelu(h @ w1.to(cdt) + b1.to(cdt), approximate="tanh")
    mlp_out = a @ w2.to(cdt) + b2.to(cdt)
    return x + mlp_out


_LAYER_KEYS = ("ln1_s", "ln1_b", "wqkv", "wo", "ln2_s", "ln2_b", "w1", "b1",
               "w2", "b2")


def _forward_loss(cfg, attn_impl, p, tokens, labels):
    """Summed token NLL over B·S of one microbatch, divided by B·S (the
    reference's `_embed_fn`, `_stage_fn` and `_loss_fn`)."""
    cdt = _compute_dtype(cfg)
    S = tokens.shape[1]
    x = (p["embed"][tokens] + p["pos"][None, :S]).to(cdt)
    # unbind, not per-layer indexing: its backward stacks the layers'
    # gradients once, where each index would add a zero-filled copy of
    # the whole stacked leaf
    per_layer = zip(*(p["layers"][key][0].unbind(0) for key in _LAYER_KEYS))
    for lp in per_layer:
        if cfg.remat:
            x = checkpoint(_layer_fn, cfg, attn_impl, x, *lp,
                           use_reentrant=False)
        else:
            x = _layer_fn(cfg, attn_impl, x, *lp)
    h = _layer_norm(x, p["ln_f"]["scale"], p["ln_f"]["bias"])
    logits = h @ p["embed"].T
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    return nll.sum() / (labels.shape[0] * labels.shape[1])


def _indices(a, dev):
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    return a.to(dev).long()


def make_train_step(cfg, device=None, with_grads=False, attn_impl="auto"):
    """Returns ``step(params, opt_state, tokens, labels, step)`` ->
    ``(params, opt_state, loss)``, or ``(params, opt_state, loss, grads)``
    when `with_grads`. tokens/labels: [n_micro, B, S] integer arrays or
    tensors. The returned params and moments are new tensors.

    `device` defaults to cuda:0 and raises without a card.
    ``use_flash=None`` turns flash attention on for a CUDA device, as the
    reference turns it on when no mesh device is a CPU. `attn_impl` goes to
    `flash_attention` ("auto": the kernels on the card, the plain version
    on the CPU; "reference": the plain version anywhere)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    if cfg.use_flash is None:
        cfg = dataclasses.replace(cfg, use_flash=dev.type == "cuda")
    n_micro = cfg.n_micro

    def train_step(params, opt_state, tokens, labels, step):
        tokens, labels = _indices(tokens, dev), _indices(labels, dev)
        p = _tree_map(lambda t: t.detach().requires_grad_(True), params)
        leaves = []
        _tree_map(leaves.append, p)
        loss = sum(_forward_loss(cfg, attn_impl, p, tokens[t], labels[t])
                   for t in range(n_micro)) / (n_micro * cfg.dp)
        flat = torch.autograd.grad(loss, leaves)
        it = iter(flat)
        grads = _tree_map(lambda _: next(it), p)

        with torch.no_grad():
            t = torch.tensor(float(step) + 1.0, dtype=torch.float32,
                             device=dev)
            lr = _LR * torch.clamp(t / 100.0, max=1.0)
            corr = torch.sqrt(1 - _B2 ** t) / (1 - _B1 ** t)
            m_, v_ = opt_state

            def upd(p_, m0, v0, g):
                g32 = g.float()
                m2 = _B1 * m0 + (1 - _B1) * g32
                v2 = _B2 * v0 + (1 - _B2) * g32.square()
                p2 = p_.detach() - lr * corr * m2 / (torch.sqrt(v2) + _EPS)
                return p2, m2, v2

            out = _tree_map(upd, params, m_, v_, grads)
            new_p = _tree_map(lambda o: o[0], out)
        new_m = _tree_map(lambda o: o[1], out)
        new_v = _tree_map(lambda o: o[2], out)
        if with_grads:
            return new_p, (new_m, new_v), loss.detach(), grads
        return new_p, (new_m, new_v), loss.detach()

    return train_step
