"""The transformer trainer on PyTorch (counterpart:
`paddle_tpu/parallel/transformer.py`).

A GPT-style causal LM with a tied LM head, trained with the reference's
own Adam, in one eager PyTorch step on explicit tensors: embedding, then
``n_layers`` pre-LayerNorm blocks (flash attention on the card), then the
float32 loss head, `torch.autograd` for the gradients, and the update.

The reference runs one `shard_map`ped, jitted program over a
("dp", "pp", "tp") mesh. The port runs one process per device over a
`parallel.env.Mesh` of `torch.distributed` groups with the same axes,
and its step makes the reference's collectives explicit
(`mesh_collectives.py`):

- dp: each rank takes its rows of the batch; the gradients are summed
  over the ranks a parameter is replicated on.
- pp: GPipe. The layers are stacked on a leading stage dim; stage s runs
  microbatch t - s at tick t and hands its output to stage s + 1. The
  port drives the schedule itself, tick by tick: the forward of every
  microbatch, then the backward of each in reverse, each stage sending
  the gradient of its input back (`torch.autograd.backward` a microbatch,
  so every rank of a group runs the same collectives in the same order,
  remat's recomputed ones too). The reference's bubble ticks compute
  values it masks out, with exactly zero gradient; the port skips them.
- tp, ``sp_mode="megatron"``: sequence parallelism between blocks;
  all-gather of the sequence before attention and the MLP,
  reduce-scatter after the row-parallel `wo` and `w2`, q/k/v and `w1`
  column-parallel, attention on H/tp heads.
- tp, ``sp_mode="ulysses"``: weights replicated, the sequence sharded,
  attention re-sharded by two all-to-alls (`ulysses.py`).

With no mesh the step is the same code with every collective an
identity. Parameters keep the reference's tree and its stacked ``[pp,
layers_per_stage, ...]`` layer leaves; `shard_params` slices a global
tree to a rank's shard by `param_specs`, and `params_to_numpy` gathers
the shards back.

    cfg = SPMDConfig(dp=1, pp=2, tp=2)
    mesh = cfg.mesh()                              # in each of 4 ranks
    params = shard_params(init_params(cfg, seed=0), cfg, mesh)
    opt = init_opt_state(params)
    step = make_train_step(cfg, mesh)
    tokens, labels = demo_batch(cfg, batch_global=8)
    for i in range(n):
        params, opt, loss = step(params, opt, tokens, labels, i)
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import axis_rules
from . import mesh_collectives as mc
from .ulysses import ulysses_attention
from ..core.place import resolve_device
from ..ops.kernels.flash_attention import flash_attention
from ..ops.nn_ops import _lookup

__all__ = ["SPMDConfig", "init_params", "init_opt_state", "make_train_step",
           "demo_batch", "params_from_numpy", "params_to_numpy",
           "param_specs", "shard_params"]

#: the mesh axes, in the order of the reference's Mesh("dp", "pp", "tp")
AXES = ("dp", "pp", "tp")

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
    sp_mode: str = "megatron"   # "megatron" (SP over tp via gather/
                                # scatter + sharded weights) or
                                # "ulysses" (all-to-all head<->sequence
                                # re-sharding, replicated weights)

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

    def mesh(self, backend=None, device=None):
        """This process's `parallel.env.Mesh` over ("dp", "pp", "tp") of
        (dp, pp, tp): the world of the launch environment laid out
        row-major, as the reference reshapes its devices. Every rank of
        the world calls it."""
        from .env import Mesh

        return Mesh(AXES, (self.dp, self.pp, self.tp), backend=backend,
                    device=device)


def _compute_dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# parameters and their shardings
# ---------------------------------------------------------------------------

#: per-param logical axis names (one a dim), resolved through
#: `axis_rules`. Layer params carry a leading 'stage' (pp) dim and a
#: 'layers' (layers_per_stage) dim from the GPipe stacking.
_LAYER_AXIS_NAMES = {
    "ln1_s": ("stage", "layers", "embed"),
    "ln1_b": ("stage", "layers", "embed"),
    "wqkv": ("stage", "layers", "embed", "qkv", "joined_kv"),
    "wo": ("stage", "layers", "joined_kv", "embed"),
    "ln2_s": ("stage", "layers", "embed"),
    "ln2_b": ("stage", "layers", "embed"),
    "w1": ("stage", "layers", "embed", "mlp"),
    "b1": ("stage", "layers", "mlp"),
    "w2": ("stage", "layers", "mlp", "embed"),
    "b2": ("stage", "layers", "embed"),
}


def _transformer_rules(cfg):
    """The Megatron column/row-parallel assignment over ("dp", "pp",
    "tp"). Under Ulysses the weights replicate over tp (which carries
    only the sequence shards), so their gradients sum over tp."""
    tp = None if cfg.sp_mode == "ulysses" else "tp"
    return (
        ("stage", "pp"),
        ("layers", None),
        ("embed", None),        # contraction dim — replicate
        ("qkv", None),          # the q/k/v selector dim
        ("joined_kv", tp),      # fused heads*kv projection dim
        ("mlp", tp),            # ffn hidden dim
        ("vocab", None),        # the embed table stays replicated here
        ("seq", None),
        ("batch", None),
    )


def param_specs(cfg):
    """The tree of specs: for each leaf, one mesh axis (or None) a dim."""
    rules = _transformer_rules(cfg)

    def res(names):
        return axis_rules.logical_to_mesh_axes(names, rules)

    return {
        "embed": res(("vocab", "embed")),
        "pos": res(("seq", "embed")),
        "ln_f": {"scale": res(("embed",)), "bias": res(("embed",))},
        "layers": {n: res(a) for n, a in _LAYER_AXIS_NAMES.items()},
    }


def _replicated_axes(spec):
    """Mesh axes a leaf is replicated over: its gradient's psum axes."""
    named = {a for a in spec if a is not None}
    return tuple(a for a in AXES if a not in named)


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


def shard_params(params, cfg, mesh):
    """This rank's shard of the global tree `params` (arrays or tensors):
    each dim that `param_specs` names a mesh axis of is cut into that
    axis's size and the rank keeps its block (the reference's
    `device_put` with NamedShardings); float32 on the mesh's device."""

    def shard(a, spec):
        t = a.detach().float() if isinstance(a, torch.Tensor) else \
            torch.as_tensor(np.asarray(a, dtype=np.float32))
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            n = mesh.axis_size(axis)
            if t.shape[dim] % n:
                raise ValueError("dim %d of %s does not split over %s=%d"
                                 % (dim, tuple(t.shape), axis, n))
            k = t.shape[dim] // n
            t = t.narrow(dim, mesh.axis_index(axis) * k, k)
        return t.to(mesh.device, copy=True).contiguous()

    return _tree_map(shard, params, param_specs(cfg))


def params_to_numpy(params, cfg=None, mesh=None):
    """The tree as numpy float32 arrays, for the JAX side. With a mesh,
    `params` are this rank's shards (of parameters, moments or
    gradients) and come back as the global tree, gathered along every
    sharded dim (`np.asarray` of the reference's global arrays); every
    rank of the mesh calls it."""
    if mesh is None:
        return _tree_map(lambda t: t.detach().float().cpu().numpy(), params)

    def gather(t, spec):
        t = t.detach().float()
        for dim, axis in enumerate(spec):
            if axis is not None:
                t = mc.all_gather(t, mesh.ring(axis), dim)
        return t.cpu().numpy()

    return _tree_map(gather, params, param_specs(cfg))


def demo_batch(cfg, batch_global, seed=0):
    r = np.random.RandomState(seed)
    tokens = r.randint(0, cfg.vocab,
                       (cfg.n_micro, batch_global, cfg.seq_len))
    labels = np.roll(tokens, -1, axis=-1)
    return tokens.astype(np.int32), labels.astype(np.int32)


# ---------------------------------------------------------------------------
# the model, one rank's part (the reference's per-device functions)
# ---------------------------------------------------------------------------

def _layer_norm(x, scale, bias):
    """float32 LayerNorm, eps 1e-5 (the reference's `ln`, before its cast)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + 1e-5) * scale + bias


def _layer_fn(cfg, attn_impl, tp, x, ln1_s, ln1_b, wqkv, wo, ln2_s, ln2_b,
              w1, b1, w2, b2):
    """One pre-LN block on the sequence shard x [B, S/tp, D] in the
    compute dtype, Megatron-SP (the reference's `_layer_fn`): the weights
    are this rank's tp shards (wqkv [D, 3, D/tp], wo [D/tp, D], w1 [D,
    F/tp], b1 [F/tp], w2 [F/tp, D]); `tp` is the rank's tp ring."""
    cdt = _compute_dtype(cfg)
    heads = cfg.n_heads // cfg.tp
    dh = cfg.d_head

    h = _layer_norm(x, ln1_s, ln1_b).to(cdt)
    h_full = mc.all_gather(h, tp, 1)                        # [B, S, D]
    B, S = h_full.shape[:2]
    # wqkv's LAST dim is tp-sharded, so each rank holds whole heads of q,
    # k and v alike
    qkv = torch.einsum("bsd,dke->bske", h_full, wqkv.to(cdt))

    def to_heads(t):
        return t.reshape(B, S, heads, dh).transpose(1, 2)

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
    ctx = ctx.transpose(1, 2).reshape(B, S, heads * dh)
    # partial sums over tp, reduced and scattered back to sequence shards
    x = x + mc.psum_scatter(ctx @ wo.to(cdt), tp, 1)

    h = _layer_norm(x, ln2_s, ln2_b).to(cdt)
    h_full = mc.all_gather(h, tp, 1)
    a = F.gelu(h_full @ w1.to(cdt) + b1.to(cdt), approximate="tanh")
    mlp_out = mc.psum_scatter(a @ w2.to(cdt), tp, 1) + b2.to(cdt)
    return x + mlp_out


def _layer_fn_ulysses(cfg, attn_impl, tp, x, ln1_s, ln1_b, wqkv, wo, ln2_s,
                      ln2_b, w1, b1, w2, b2):
    """The Ulysses block on the sequence shard x [B, S/tp, D] (the
    reference's `_layer_fn_ulysses`): q/k/v and the MLP run on the shard
    with full-width (tp-replicated) weights; attention re-shards by two
    all-to-alls over `tp`."""
    cdt = _compute_dtype(cfg)
    B, S_loc, D = x.shape
    dh = cfg.d_head

    h = _layer_norm(x, ln1_s, ln1_b).to(cdt)
    qkv = torch.einsum("bsd,dke->bske", h, wqkv.to(cdt))   # [B, S/tp, 3, D]

    def to_heads(t):
        return t.reshape(B, S_loc, cfg.n_heads, dh)

    ctx = ulysses_attention(
        *(to_heads(qkv[:, :, i]) for i in range(3)), tp, causal=True,
        sm_scale=1.0 / math.sqrt(dh), use_flash=bool(cfg.use_flash),
        impl=attn_impl).to(cdt)
    x = x + ctx.reshape(B, S_loc, D) @ wo.to(cdt)

    h = _layer_norm(x, ln2_s, ln2_b).to(cdt)
    a = F.gelu(h @ w1.to(cdt) + b1.to(cdt), approximate="tanh")
    return x + a @ w2.to(cdt) + b2.to(cdt)


_LAYER_KEYS = ("ln1_s", "ln1_b", "wqkv", "wo", "ln2_s", "ln2_b", "w1", "b1",
               "w2", "b2")


def _stage_fn(cfg, layer, layers, x):
    """This rank's layers_per_stage layers on x (the reference's
    `_stage_fn`), each under `checkpoint` with remat."""
    # unbind, not per-layer indexing: its backward stacks the layers'
    # gradients once, where each index would add a zero-filled copy of
    # the whole stacked leaf
    for lp in zip(*(layers[key][0].unbind(0) for key in _LAYER_KEYS)):
        if cfg.remat:
            x = checkpoint(layer, x, *lp, use_reentrant=False)
        else:
            x = layer(x, *lp)
    return x


def _embed_fn(cfg, p, tokens, tp_index):
    """This rank's sequence shard of the embedded microbatch tokens [B,
    S] (the reference's `_embed_fn`, which embeds all of S and slices)."""
    S_loc = tokens.shape[1] // cfg.tp
    rows = slice(tp_index * S_loc, (tp_index + 1) * S_loc)
    # the lookup's weight gradient sums each id's rows in a fixed order on
    # the card (`ops/nn_ops.py _lookup`), so two runs agree bit for bit
    x = _lookup(p["embed"], tokens[:, rows], None) + p["pos"][None, rows]
    return x.to(_compute_dtype(cfg))


def _loss_fn(cfg, p, y, labels, tp_index):
    """The summed token NLL of this rank's sequence shard y [B, S/tp, D]
    over the microbatch's B·S tokens (the reference's `_loss_fn`; the sum
    over tp comes outside)."""
    h = _layer_norm(y, p["ln_f"]["scale"], p["ln_f"]["bias"])
    logits = h @ p["embed"].T
    S_loc = y.shape[1]
    lbl = labels[:, tp_index * S_loc:(tp_index + 1) * S_loc]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, lbl[..., None])[..., 0]
    return nll.sum() / (labels.shape[0] * labels.shape[1])


def _indices(a, dev):
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    return a.to(dev).long()


def _local_rows(a, dp, index, dev):
    """Rows [i B/dp, (i+1) B/dp) of a [n_micro, B, S] batch (the
    reference's P(None, "dp", None))."""
    rows = a.shape[1]
    if rows % dp:
        raise ValueError("a global batch of %d rows does not split over "
                         "dp=%d" % (rows, dp))
    k = rows // dp
    return _indices(a[:, index * k:(index + 1) * k], dev)


def _check_mesh(cfg, mesh):
    if mesh is None:
        if (cfg.dp, cfg.pp, cfg.tp) != (1, 1, 1):
            raise ValueError(
                "dp/pp/tp = %d/%d/%d needs a mesh: make_train_step(cfg, "
                "cfg.mesh()) in each of the %d ranks"
                % (cfg.dp, cfg.pp, cfg.tp, cfg.dp * cfg.pp * cfg.tp))
    elif mesh.axis_names != AXES or \
            mesh.axis_sizes != (cfg.dp, cfg.pp, cfg.tp):
        raise ValueError("the config asks for dp/pp/tp = %d/%d/%d, the mesh "
                         "is %r" % (cfg.dp, cfg.pp, cfg.tp, mesh))
    for what, n, d in (("n_heads", cfg.n_heads, cfg.tp),
                       ("seq_len", cfg.seq_len, cfg.tp),
                       ("d_ff", cfg.d_ff, cfg.tp),
                       ("n_layers", cfg.n_layers, cfg.pp)):
        if n % d:
            raise ValueError("%s = %d does not split over %d" % (what, n, d))


def make_train_step(cfg, mesh=None, device=None, with_grads=False,
                    attn_impl="auto"):
    """Returns ``step(params, opt_state, tokens, labels, step)`` ->
    ``(params, opt_state, loss)``, or ``(params, opt_state, loss, grads)``
    when `with_grads`. tokens/labels: the GLOBAL [n_micro, B, S] integer
    arrays or tensors (each dp rank takes its rows). The returned params,
    moments and gradients are new tensors: with a mesh, this rank's
    shards (`shard_params`, `params_to_numpy`); the loss is the global
    one, the same on every rank.

    `mesh`: the `parallel.env.Mesh` of (dp, pp, tp) (`cfg.mesh()`), or
    None for one process (dp = pp = tp = 1). `device` defaults to the
    mesh's, else cuda:0, and raises without a card. ``use_flash=None``
    turns flash attention on for a CUDA device, as the reference turns
    it on when no mesh device is a CPU. `attn_impl` goes to
    `flash_attention` ("auto": the kernels on the card, the plain version
    on the CPU; "reference": the plain version anywhere)."""
    _check_mesh(cfg, mesh)
    dev = mesh.device if mesh is not None and device is None \
        else resolve_device(device)
    if mesh is not None and dev != mesh.device:
        raise ValueError("device %s is not the mesh's %s"
                         % (dev, mesh.device))
    if cfg.use_flash is None:
        cfg = dataclasses.replace(cfg, use_flash=dev.type == "cuda")
    rings = {a: mesh.ring(a) if mesh is not None else None for a in AXES}
    index = {a: mesh.axis_index(a) if mesh is not None else 0 for a in AXES}
    stage, n_stages, n_micro = index["pp"], cfg.pp, cfg.n_micro
    first, last = stage == 0, stage == n_stages - 1
    pp_ring = rings["pp"]
    layer = functools.partial(
        _layer_fn_ulysses if cfg.sp_mode == "ulysses" else _layer_fn,
        cfg, attn_impl, rings["tp"])
    specs = param_specs(cfg)
    cdt = _compute_dtype(cfg)
    # the differentiated loss is the LOCAL one over n_micro · dp: no
    # collective inside it (a psum there would scale every cotangent by
    # its group's size); the gradient sums below make it the batch mean
    scale = 1.0 / (n_micro * cfg.dp)

    def fwd_valid(t):
        return 0 <= t - stage < n_micro

    def bwd_micro(u):
        # the backward runs the microbatches in reverse, the last stage
        # first
        return n_micro - 1 - (u - (n_stages - 1 - stage))

    def pipeline(p, tokens, labels):
        """The GPipe schedule: forward ticks, then backward ticks; fills
        the leaves' .grad; returns this rank's summed loss."""
        like = torch.empty((tokens.shape[1], cfg.seq_len // cfg.tp,
                            cfg.d_model), dtype=cdt, device=dev)
        ticks = n_micro + n_stages - 1
        saved, inbox = {}, None
        loss = torch.zeros((), device=dev)
        for t in range(ticks):
            y = None
            if fwd_valid(t):
                mb = t - stage
                x = _embed_fn(cfg, p, tokens[mb], index["tp"]) if first \
                    else inbox.requires_grad_(True)
                y = _stage_fn(cfg, layer, p["layers"], x)
                if last:
                    y = _loss_fn(cfg, p, y, labels[mb], index["tp"]) * scale
                    loss = loss + y.detach()
                saved[mb] = (x, y)
            if pp_ring is not None:
                got = mc.exchange(
                    pp_ring, [(stage + 1, y)] if y is not None and not last
                    else [], [stage - 1] if not first and fwd_valid(t + 1)
                    else [], like)
                inbox = got[0] if got else None
        grad_in = None
        for u in range(ticks):
            mb, gx = bwd_micro(u), None
            if 0 <= mb < n_micro:
                x, out = saved.pop(mb)
                torch.autograd.backward(out, None if last else grad_in)
                gx = None if first else x.grad
            if pp_ring is not None:
                got = mc.exchange(
                    pp_ring, [(stage - 1, gx)] if gx is not None else [],
                    [stage + 1] if not last and 0 <= bwd_micro(u + 1)
                    < n_micro else [], like)
                grad_in = got[0] if got else None
        return loss

    def reduce_grads(grads):
        """Each leaf summed over the axes its parameter is replicated on,
        one flat buffer for each set of axes."""
        leaves, buckets = [], {}

        def collect(g, spec):
            axes = tuple(a for a in _replicated_axes(spec)
                         if rings[a] is not None)
            if axes:
                buckets.setdefault(axes, []).append(len(leaves))
            leaves.append(g)

        _tree_map(collect, grads, specs)
        for axes, ids in buckets.items():
            flat = mc.psum(torch.cat([leaves[i].reshape(-1) for i in ids]),
                           [rings[a] for a in axes])
            for i, part in zip(ids, flat.split(
                    [leaves[i].numel() for i in ids])):
                leaves[i] = part.view_as(leaves[i])
        it = iter(leaves)
        return _tree_map(lambda _: next(it), grads)

    def train_step(params, opt_state, tokens, labels, step):
        tokens = _local_rows(tokens, cfg.dp, index["dp"], dev)
        labels = _local_rows(labels, cfg.dp, index["dp"], dev)
        p = _tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = pipeline(p, tokens, labels)
        grads = reduce_grads(_tree_map(
            lambda t: t.grad if t.grad is not None
            else torch.zeros_like(t), p))
        # the reported loss: the partial token means summed over tp, the
        # last stage's over pp, and the 1/dp means over dp
        loss = mc.psum(loss, [rings["tp"], rings["pp"], rings["dp"]])

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
            return new_p, (new_m, new_v), loss, grads
        return new_p, (new_m, new_v), loss

    return train_step
