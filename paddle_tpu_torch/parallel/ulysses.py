"""Ulysses (DeepSpeed-Ulysses) sequence parallelism: all-to-all
head <-> sequence re-sharding around exact attention (counterpart:
`paddle_tpu/parallel/ulysses.py`).

Two all-to-all hops over a mesh axis turn the sequence-sharded layout
[B, S/P, H, D] into the head-sharded [B, S, H/P, D], run exact
full-sequence attention on each rank's head group (the port's flash
kernels on the card, their plain version on the CPU, or the plain
golden attention), and turn the result back. The hops are
`mesh_collectives.all_to_all`, whose backward is the reverse hop, so
`torch.autograd` differentiates through them.
"""
from __future__ import annotations

import math

from . import mesh_collectives as mc
from ..ops.kernels.flash_attention import flash_attention, \
    reference_attention

__all__ = ["ulysses_attention", "ulysses_attention_sharded"]


def _attention(q, k, v, causal, sm_scale, use_flash=False, impl="auto"):
    """Exact attention; q, k, v [B, S, H, D] -> [B, S, H, D] through the
    [B, H, S, D] functions of `ops/kernels/flash_attention.py`:
    `flash_attention` (`impl` "auto": the kernels for CUDA tensors, the
    plain version for CPU ones) or `reference_attention`."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if use_flash:
        out = flash_attention(qt, kt, vt, causal=causal, sm_scale=sm_scale,
                              impl=impl)
    else:
        out = reference_attention(qt, kt, vt, causal=causal,
                                  sm_scale=sm_scale)
    return out.transpose(1, 2)


def ulysses_attention(q, k, v, ring, causal=False, sm_scale=None,
                      use_flash=False, impl="auto"):
    """q, k, v: [B, S_local, H, D], this rank's SEQUENCE shard with the
    FULL head count H, which must divide by the ring's size. Returns
    [B, S_local, H, D]: the rows of global attention this rank owns.
    `ring` is this rank's group on the sequence axis (`Mesh.ring`)."""
    p = 1 if ring is None else ring.size
    h, d = q.shape[2], q.shape[3]
    if h % p:
        raise ValueError("Ulysses splits %d heads over %d ranks: the head "
                         "count must divide by the axis size" % (h, p))
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)

    def seq_to_heads(t):
        # [B, S/P, H, D] -> [B, S, H/P, D]
        return mc.all_to_all(t, ring, split_dim=2, concat_dim=1)

    out = _attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                     causal, sm_scale, use_flash=use_flash, impl=impl)
    return mc.all_to_all(out, ring, split_dim=1, concat_dim=2)


def ulysses_attention_sharded(q, k, v, mesh, seq_axis="sp", causal=False,
                              sm_scale=None, use_flash=False, impl="auto"):
    """q, k, v: the global [B, S, H, D] tensors (the same on every rank);
    each rank takes its sequence shard on `seq_axis` of `mesh`, runs
    `ulysses_attention` and returns its shard of the output, [B, S/P, H,
    D] (the reference's output sharded over `seq_axis`: one process holds
    one shard). Gradients flow to this rank's rows of q, k and v."""
    p, i = mesh.axis_size(seq_axis), mesh.axis_index(seq_axis)
    s = q.shape[1]
    if s % p:
        raise ValueError("a sequence of %d does not split over %d ranks"
                         % (s, p))
    rows = slice(i * (s // p), (i + 1) * (s // p))
    return ulysses_attention(q[:, rows], k[:, rows], v[:, rows],
                             mesh.ring(seq_axis), causal=causal,
                             sm_scale=sm_scale, use_flash=use_flash,
                             impl=impl)
