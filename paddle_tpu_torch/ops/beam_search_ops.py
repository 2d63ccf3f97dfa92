"""Beam-search operators (counterpart: `paddle_tpu/ops/beam_search_ops.py`):
`beam_search`, one step over [batch, beam, K] candidate scores, and
`gather_tree` / `beam_search_decode`, which backtrack the per-step ids
through their parents into whole sequences. Static [batch, beam, ...]
shapes, as in the reference; the backtrack is a loop over the steps.
"""
from __future__ import annotations

import torch

from .registry import register_op


def _top_k(x, k):
    """The k largest along the last axis, the lower index first among
    equal values (as `jax.lax.top_k`)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register_op("beam_search")
def _beam_search(ins, attrs):
    """One step. scores [batch, beam, K] (and optional ids of the same
    shape), pre_ids and pre_scores [batch, beam]. A beam whose pre_id is
    `end_id` has finished: it keeps its score and offers one candidate
    (its end token). Outputs selected_ids, selected_scores and
    parent_idx [batch, beam]."""
    pre_ids = ins["pre_ids"][0]
    pre_scores = ins["pre_scores"][0]
    ids = ins["ids"][0] if ins.get("ids") else None
    scores = ins["scores"][0]
    beam_size = attrs.get("beam_size", scores.shape[1])
    end_id = attrs.get("end_id", 0)

    batch, beam, k = scores.shape
    finished = pre_ids == end_id
    total = pre_scores[..., None] + torch.where(
        finished[..., None], torch.zeros((), dtype=scores.dtype,
                                         device=scores.device), scores)
    first = torch.arange(k, device=scores.device)[None, None, :] == 0
    cand_mask = torch.where(finished[..., None], first, True)
    total = total.masked_fill(~cand_mask, torch.finfo(total.dtype).min)
    top_scores, top_idx = _top_k(total.reshape(batch, beam * k), beam_size)
    parent = torch.div(top_idx, k, rounding_mode="floor")
    if ids is None:
        sel_ids = top_idx % k
    else:
        sel_ids = torch.take_along_dim(ids.reshape(batch, beam * k),
                                       top_idx, dim=1)
    parent_fin = torch.take_along_dim(finished, parent, dim=1)
    sel_ids = torch.where(parent_fin, end_id, sel_ids)
    # int64 on the host side of the program, int32 on the device
    return {"selected_ids": sel_ids.to(torch.int32),
            "selected_scores": top_scores,
            "parent_idx": parent.to(torch.int32)}


@register_op("gather_tree")
def _gather_tree(ins, attrs):
    """ids / parents [T, batch, beam] -> the backtracked sequences: from
    the last step back, each beam follows its parents."""
    ids, parents = ins["Ids"][0], ins["Parents"][0]
    beam_idx = torch.arange(ids.shape[2], dtype=torch.int32,
                            device=ids.device).expand(ids.shape[1:])
    outs = []
    for t in range(ids.shape[0] - 1, -1, -1):
        outs.append(torch.take_along_dim(ids[t], beam_idx.long(), dim=1))
        beam_idx = torch.take_along_dim(parents[t], beam_idx.long(),
                                        dim=1).to(torch.int32)
    if not outs:
        return {"Out": ids}
    return {"Out": torch.stack(outs[::-1])}


@register_op("beam_search_decode")
def _beam_search_decode(ins, attrs):
    """Ids / ParentIdx [T, batch, beam] -> SentenceIds (backtracked) and
    SentenceScores (Scores as given)."""
    res = {"SentenceIds": _gather_tree(
        {"Ids": ins["Ids"], "Parents": ins["ParentIdx"]}, {})["Out"]}
    if ins.get("Scores"):
        res["SentenceScores"] = ins["Scores"][0]
    return res
