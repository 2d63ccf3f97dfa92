"""Metric operators (counterpart: `paddle_tpu/ops/metric_ops.py`):
`accuracy`, `auc`, `mean_iou`, `precision_recall`, `edit_distance`,
`chunk_eval` and `positive_negative_pair`.

`auc`, `mean_iou` and `precision_recall` run on the device, so a step
that streams them is captured: their histograms add counts of 0 and 1,
exact in any order. `edit_distance`, `chunk_eval` and
`positive_negative_pair` are host numpy (`no_jit`), as the reference's,
so a block holding one runs eagerly (`fluid/lowering.py
capture_blocker`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register_op
from ..core.types import from_numpy, to_numpy


@register_op("accuracy")
def _accuracy(ins, attrs):
    # reference: metrics/accuracy_op.cc — inputs Out (topk values),
    # Indices (topk indices [N,k]), Label [N,1]
    indices = ins["Indices"][0]
    label = ins["Label"][0].reshape((-1, 1)).to(indices.dtype)
    correct_row = torch.any(indices == label, dim=1)
    num_correct = torch.sum(correct_row.to(torch.int32)).to(torch.int32)
    total = indices.shape[0]
    acc = (num_correct.to(torch.float32) / total).reshape((1,))
    return {"Accuracy": acc,
            "Correct": num_correct.reshape((1,)),
            "Total": torch.full((1,), total, dtype=torch.int32,
                                device=indices.device)}


def _counts(n, idx, weights):
    """[n] float32 histogram of `idx` weighted by `weights`."""
    return torch.zeros(n, dtype=weights.dtype, device=weights.device) \
        .index_add(0, idx.to(torch.int64), weights)


@register_op("auc")
def _auc(ins, attrs):
    """The streaming AUC over `num_thresholds` + 1 buckets (reference:
    metrics/auc_op.cc): this batch's positive and negative counts by
    bucket of the positive class's probability added to StatPos and
    StatNeg, then the trapezoids of the ROC curve over every count so
    far, from the highest bucket down."""
    predict = ins["Predict"][0]
    label = ins["Label"][0].reshape(-1)
    stat_pos, stat_neg = ins["StatPos"][0], ins["StatNeg"][0]
    num_thresholds = attrs.get("num_thresholds", 4095)
    pos_prob = predict[:, -1] if predict.ndim == 2 else predict
    bucket = torch.clamp((pos_prob * num_thresholds).to(torch.int32), 0,
                         num_thresholds)
    is_pos = label > 0
    new_pos = stat_pos.index_add(0, bucket.to(torch.int64),
                                 is_pos.to(stat_pos.dtype))
    new_neg = stat_neg.index_add(0, bucket.to(torch.int64),
                                 (~is_pos).to(stat_neg.dtype))
    tot_pos = torch.cumsum(torch.flip(new_pos, (0,)), 0).to(new_pos.dtype)
    tot_neg = torch.cumsum(torch.flip(new_neg, (0,)), 0).to(new_neg.dtype)
    prev_pos = torch.cat([tot_pos.new_zeros(1), tot_pos[:-1]])
    prev_neg = torch.cat([tot_neg.new_zeros(1), tot_neg[:-1]])
    area = torch.sum((tot_neg - prev_neg) * (prev_pos + tot_pos) / 2.0)
    denom = tot_pos[-1] * tot_neg[-1]
    auc = torch.where(denom > 0, area / torch.clamp_min(denom, 1),
                      torch.zeros((), dtype=area.dtype, device=area.device))
    return {"AUC": auc.reshape(1), "StatPosOut": new_pos,
            "StatNegOut": new_neg}


@register_op("mean_iou")
def _mean_iou(ins, attrs):
    pred = ins["Predictions"][0].reshape(-1).to(torch.int32)
    label = ins["Labels"][0].reshape(-1).to(torch.int32)
    n = attrs["num_classes"]
    hit = pred == label
    ones = torch.ones(pred.shape, dtype=torch.float32, device=pred.device)
    inter = _counts(n, torch.where(hit, pred, n - 1), hit.to(torch.float32))
    pred_cnt = _counts(n, pred, ones)
    label_cnt = _counts(n, label, ones)
    union = pred_cnt + label_cnt - inter
    zero = torch.zeros((), device=pred.device)
    iou = torch.where(union > 0, inter / torch.clamp_min(union, 1e-9), zero)
    valid = (union > 0).to(torch.float32)
    mean = torch.sum(iou) / torch.clamp_min(torch.sum(valid), 1.0)
    return {"OutMeanIou": mean.reshape(1), "OutWrong": pred_cnt - inter,
            "OutCorrect": inter}


def _safe_div(a, b):
    return torch.where(b > 0, a / (b + 1e-12), torch.zeros_like(a))


def _pr_metrics(states):
    """[macro precision, recall, F1, micro precision, recall, F1]."""
    tp, fp, fn = states[:, 0], states[:, 1], states[:, 3]
    prec, rec = _safe_div(tp, tp + fp), _safe_div(tp, tp + fn)
    f1 = _safe_div(2 * prec * rec, prec + rec)
    tps, fps, fns = torch.sum(tp), torch.sum(fp), torch.sum(fn)
    mp, mr = _safe_div(tps, tps + fps), _safe_div(tps, tps + fns)
    mf = _safe_div(2 * mp * mr, mp + mr)
    return torch.stack([torch.mean(prec), torch.mean(rec), torch.mean(f1),
                        mp, mr, mf])


@register_op("precision_recall")
def _precision_recall(ins, attrs):
    """Per-class and micro precision, recall and F1 of this batch and,
    with StatesInfo [classes, 4] (TP, FP, TN, FN) added, of every batch
    so far (reference: metrics/precision_recall_op.cc)."""
    cls_num = attrs["class_number"]
    preds = ins["MaxProbs"][1] if len(ins.get("MaxProbs", [])) > 1 \
        else ins["Indices"][0]
    p = preds.reshape(-1).to(torch.int64)
    lab = ins["Labels"][0].reshape(-1).to(torch.int64)
    onehot_p = F.one_hot(p, cls_num).to(torch.float32)
    onehot_l = F.one_hot(lab, cls_num).to(torch.float32)
    tp = torch.sum(onehot_p * (p == lab)[:, None].to(torch.float32), 0)
    fp = torch.sum(onehot_p, 0) - tp
    fn = torch.sum(onehot_l, 0) - tp
    tn = p.shape[0] - tp - fp - fn
    batch = torch.stack([tp, fp, tn, fn], dim=1)
    acc = ins["StatesInfo"][0] + batch if ins.get("StatesInfo") else batch
    return {"BatchMetrics": _pr_metrics(batch),
            "AccumMetrics": _pr_metrics(acc), "AccumStatesInfo": acc}


def _lengths(ins, slot, x):
    return to_numpy(ins[slot][0]).reshape(-1) if ins.get(slot) \
        else np.full((x.shape[0],), x.shape[1])


@register_op("edit_distance", no_jit=True)
def _edit_distance(ins, attrs):
    """The Levenshtein distance of each hypothesis row to its reference
    row (reference: operators/edit_distance_op.cc), on the host."""
    hyp, ref = to_numpy(ins["Hyps"][0]), to_numpy(ins["Refs"][0])
    hyp_len = _lengths(ins, "HypsLength", hyp)
    ref_len = _lengths(ins, "RefsLength", ref)
    normalized = attrs.get("normalized", False)
    out = np.zeros((hyp.shape[0], 1), np.float32)
    for b in range(hyp.shape[0]):
        h, r = hyp[b, :int(hyp_len[b])], ref[b, :int(ref_len[b])]
        m, n = len(h), len(r)
        dp = np.arange(n + 1, dtype=np.int64)
        for i in range(1, m + 1):
            prev = dp.copy()
            dp[0] = i
            for j in range(1, n + 1):
                dp[j] = min(prev[j] + 1, dp[j - 1] + 1,
                            prev[j - 1] + (h[i - 1] != r[j - 1]))
        d = float(dp[n])
        out[b, 0] = d / max(n, 1) if normalized else d
    dev = attrs["_device"]
    return {"Out": from_numpy(out, dev), "SequenceNum": from_numpy(
        np.asarray([hyp.shape[0]], np.int64), dev)}


# (num_tag_types, tag_begin, tag_inside, tag_end, tag_single) per scheme
# (reference: chunk_eval_op.cc:119 InEnum and chunk_eval_op.h's table);
# plain has no begin tag: contiguous tokens of one type are one chunk
_CHUNK_SCHEMES = {
    "plain": (1, -1, -1, -1, -1),
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
}


def _chunks(tags, scheme, other):
    """The (start, end, type) chunks of one tag sequence (reference:
    chunk_eval_op.h:41 GetSegments, with its ChunkBegin and ChunkEnd)."""
    n_tag, t_begin, t_inside, t_end, t_single = _CHUNK_SCHEMES[scheme]

    def ends(pt, pty, t, ty):
        if pty == other:
            return False
        if ty == other or ty != pty:
            return True
        if pt == t_begin or pt == t_inside:
            return t == t_begin or t == t_single
        return pt == t_end or pt == t_single

    def begins(pt, pty, t, ty):
        if pty == other:
            return ty != other
        if ty == other:
            return False
        if ty != pty or t == t_begin or t == t_single:
            return True
        if t == t_inside or t == t_end:
            return pt == t_end or pt == t_single
        return False

    out = set()
    start, in_chunk = 0, False
    tag, ty = -1, other
    for i, lbl in enumerate(tags):
        pt, pty = tag, ty
        tag, ty = int(lbl) % n_tag, int(lbl) // n_tag
        if in_chunk and ends(pt, pty, tag, ty):
            out.add((start, i, pty))
            in_chunk = False
        if begins(pt, pty, tag, ty):
            start, in_chunk = i, True
    if in_chunk:
        out.add((start, len(tags), ty))
    return out


@register_op("chunk_eval", no_jit=True)
def _chunk_eval(ins, attrs):
    """Chunk-level precision, recall and F1 of a sequence labelling
    (reference: operators/chunk_eval_op.h), schemes plain, IOB, IOE and
    IOBES, on the host; [B, T] rows bounded by SeqLength."""
    inference = to_numpy(ins["Inference"][0])
    label = to_numpy(ins["Label"][0])
    scheme = attrs.get("chunk_scheme", "IOB")
    excluded = set(attrs.get("excluded_chunk_types", []) or [])
    if scheme not in _CHUNK_SCHEMES:
        raise ValueError(
            "chunk_scheme %r invalid: must be one of %s (reference "
            "chunk_eval_op.cc:119)" % (scheme, sorted(_CHUNK_SCHEMES)))
    if inference.ndim == 1:
        inference, label = inference[None, :], label[None, :]
    seq_len = _lengths(ins, "SeqLength", inference)
    other = attrs["num_chunk_types"]  # the type id of the Outside label
    pred, gold = set(), set()
    for b in range(inference.shape[0]):
        n = int(seq_len[b])
        pred |= {(b,) + c for c in _chunks(inference[b, :n], scheme, other)
                 if c[2] not in excluded}
        gold |= {(b,) + c for c in _chunks(label[b, :n], scheme, other)
                 if c[2] not in excluded}
    correct = len(pred & gold)
    prec = correct / len(pred) if pred else 0.0
    rec = correct / len(gold) if gold else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    dev = attrs["_device"]

    def one(v, dtype):
        return from_numpy(np.asarray([v], dtype), dev)

    return {"Precision": one(prec, np.float32),
            "Recall": one(rec, np.float32),
            "F1-Score": one(f1, np.float32),
            "NumInferChunks": one(len(pred), np.int64),
            "NumLabelChunks": one(len(gold), np.int64),
            "NumCorrectChunks": one(correct, np.int64)}


@register_op("positive_negative_pair", no_jit=True)
def _positive_negative_pair(ins, attrs):
    """Ranking pair counts by query (reference:
    positive_negative_pair_op.h:25): each same-query pair of documents
    with different labels weighs the mean of their weights; concordant
    score and label order counts positive, discordant negative, and
    equal scores both neutral and negative (the reference's ternary runs
    after its neutral add)."""
    score = to_numpy(ins["Score"][0]).astype(np.float64)
    label = to_numpy(ins["Label"][0]).astype(np.float64).reshape(-1)
    query = to_numpy(ins["QueryID"][0]).reshape(-1).astype(np.int64)
    weight = to_numpy(ins["Weight"][0]).astype(np.float64).reshape(-1) \
        if ins.get("Weight") else np.ones_like(label)
    column = int(attrs.get("column", 0))
    if score.ndim == 1:
        score = score[:, None]
    if column < 0:
        column += score.shape[1]
    s = score[:, column]
    pos = neg = neu = 0.0
    # the reference takes the accumulators only all three together
    acc = ("AccumulatePositivePair", "AccumulateNegativePair",
           "AccumulateNeutralPair")
    if all(ins.get(a) for a in acc):
        pos, neg, neu = (float(to_numpy(ins[a][0]).reshape(-1)[0])
                         for a in acc)
    by_query = {}
    for i in range(len(label)):
        by_query.setdefault(int(query[i]), []).append(i)
    for idxs in by_query.values():
        for a in range(len(idxs)):
            for b in range(a + 1, len(idxs)):
                i, j = idxs[a], idxs[b]
                if label[i] == label[j]:
                    continue
                w = (weight[i] + weight[j]) * 0.5
                if s[i] == s[j]:
                    neu += w
                if (s[i] - s[j]) * (label[i] - label[j]) > 0.0:
                    pos += w
                else:
                    neg += w
    odt = to_numpy(ins["Score"][0]).dtype  # outputs in Score's type
    dev = attrs["_device"]
    return {"PositivePair": from_numpy(np.asarray([pos], odt), dev),
            "NegativePair": from_numpy(np.asarray([neg], odt), dev),
            "NeutralPair": from_numpy(np.asarray([neu], odt), dev)}
