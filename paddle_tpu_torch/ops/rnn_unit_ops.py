"""Recurrent unit operators, the `dynamic_lstm` / `dynamic_gru` families
(counterpart: `paddle_tpu/ops/rnn_unit_ops.py`): `lstm`, `lstmp`,
`lstm_unit`, `gru`, `gru_unit` and `cudnn_lstm`, with the reference's
slots, attrs and gate layouts:

- `lstm` / `lstmp`: Input [B, T, 4D] is the projected input; its gates
  lie along 4D as (candidate, input, forget, output); a Bias of 7D
  columns carries the peephole weights (input and forget applied with
  the previous cell, output with the new one); `lstmp` adds the
  recurrent projection ProjWeight [D, P].
- `lstm_unit`: one step, X packing (i, f, o, g), `forget_bias` on f.
- `gru` / `gru_unit`: gates (update, reset, candidate) along 3D; h =
  (1 - u) * h_prev + u * c, or u * h_prev + (1 - u) * c with
  `origin_mode`; `gru_unit` reads its activations as the reference's
  integer codes (0 identity, 1 sigmoid, 2 tanh, 3 relu) or names.
- `cudnn_lstm`: time-major [T, B, D], layers and directions over a flat
  weight (per layer and direction W_ih, W_hh, b_ih, b_hh; gates (i, f,
  g, o), cuDNN's order), run here as the reference runs it, not by
  cuDNN's fused RNN.

The two reversal rules are the reference's: `lstm` and `gru` with
`is_reverse` run over the whole padded array from its end, so a row's
padded steps come first and carry its initial state through;
`cudnn_lstm`'s reverse direction runs over each row's valid region
(SequenceLength) reversed. Where a Length is given, a padded step keeps
the state as it was, and the outputs there hold that state, as the
reference's do.

Each op is the whole sequence: the input projection is one product
before the loop, and each step is a few small ops (the recurrent
product, the gates, the cell) issued from a Python loop over T, which
autograd differentiates and a captured block records whole. The steps'
inputs are taken with one `unbind` and the gates with `split`, so the
backward stacks their gradients once, where indexing would zero-fill
and add a full-size gradient a step. Nothing in the loop reads a value
on the host; Length enters as a device mask.
"""
from __future__ import annotations

import torch

from .registry import register_op

_ACT = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}
#: gru_unit's integer codes for its activations
_ACT_ENUM = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


def _act(attrs, key, default):
    v = attrs.get(key, default)
    return _ACT[_ACT_ENUM[v] if isinstance(v, int) else v]


def _step_masks(ins, slot, b, t, reverse, device):
    """[T, B, 1] bool masks of the valid steps in scan order (from a
    Length of [B] or [B, 1]), or None without one."""
    if not ins.get(slot):
        return None
    length = ins[slot][0].reshape(-1, 1)
    m = torch.arange(t, device=device).reshape(t, 1, 1) < length.reshape(
        1, b, 1)
    return torch.flip(m, (0,)) if reverse else m


def _time_major(x, reverse):
    """[B, T, ...] -> contiguous [T, B, ...] in scan order."""
    xs = x.transpose(0, 1)
    return (torch.flip(xs, (0,)) if reverse else xs).contiguous()


def _batch_major(steps, reverse):
    """T [B, ...] tensors in scan order -> [B, T, ...] in time order."""
    ys = torch.stack(steps, dim=1)
    return torch.flip(ys, (1,)) if reverse else ys


def _lstm_body(ins, attrs, proj=False):
    """The `lstm` / `lstmp` recurrence over padded [B, T, 4D]."""
    x, w = ins["Input"][0], ins["Weight"][0]
    bias = ins["Bias"][0].reshape(-1)
    b, t, d = x.shape[0], x.shape[1], x.shape[2] // 4
    peep = bool(attrs.get("use_peepholes", True)) and bias.shape[0] >= 7 * d
    act_gate = _ACT[attrs.get("gate_activation", "sigmoid")]
    act_cell = _ACT[attrs.get("cell_activation", "tanh")]
    act_cand = _ACT[attrs.get("candidate_activation", "tanh")]
    cell_clip = float(attrs.get("cell_clip", 0.0))
    reverse = bool(attrs.get("is_reverse", False))
    if peep:
        ck_if = bias[4 * d:6 * d].reshape(2, d)
        ck_o = bias[6 * d:7 * d]
    if proj:
        w_proj = ins["ProjWeight"][0]
        act_proj = _ACT[attrs.get("proj_activation", "identity")]
        proj_clip = float(attrs.get("proj_clip", 0.0))
    r_width = w_proj.shape[1] if proj else d
    r = ins["H0"][0] if ins.get("H0") else x.new_zeros((b, r_width))
    c = ins["C0"][0] if ins.get("C0") else x.new_zeros((b, d))
    xs = _time_major(x + bias[:4 * d], reverse)
    masks = _step_masks(ins, "Length", b, t, reverse, x.device)
    rs, cs, hs = [], [], []
    for step, xg in enumerate(torch.unbind(xs)):
        cand, in_forget, og = torch.split(torch.addmm(xg, r, w),
                                          [d, 2 * d, d], dim=1)
        cand = act_cand(cand)
        in_forget = in_forget.reshape(b, 2, d)
        if peep:
            in_forget = torch.addcmul(in_forget, c.unsqueeze(1), ck_if)
        i, f = torch.unbind(act_gate(in_forget), dim=1)
        c_new = torch.addcmul(cand * i, c, f)
        if cell_clip > 0.0:
            c_new = torch.clamp(c_new, -cell_clip, cell_clip)
        if peep:
            og = torch.addcmul(og, c_new, ck_o)
        h = act_gate(og) * act_cell(c_new)
        r_new = h
        if proj:
            r_new = act_proj(h @ w_proj)
            if proj_clip > 0.0:
                r_new = torch.clamp(r_new, -proj_clip, proj_clip)
        if masks is not None:
            r_new = torch.where(masks[step], r_new, r)
            c_new = torch.where(masks[step], c_new, c)
        r, c = r_new, c_new
        rs.append(r)
        cs.append(c)
        hs.append(h)
    cell = _batch_major(cs, reverse)
    if proj:
        return {"Projection": _batch_major(rs, reverse), "Cell": cell,
                "Hidden": _batch_major(hs, reverse)}
    return {"Hidden": _batch_major(rs, reverse), "Cell": cell}


@register_op("lstm")
def _lstm(ins, attrs):
    return _lstm_body(ins, attrs, proj=False)


@register_op("lstmp")
def _lstmp(ins, attrs):
    return _lstm_body(ins, attrs, proj=True)


@register_op("lstm_unit")
def _lstm_unit(ins, attrs):
    x, c_prev = ins["X"][0], ins["C_prev"][0]
    d = c_prev.shape[-1]
    i = torch.sigmoid(x[:, :d])
    f = torch.sigmoid(x[:, d:2 * d] + float(attrs.get("forget_bias", 0.0)))
    o = torch.sigmoid(x[:, 2 * d:3 * d])
    c = f * c_prev + i * torch.tanh(x[:, 3 * d:])
    return {"C": c, "H": o * torch.tanh(c)}


def _gru_step(xg, h_prev, w_ur, w_c, act_gate, act_node, origin):
    """One GRU step: (h, the update and reset gates [B, 2D], the
    candidate, r * h_prev)."""
    d = h_prev.shape[-1]
    x_ur, x_c = torch.split(xg, [2 * d, d], dim=1)
    ur = act_gate(torch.addmm(x_ur, h_prev, w_ur))
    u, r = torch.split(ur, [d, d], dim=1)
    rh = r * h_prev
    cand = act_node(torch.addmm(x_c, rh, w_c))
    h = torch.lerp(cand, h_prev, u) if origin else torch.lerp(h_prev, cand,
                                                               u)
    return h, ur, cand, rh


@register_op("gru")
def _gru(ins, attrs):
    x, w = ins["Input"][0], ins["Weight"][0]
    b, t, d = x.shape[0], x.shape[1], x.shape[2] // 3
    if ins.get("Bias"):
        x = x + ins["Bias"][0].reshape(-1)
    act_gate = _ACT[attrs.get("gate_activation", "sigmoid")]
    act_node = _ACT[attrs.get("activation", "tanh")]
    origin = bool(attrs.get("origin_mode", False))
    reverse = bool(attrs.get("is_reverse", False))
    w_ur, w_c = w[:, :2 * d].contiguous(), w[:, 2 * d:].contiguous()
    h = ins["H0"][0] if ins.get("H0") else x.new_zeros((b, d))
    xs = _time_major(x, reverse)
    masks = _step_masks(ins, "Length", b, t, reverse, x.device)
    hs, urs, cands, rhs = [], [], [], []
    for step, xg in enumerate(torch.unbind(xs)):
        h_new, ur, cand, rh = _gru_step(xg, h, w_ur, w_c, act_gate,
                                        act_node, origin)
        if masks is not None:
            m = masks[step]
            h_new = torch.where(m, h_new, h)
            m = m.to(x.dtype)
            ur, cand, rh = ur * m, cand * m, rh * m
        h = h_new
        hs.append(h)
        urs.append(ur)
        cands.append(cand)
        rhs.append(rh)
    hidden = _batch_major(hs, reverse)
    return {"Hidden": hidden,
            "BatchGate": torch.cat([_batch_major(urs, reverse),
                                    _batch_major(cands, reverse)], -1),
            "BatchResetHiddenPrev": _batch_major(rhs, reverse),
            "BatchHidden": hidden}


@register_op("gru_unit")
def _gru_unit(ins, attrs):
    """One GRU step: Input [B, 3D] (the projected input), HiddenPrev [B,
    D], Weight [D, 3D], optional Bias [1, 3D]."""
    xg, h_prev, w = ins["Input"][0], ins["HiddenPrev"][0], ins["Weight"][0]
    d = h_prev.shape[-1]
    if ins.get("Bias"):
        xg = xg + ins["Bias"][0].reshape(-1)
    h, ur, cand, rh = _gru_step(
        xg, h_prev, w[:, :2 * d], w[:, 2 * d:], _act(attrs,
                                                     "gate_activation", 1),
        _act(attrs, "activation", 2), bool(attrs.get("origin_mode", False)))
    return {"Hidden": h, "Gate": torch.cat([ur, cand], -1),
            "ResetHiddenPrev": rh}


def _cudnn_dir(seq, w_ih, w_hh, bias, h, c, masks):
    """One direction of one `cudnn_lstm` layer (and `lstm_seq`, in
    `nn_ops.py`) over [T, B, in] in scan order, gates (i, f, g, o):
    (T outputs [B, H], last h, last c)."""
    xp = torch.matmul(seq, w_ih.t()) + bias
    w_hh_t = w_hh.t()
    ys = []
    for step, xg in enumerate(torch.unbind(xp)):
        i, f, g, o = torch.chunk(torch.addmm(xg, h, w_hh_t), 4, -1)
        c_new = torch.addcmul(torch.sigmoid(i) * torch.tanh(g),
                              torch.sigmoid(f), c)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        if masks is not None:
            h_new = torch.where(masks[step], h_new, h)
            c_new = torch.where(masks[step], c_new, c)
        h, c = h_new, c_new
        ys.append(h)
    return ys, h, c


@register_op("cudnn_lstm")
def _cudnn_lstm(ins, attrs):
    """Layers of (bidirectional) LSTM over time-major Input [T, B, D]; W
    is the flat weight, InitH / InitC [layers * dirs, B, H]; with
    SequenceLength [B] the padded steps carry the state and the reverse
    direction runs over each row's valid steps reversed. Out [T, B, H *
    dirs], last_h and last_c [layers * dirs, B, H]."""
    x = ins["Input"][0]
    flat_w = ins["W"][0].reshape(-1)
    hidden = int(attrs["hidden_size"])
    n_layers = int(attrs.get("num_layers", 1))
    n_dir = 2 if attrs.get("is_bidirec", False) else 1
    t, b, _ = x.shape
    masks = rev_idx = None
    if ins.get("SequenceLength"):
        seq_len = ins["SequenceLength"][0].reshape(1, -1).to(torch.int64)
        steps = torch.arange(t, device=x.device).reshape(t, 1)
        valid = steps < seq_len
        masks = valid.unsqueeze(-1)
        rev_idx = torch.where(valid, seq_len - 1 - steps, steps)

    def rev(seq):
        if rev_idx is None:
            return torch.flip(seq, (0,))
        return torch.gather(seq, 0, rev_idx.unsqueeze(-1).expand(
            t, b, seq.shape[-1]))

    shape = (n_layers * n_dir, b, hidden)
    init_h = ins["InitH"][0].reshape(shape) if ins.get("InitH") \
        else x.new_zeros(shape)
    init_c = ins["InitC"][0].reshape(shape) if ins.get("InitC") \
        else x.new_zeros(shape)
    off = 0

    def take(n, shp):
        nonlocal off
        v = flat_w[off:off + n].reshape(shp)
        off += n
        return v

    out, last_h, last_c = x, [], []
    for layer in range(n_layers):
        d_cur = out.shape[-1]
        outs = []
        for di in range(n_dir):
            w_ih = take(4 * hidden * d_cur, (4 * hidden, d_cur))
            w_hh = take(4 * hidden * hidden, (4 * hidden, hidden))
            bias = take(4 * hidden, (4 * hidden,)) + take(4 * hidden,
                                                          (4 * hidden,))
            k = layer * n_dir + di
            seq = rev(out) if di == 1 else out
            ys, hl, cl = _cudnn_dir(seq, w_ih, w_hh, bias, init_h[k],
                                    init_c[k], masks)
            ys = torch.stack(ys)
            outs.append(rev(ys) if di == 1 else ys)
            last_h.append(hl)
            last_c.append(cl)
        out = torch.cat(outs, -1) if n_dir == 2 else outs[0]
    return {"Out": out, "last_h": torch.stack(last_h),
            "last_c": torch.stack(last_c)}
