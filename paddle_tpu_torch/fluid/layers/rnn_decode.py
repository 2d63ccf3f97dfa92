"""Decoding API (counterpart: `paddle_tpu/fluid/layers/rnn_decode.py`):
`RNNCell`, `GRUCell`, `BeamSearchDecoder` and `dynamic_decode`, in the
static graph.

`dynamic_decode` unrolls the decoder's step `max_step_num` times into
the program (static shapes, as the reference); each step expands the
beams with the `beam_search` op (`ops/beam_search_ops.py`), and the
result is backtracked with `gather_tree`.
"""
from __future__ import annotations

import numpy as np

from ..layer_helper import LayerHelper, apply_op
from . import nn as nn_layers
from . import tensor as tensor_layers

__all__ = ["RNNCell", "GRUCell", "BeamSearchDecoder", "dynamic_decode"]


class RNNCell:
    """Reference: layers/rnn.py RNNCell — call(inputs, states) ->
    (outputs, new_states)."""

    def call(self, inputs, states):
        raise NotImplementedError

    def __call__(self, inputs, states):
        return self.call(inputs, states)


class GRUCell(RNNCell):
    """A GRU step: r, z = sigmoid(x W_ih + h W_hh) per gate, n =
    tanh(x W_n + r * h U_n), h' = (1 - z) * n + z * h; its weights are
    made on the first call and shared by every later step."""

    def __init__(self, hidden_size, param_attr=None, name="gru_cell"):
        self.hidden_size = hidden_size
        self._name = name
        self._param_attr = param_attr
        self._w_ih = None
        self._w_hh = None

    def call(self, inputs, states):
        h = states
        if self._w_ih is None:
            # create ONCE and share across decode steps (a fresh
            # create_parameter per call would mint new unique-named,
            # newly-initialized weights every timestep)
            helper = LayerHelper(self._name,
                                 param_attr=self._param_attr)
            in_dim = int(inputs.shape[-1])
            self._w_ih = helper.create_parameter(
                helper.param_attr,
                shape=[in_dim, 3 * self.hidden_size],
                dtype=inputs.dtype)
            self._w_hh = helper.create_parameter(
                helper.param_attr,
                shape=[self.hidden_size, 3 * self.hidden_size],
                dtype=inputs.dtype)
        w_ih, w_hh = self._w_ih, self._w_hh
        gi = nn_layers.matmul(inputs, w_ih)
        gh = nn_layers.matmul(h, w_hh)
        gi_r, gi_z, gi_n = nn_layers.split(gi, 3, dim=-1)
        gh_r, gh_z, gh_n = nn_layers.split(gh, 3, dim=-1)
        r = nn_layers.sigmoid(gi_r + gh_r)
        z = nn_layers.sigmoid(gi_z + gh_z)
        n = nn_layers.tanh(gi_n + r * gh_n)
        new_h = (1.0 - z) * n + z * h
        return new_h, new_h


class BeamSearchDecoder:
    """Reference: layers/rnn.py BeamSearchDecoder. cell outputs logits
    via output_fn; ids feed back through embedding_fn."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = start_token
        self.end_token = end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def initialize(self, initial_cell_states):
        """initial_cell_states: [batch, ...] -> tiled to beams."""
        state = initial_cell_states
        batch = state.shape[0]
        # tile to [batch*beam, ...]
        state_t = nn_layers.expand(
            nn_layers.unsqueeze(state, axes=[1]),
            expand_times=[1, self.beam_size] + [1] * (len(state.shape)
                                                      - 1))
        state_t = tensor_layers.reshape(
            state_t, [batch * self.beam_size] + list(state.shape[1:]))
        ids = tensor_layers.fill_constant(
            [batch, self.beam_size], "int64", self.start_token)
        scores = tensor_layers.assign(
            np.tile(np.array([[0.0] + [-1e9] * (self.beam_size - 1)],
                             "float32"), (batch, 1)))
        return ids, scores, state_t

    def step(self, ids, scores, cell_states):
        batch, beam = ids.shape[0], self.beam_size
        inp = self.embedding_fn(tensor_layers.reshape(ids, [batch * beam])) \
            if self.embedding_fn else nn_layers.one_hot(
                tensor_layers.reshape(ids, [batch * beam, 1]), depth=64)
        cell_out, next_states = self.cell(inp, cell_states)
        logits = self.output_fn(cell_out) if self.output_fn else cell_out
        logp = nn_layers.log_softmax(logits)
        vocab = int(logp.shape[-1])
        logp3 = tensor_layers.reshape(logp, [batch, beam, vocab])
        outs = apply_op(
            "beam_search", "beam_search",
            {"pre_ids": [ids], "pre_scores": [scores],
             "scores": [logp3]},
            {"beam_size": beam, "end_id": self.end_token},
            ["selected_ids", "selected_scores", "parent_idx"])
        sel_ids, sel_scores, parents = outs
        # reorder cell states by parent beam
        flat_parent = parents + tensor_layers.assign(
            (np.arange(batch) * beam).reshape(batch, 1).astype("int64"))
        flat_parent = tensor_layers.reshape(flat_parent, [batch * beam])
        next_states = nn_layers.gather(next_states, flat_parent)
        return sel_ids, sel_scores, parents, next_states


def dynamic_decode(decoder, inits=None, max_step_num=20, output_time_major
                   =False, return_length=False, **kwargs):
    """Unrolled decode loop (reference: layers/rnn.py dynamic_decode).
    Returns (ids [batch, T, beam], scores [batch, beam]) after
    gather_tree backtracking."""
    ids, scores, states = decoder.initialize(inits)
    step_ids, step_parents = [], []
    for _ in range(max_step_num):
        ids, scores, parents, states = decoder.step(ids, scores, states)
        step_ids.append(ids)
        step_parents.append(parents)
    ids_stack = nn_layers.stack(step_ids, axis=0)      # [T, batch, beam]
    par_stack = nn_layers.stack(step_parents, axis=0)
    outs = apply_op("gather_tree", "gather_tree",
                    {"Ids": [ids_stack], "Parents": [par_stack]},
                    {}, ["Out"])[0]
    if not output_time_major:
        outs = tensor_layers.transpose(outs, [1, 0, 2])
    if return_length:
        # per-beam valid length: tokens before/at the first end token
        # (reference dynamic_decode returns sequence_lengths)
        end_id = getattr(decoder, "end_token", 1)
        time_axis = 0 if output_time_major else 1
        from .control_flow import equal, greater_than

        # reference dynamic_decode counts the step emitting the end
        # token: length = index of the first end token + 1 (whole T when
        # no end token appears). cumsum of is-end along time marks
        # positions strictly after the first end.
        is_end = tensor_layers.cast(
            equal(outs,
                  tensor_layers.fill_constant([1], outs.dtype, end_id)),
            "int64")
        after_first_end = tensor_layers.cast(
            greater_than(
                tensor_layers.cumsum(is_end, axis=time_axis),
                tensor_layers.fill_constant([1], "int64", 1)),
            "int64")
        t_extent = outs.shape[time_axis]
        lengths = nn_layers.elementwise_sub(
            tensor_layers.fill_constant([1], "int64", t_extent),
            nn_layers.reduce_sum(after_first_end, dim=time_axis))
        return outs, scores, lengths
    return outs, scores
