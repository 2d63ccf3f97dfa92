"""The reference's recurrent unit ops (`rnn_unit_ops`: `lstm`, `lstmp`,
`lstm_unit`, `gru`, `gru_unit`, `cudnn_lstm`) in the port
(paddle_tpu_torch, on the CPU) against the JAX package, table-driven as
`tests/test_torch_nn_extra_ops.py` (the cases of
`tests/torch_nn_cases.py`): `lstm`, `lstmp` and `gru` with and without
`is_reverse`, with full rows and with a ragged Length (padded steps carry
the state); `gru` and `gru_unit` in both `origin_mode`s; `cudnn_lstm`
one layer and two bidirectional layers over a ragged SequenceLength
(each row's valid steps reversed). Outputs, the padded positions
included, and the gradients of every float input (`jax.vjp` of the
reference's `lax.scan` against `torch.autograd` over the port's loop)
within fp32 rtol 1e-5; `infer_outputs` with a -1 batch equal."""
import numpy as np
import pytest
import torch

from paddle_tpu.ops import registry as rreg

import torch_case_parity as parity
from torch_nn_cases import CASES, RAGGED, cases_of, inputs

NAMES = cases_of("rnn_unit_ops")
TYPES = sorted({CASES[n][0] for n in NAMES})


@pytest.fixture(scope="module")
def reference():
    return parity.reference_results(NAMES)


def test_cases_cover_rnn_unit_ops():
    ref = {t for t in rreg.registered_ops() if rreg.get_op(
        t).compute.__module__ == "paddle_tpu.ops.rnn_unit_ops"}
    assert set(TYPES) == ref and len(ref) == 6
    for op in ("lstm", "gru"):
        ragged = [n for n in NAMES if CASES[n][0] == op
                  and "Length" in CASES[n][1]]
        assert {CASES[n][2].get("is_reverse", False) for n in ragged} == {
            False, True}, op


@pytest.mark.parametrize("name", NAMES)
def test_op_matches_reference(name, reference):
    parity.check_case(name, reference[name])


@pytest.mark.parametrize("name", NAMES)
def test_infer_outputs_matches_reference(name):
    parity.check_infer(name)


@pytest.mark.parametrize("op_type", TYPES)
def test_flags_match_the_reference(op_type):
    parity.check_flags(op_type)


@pytest.mark.parametrize("reverse", [False, True])
def test_padded_steps_hold_the_carried_state(reverse):
    """Forward: a row's outputs past its length repeat its last valid
    step. Reversed (the whole padded array from its end): a row's padded
    steps come first in the scan and hold its initial state."""
    ins = inputs("lstm_ragged")
    t_ins = {s: [parity.to_torch(a) for a in v] for s, v in ins.items()}
    out = parity.port("lstm", t_ins, {"is_reverse": reverse})
    hidden, cell = out["Hidden"][0], out["Cell"][0]
    for row, n in enumerate(RAGGED):
        for t in range(n, hidden.shape[1]):
            if reverse:
                want_h, want_c = t_ins["H0"][0][row], t_ins["C0"][0][row]
            else:
                want_h, want_c = hidden[row, n - 1], cell[row, n - 1]
            assert torch.equal(hidden[row, t], want_h)
            assert torch.equal(cell[row, t], want_c)


def test_cudnn_lstm_reverse_runs_each_rows_valid_steps():
    """The reverse direction of a row of length n equals the reverse
    direction over that row alone cut to n steps."""
    ins = inputs("cudnn_lstm_bidirec_ragged")
    attrs = dict(CASES["cudnn_lstm_bidirec_ragged"][2], num_layers=1)
    h = attrs["hidden_size"]
    d = ins["Input"][0].shape[-1]
    w = ins["W"][0][:2 * (4 * h * d + 4 * h * h + 8 * h)]
    full = parity.port("cudnn_lstm", {
        "Input": [torch.tensor(ins["Input"][0])], "W": [torch.tensor(w)],
        "SequenceLength": [torch.tensor(RAGGED, dtype=torch.int32)]},
        attrs)["Out"][0]
    for row, n in enumerate(RAGGED):
        alone = parity.port("cudnn_lstm", {
            "Input": [torch.tensor(ins["Input"][0][:n, row:row + 1])],
            "W": [torch.tensor(w)]}, attrs)["Out"][0]
        np.testing.assert_allclose(full[:n, row], alone[:, 0], rtol=1e-6,
                                   atol=1e-6)
