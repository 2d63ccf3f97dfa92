"""Checkpoints and model io of the port on the card. Every test here needs
an NVIDIA GPU (marker ``cuda``) and skips without one; the last needs
four. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_checkpoint_cuda.py

- A checkpoint loaded into the scope of a captured block reaches the
  graph: the next replays repeat the steps after the save bit for bit,
  also where the files hold float32 values for bfloat16 vars (AMP O2's
  live params), which are cast before the replay reads them.
- bfloat16 files written and read in a process where ``ml_dtypes``
  cannot be imported: per-var files, the ``filename=`` pickle and
  ``fluid.save``, every value back bit for bit as ``torch.bfloat16``.
- `AsyncCheckpointer.save_async` while replays overwrite the state in
  the tensors the scope holds: the checkpoint is the state of the save.
- Four cards: ``tools/torch_fleet_dp_nccl.py --checkpoint`` (config 5 at
  128 a rank, ZeRO captured over NCCL, ``FLAGS_cudnn_deterministic``):
  the resumed job bit-equal to the uninterrupted one, and the flat
  job's checkpoint resumed on 2 pods: its first step's exchanged
  gradients within one bf16 unit of the flat resume's.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import checkpoint, io
from paddle_tpu_torch.fluid.contrib import mixed_precision
from paddle_tpu_torch.models import bert

import torch_ckpt_runner as runner

pytestmark = pytest.mark.cuda

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _mlp():
    return runner.build_mlp(fluid, lambda loss: fluid.optimizer.AdamOptimizer(
        runner.MLP_LR).minimize(loss))


def _bert_amp(seq=32):
    cfg = bert.BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        total = bert.bert_pretrain_loss(cfg, seq, scan_layers=True)[0]
        mixed_precision.decorate(fluid.optimizer.AdamOptimizer(1e-3),
                                 use_dynamic_loss_scaling=False
                                 ).minimize(total)
        fluid.fuse_optimizer_ops(main)
    return main, startup, total, bert.bert_feed(cfg, 2, seq)


def _steps(exe, main, loss, scope, feed, n=STEPS):
    return [exe.run(main, feed=feed, fetch_list=[loss],
                    scope=scope)[0].tolist() for _ in range(n)]


def _state(scope, names):
    return {n: scope.find_var(n).clone() for n in names}


def _names(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def test_checkpoint_loaded_into_a_captured_block(card, tmp_path):
    main, startup, loss = _mlp()
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = runner.mlp_feed()
    _steps(exe, main, loss, scope, feed)
    assert exe.last_entry.phase == "captured"
    root = str(tmp_path / "c")
    checkpoint.save_checkpoint(exe, root, checkpoint.TrainStatus(0, STEPS),
                               main, scope=scope)
    a = _steps(exe, main, loss, scope, feed)
    assert checkpoint.load_checkpoint(exe, root, main,
                                      scope=scope).step_no == STEPS
    b = _steps(exe, main, loss, scope, feed)
    assert exe.last_entry.phase == "captured" and a == b


def test_float32_files_into_a_captured_bf16_block(card, tmp_path):
    """AMP O2 keeps its live params in bfloat16; the same values saved
    as float32 files load into the captured block's scope as bfloat16
    and the replays repeat the steps after the save."""
    main, startup, total, feed = _bert_amp()
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    _steps(exe, main, total, scope, feed, 2)
    assert exe.last_entry.phase == "captured"
    names = _names(main)
    state = _state(scope, names)
    bf16 = [n for n, v in state.items() if v.dtype == torch.bfloat16]
    assert bf16
    io._save_dict(str(tmp_path), {n: v.float() if n in bf16 else v
                                  for n, v in state.items()})
    a = _steps(exe, main, total, scope, feed)
    with fluid.scope_guard(scope):
        io.load_persistables(exe, str(tmp_path), main)
    assert all(scope.find_var(n).dtype == torch.bfloat16 for n in bf16)
    b = _steps(exe, main, total, scope, feed)
    assert exe.last_entry.phase == "captured" and a == b


def test_bf16_files_without_ml_dtypes(card, tmp_path):
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "sys.path.insert(0, %r)\n"
        "import test_torch_checkpoint_cuda as t\n"
        "from paddle_tpu_torch import fluid\n"
        "from paddle_tpu_torch.fluid import io\n"
        "main, startup, total, feed = t._bert_amp()\n"
        "exe = fluid.Executor()\n"
        "scope = fluid.Scope()\n"
        "exe.run(startup, scope=scope)\n"
        "exe.run(main, feed=feed, fetch_list=[total], scope=scope)\n"
        "names = t._names(main)\n"
        "want = t._state(scope, names)\n"
        "d = %r\n"
        "with fluid.scope_guard(scope):\n"
        "    io.save_persistables(exe, d + '/npy', main)\n"
        "    io.save_persistables(exe, d + '/pkl', main, filename='all')\n"
        "    io.save(main, d + '/m/model')\n"
        "n_bf16 = 0\n"
        "for how in ('npy', 'pkl', 'model'):\n"
        "    s = fluid.Scope()\n"
        "    with fluid.scope_guard(s):\n"
        "        if how == 'npy':\n"
        "            io.load_persistables(exe, d + '/npy', main)\n"
        "        elif how == 'pkl':\n"
        "            io.load_persistables(exe, d + '/pkl', main, "
        "filename='all')\n"
        "        else:\n"
        "            io.load(main, d + '/m/model', exe)\n"
        "    for n, v in want.items():\n"
        "        got = s.find_var(n)\n"
        "        assert got.dtype == v.dtype and got.is_cuda, (how, n)\n"
        "        assert torch.equal(got.view(torch.int16) if v.dtype == "
        "torch.bfloat16 else got, v.view(torch.int16) if v.dtype == "
        "torch.bfloat16 else v), (how, n)\n"
        "        n_bf16 += v.dtype == torch.bfloat16\n"
        "assert n_bf16 > 0 and sys.modules['ml_dtypes'] is None\n"
        "print('BF16-OK', n_bf16)\n") % (os.path.dirname(
            os.path.abspath(__file__)), str(tmp_path))
    env = dict(os.environ, PYTHONPATH=_REPO)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=_REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "BF16-OK" in r.stdout, r.stderr[-3000:]


def test_async_snapshot_while_replays_overwrite(card, tmp_path):
    main, startup, loss = _mlp()
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = runner.mlp_feed()
    _steps(exe, main, loss, scope, feed)
    assert exe.last_entry.phase == "captured"
    names = _names(main)
    want = _state(scope, names)
    writer = checkpoint.AsyncCheckpointer(str(tmp_path / "a"), main,
                                          scope=scope)
    writer.save_async(checkpoint.TrainStatus(0, STEPS))
    _steps(exe, main, loss, scope, feed, 5)
    writer.close()
    assert not all(torch.equal(scope.find_var(n), want[n]) for n in names)
    got = io._load_pickle(os.path.join(checkpoint.latest_checkpoint_dir(
        str(tmp_path / "a")), "persistables.pkl"))
    for n in names:
        assert np.array_equal(io._host_array(got[n])[0],
                              io._host_array(want[n])[0]), n


def test_four_card_checkpoint_mode(card):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices (one NCCL rank a card)")
    r = subprocess.run(
        [sys.executable, os.path.join(_REPO, "tools",
                                      "torch_fleet_dp_nccl.py"),
         "--checkpoint"], cwd=_REPO, capture_output=True, text=True,
        timeout=1200)
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("{"))
    print(line)
    res = json.loads(line)
    assert r.returncode == 0, (res, r.stderr[-3000:])
    assert res["resumed_bit_equal"] and res["phase"] == "captured"
    assert res["hybrid_first_step_grad_rel_norm"] <= res["hybrid_grad_bound"]
