"""Hierarchical data parallelism over NCCL, one rank a card, with the
gradient exchange launched from the backward. Every test here needs four
NVIDIA GPUs (marker ``cuda``) and skips with fewer. The file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_hierarchical_cuda.py

Four NCCL ranks on a (dcn 2, ici 2) world (``FLAGS_tpu_dcn_replicas``
2) with ``FLAGS_cudnn_deterministic`` on run the conv + batch norm net
of tests/torch_dp_runner.py through `with_data_parallel` over Momentum,
with the sharded update in buckets, eagerly and captured (the first
step eager, the second captured, the rest replays), each from the same
start state. The captured job's losses and its state at the logical
shape equal the eager job's bit for bit, the replays included, and the
ranks hold the same state but batch norm's running statistics: a replay
of a step whose hooks launched NCCL reduce-scatters inside the backward
gives the eager step's values; the capture's exchange record shows
bucket 0 launched with backward left to run.
"""
import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch import distributed, fluid

import torch_dp_runner as runner

pytestmark = pytest.mark.cuda

WORLD, STEPS = 4, 4


def hier_card_worker(d):
    """One rank: the net eager and captured, from the same start state;
    writes the losses, the logical state, the entry's phase and the
    exchange record of each."""
    from paddle_tpu_torch.core.types import to_numpy

    rank = distributed.get_rank()
    fluid.set_flags({"FLAGS_cudnn_deterministic": True,
                     "FLAGS_tpu_dcn_replicas": 2,
                     "FLAGS_tpu_sharded_weight_update": True,
                     "FLAGS_tpu_comm_bucket_mb": runner.ZERO_CAP_MB})
    out = {}
    for mode in ("eager", "graph"):
        fluid.set_flags({"FLAGS_cuda_graphs": mode == "graph"})
        main, startup, loss = runner.build_cnn(
            fluid, lambda loss: fluid.optimizer.MomentumOptimizer(
                0.1, momentum=0.9).minimize(loss))
        exe = fluid.Executor()
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        prog = fluid.CompiledProgram(main).with_data_parallel()
        feed = runner.image_feed(runner.CNN)
        out[mode + ".losses"] = np.stack([
            exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)[0]
            for _ in range(STEPS)])
        out[mode + ".phase"] = np.array(exe.last_entry.phase)
        out[mode + ".overlap"] = np.array(json.dumps(exe.overlap_report(
            prog, feed=feed, fetch_list=[loss], scope=scope)))
        out[mode + ".world"] = np.array(json.dumps(
            [main._mesh.axis_names, main._shard_plan.ndev,
             main._shard_plan.world]))
        for n in sorted(v.name for v in main.list_vars() if v.persistable):
            out[mode + ".state." + n] = to_numpy(
                exe.read_logical(n, main, scope))
    np.savez(os.path.join(d, "hier_card.rank%d.npz" % rank), **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if torch.cuda.device_count() < WORLD:
        pytest.skip("needs %d CUDA devices (one NCCL rank a card)" % WORLD)
    d = str(tmp_path_factory.mktemp("hier_card"))
    distributed.spawn(hier_card_worker, (d,), nprocs=WORLD, backend="nccl",
                      timeout=300)
    out = []
    for r in range(WORLD):
        with np.load(os.path.join(d, "hier_card.rank%d.npz" % r)) as f:
            out.append(dict(f))
    return out


def test_captured_equals_eager(runs):
    for rank in runs:
        assert json.loads(str(rank["graph.world"])) == [["dcn", "ici"], 2, 4]
        assert str(rank["eager.phase"]) == "eager"
        assert str(rank["graph.phase"]) == "captured"
        np.testing.assert_array_equal(rank["graph.losses"],
                                      rank["eager.losses"])
        for k, v in rank.items():
            if k.startswith("eager.state."):
                np.testing.assert_array_equal(
                    rank["graph" + k[len("eager"):]], v, err_msg=k)
        # the replicas agree, but in the running statistics, which
        # batch norm keeps per rank
        for k, v in runs[0].items():
            if k.endswith("losses") or ".state." in k and not k.endswith(
                    (".mean_0", ".var_0")):
                np.testing.assert_array_equal(rank[k], v, err_msg=k)


def test_replays_of_launched_exchange_equal_eager(runs):
    """Steps 3 and 4 of the captured job are replays of the step whose
    hooks launched the NCCL exchange during the capture."""
    for rank in runs:
        np.testing.assert_array_equal(rank["graph.losses"][2:],
                                      rank["eager.losses"][2:])
        assert np.isfinite(rank["graph.losses"]).all()


def test_capture_records_the_exchange_inside_the_backward(runs):
    for rank in runs:
        rep = json.loads(str(rank["graph.overlap"]))
        assert rep["captured"] and rep["launched_in_backward"]
        assert rep["n_buckets"] >= 2
        assert rep["collectives"][0]["bucket"] == 0
        assert rep["collectives"][0]["backward_after"] > 0
        assert not json.loads(str(rank["eager.overlap"]))["captured"]
