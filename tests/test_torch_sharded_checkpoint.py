"""The port's `ShardedCheckpointManager` and the cross-rank agreement
protocol (`paddle_tpu_torch/distributed/sharded_checkpoint.py`), on the
CPU, after the JAX package's `tests/test_sharded_checkpoint.py`: a step
the SPMD trainer saved on a tp4 mesh of 4 gloo ranks restores into a tp2
mesh of 2 ranks (each rank reading only its blocks), into one process,
and into the same mesh, where the next steps repeat bit for bit;
retention, scalar leaves, the fallback past a corrupt newest step, an
unpublished step. `agree_newest_intact` decides as the reference's does
on the same per-rank candidates. The on-disk format is the port's own
(ROADMAP Queue 3)."""
import json
import os
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import sharded_checkpoint as rsc

from paddle_tpu_torch import distributed
from paddle_tpu_torch.distributed import ShardedCheckpointManager
from paddle_tpu_torch.distributed import sharded_checkpoint as tsc
from paddle_tpu_torch.parallel import transformer as tt

import torch_ckpt_runner as runner

SPAWN_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The tp4 save on 4 ranks, then the tp2 restore on 2: (dir, the
    save's record, the restore's records by rank)."""
    d = str(tmp_path_factory.mktemp("mesh"))
    cfg = tt.SPMDConfig(**runner.MESH_CFG)
    init = tt.params_to_numpy(tt.init_params(cfg, seed=3, device="cpu"))
    np.savez(os.path.join(d, "init.npz"), **dict(runner._flat(init)))
    distributed.spawn(runner.mesh_save, (d, 4), nprocs=4, backend="gloo",
                      timeout=SPAWN_TIMEOUT_S)
    distributed.spawn(runner.mesh_restore, (d, 2), nprocs=2,
                      backend="gloo", timeout=SPAWN_TIMEOUT_S)
    with np.load(os.path.join(d, "mesh_save.npz")) as f:
        saved = dict(f)
    restored = []
    for r in range(2):
        with np.load(os.path.join(d, "mesh_restore.rank%d.npz" % r)) as f:
            restored.append(dict(f))
    return d, saved, restored


def _saved_tree(saved):
    return {k[len("saved/"):]: v for k, v in saved.items()
            if k.startswith("saved/")}


def test_restore_relays_out_on_another_world_size(mesh_runs):
    """tp4 -> tp2: each rank's block of every leaf is its slice of the
    saved global array, and the tree gathered back equals the saved one
    bit for bit."""
    _, saved, restored = mesh_runs
    want = _saved_tree(saved)
    cfg = tt.SPMDConfig(tp=2, **runner.MESH_CFG)
    tree = runner._unflat(want)
    tree["opt"] = (tree["opt"]["0"], tree["opt"]["1"])
    specs = {path: spec for path, _, spec in tsc._leaves(
        tree, {"params": tt.param_specs(cfg),
               "opt": (tt.param_specs(cfg),) * 2})}
    for rank, got in enumerate(restored):
        for path, v in want.items():
            np.testing.assert_array_equal(got["gathered/" + path], v,
                                          err_msg=path)
            block = v
            for dim, axis in enumerate(specs[path] or ()):
                if axis == "tp":
                    k = v.shape[dim] // 2
                    block = np.take(block, range(rank * k, (rank + 1) * k),
                                    axis=dim)
            np.testing.assert_array_equal(got["local/" + path], block,
                                          err_msg=path)


def test_restore_into_one_process(mesh_runs):
    """Without a mesh the step comes back whole: every param and moment
    bit-equal to the tp4 tree gathered at the save, by template (its
    dtype) or without one (the saved tree)."""
    d, saved, _ = mesh_runs
    want = _saved_tree(saved)
    mgr = ShardedCheckpointManager(os.path.join(d, "ckpt"))
    whole = dict(runner._flat(mgr.restore()))
    assert sorted(whole) == sorted(want)
    template = runner._unflat({k: torch.zeros(v.shape)
                               for k, v in want.items()})
    template["opt"] = (template["opt"]["0"], template["opt"]["1"])
    back = dict(runner._flat(mgr.restore(template=template)))
    for path, v in want.items():
        np.testing.assert_array_equal(whole[path].numpy(), v, err_msg=path)
        np.testing.assert_array_equal(back[path].numpy(), v, err_msg=path)


def test_resume_on_the_same_mesh_repeats_the_steps(mesh_runs):
    _, saved, _ = mesh_runs
    assert list(saved["steps"]) == [runner.STEPS]
    np.testing.assert_array_equal(saved["resumed"], saved["after"])
    assert np.isfinite(saved["after"]).all()


def _tree(seed=0):
    r = np.random.RandomState(seed)
    return {"w": torch.tensor(r.randn(4, 6).astype("float32")),
            "b": torch.tensor(r.randn(6).astype("float32")).to(
                torch.bfloat16),
            "n": [torch.arange(3, dtype=torch.int32), 7, 0.5]}


def _equal(a, b):
    fa, fb = dict(runner._flat(a)), dict(runner._flat(b))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def test_scalar_and_bf16_leaves_roundtrip(tmp_path):
    mgr = ShardedCheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(0, tree)
    _equal(mgr.restore(template=_tree(1)), tree)
    got = mgr.restore()
    assert got["n"][1] == 7 and got["n"][2] == 0.5
    assert got["b"].dtype == torch.bfloat16


def test_retention_prunes_old_steps(tmp_path):
    mgr = ShardedCheckpointManager(str(tmp_path), max_to_keep=2)
    for s in range(4):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    _equal(mgr.restore(), _tree(3))
    _equal(mgr.restore(step=2), _tree(2))


def test_restore_falls_back_past_corrupt_latest_step(tmp_path):
    mgr = ShardedCheckpointManager(str(tmp_path), max_to_keep=3)
    for s in range(3):
        mgr.save(s, _tree(s))
    piece = next(f for f in os.listdir(tmp_path / "2")
                 if f.startswith("w.") and f.endswith(".npy"))
    with open(tmp_path / "2" / piece, "wb") as f:
        f.write(b"\x00truncated")
    _equal(mgr.restore(template=_tree()), _tree(1))
    with pytest.raises(Exception):
        mgr.restore(step=2, template=_tree())


def test_restore_raises_when_no_step_is_intact(tmp_path):
    mgr = ShardedCheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    mgr.save(0, _tree())
    with open(tmp_path / "0" / "meta.json") as f:
        meta = json.load(f)
    meta["leaves"]["w"]["shape"] = [5, 6]
    with open(tmp_path / "0" / "meta.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(RuntimeError, match="no intact checkpoint"):
        mgr.restore(template=_tree())


def test_unpublished_step_is_invisible(tmp_path, monkeypatch):
    """A kill after the pieces are written and before the publication
    leaves a .tmp directory that no step listing or restore sees."""
    mgr = ShardedCheckpointManager(str(tmp_path))
    mgr.save(0, _tree(0))

    class Killed(Exception):
        pass

    def die(tmp):
        raise Killed(tmp)

    monkeypatch.setattr(ShardedCheckpointManager, "_before_publish",
                        staticmethod(die))
    with pytest.raises(Killed):
        mgr.save(1, _tree(1))
    assert os.path.isdir(tmp_path / "1.tmp")
    assert mgr.all_steps() == [0]
    _equal(mgr.restore(), _tree(0))


class _ThreadGroup:
    """A host-collective group of threads in this process (all_reduce of
    small int64 arrays)."""

    def __init__(self, world):
        self.world = world
        self._barrier = threading.Barrier(world)
        self._vals = [None] * world

    def member(self, rank):
        group = self

        class Member:
            def __init__(self):
                self.rank = rank

            def all_reduce(self, a, op="sum"):
                group._vals[rank] = np.asarray(a)
                group._barrier.wait()
                stack = np.stack(group._vals)
                out = {"min": stack.min(0), "max": stack.max(0),
                       "sum": stack.sum(0)}[op]
                group._barrier.wait()
                return out

        return Member()


CASES = {
    # rank -> (candidates, the steps it cannot load)
    "truncated_rank": {0: ([3, 2, 1], []), 1: ([3, 2, 1], [3])},
    "missing_step": {0: ([5, 4], []), 1: ([4, 3], [])},
    "nothing_everywhere": {0: ([2, 1], [2, 1]), 1: ([2], [])},
}


def _agree(module, case):
    g = _ThreadGroup(2)
    out = {}

    def run(rank):
        cands, bad = CASES[case][rank]

        def load(s):
            if s in bad:
                raise IOError("corrupt step %d" % s)
            return "step%d" % s

        try:
            out[rank] = module.agree_newest_intact(cands, load,
                                                   g.member(rank))
        except RuntimeError:
            out[rank] = "none"

    ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_agreement_decides_as_the_reference(case):
    got, want = _agree(tsc, case), _agree(rsc, case)
    assert got == want and got[0] == got[1]
