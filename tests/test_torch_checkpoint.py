"""The port's numbered checkpoints (`fluid/checkpoint.py`), dataset
training with auto-resume (`fluid/trainer.py`), the executor's elastic
checkpoint half and the data-parallel logical saves, on the CPU, with
the JAX package's `tests/test_checkpoint_resume.py` and
`tests/test_sharded_update.py` (its sharded checkpoint round trip and
its agreement on a truncated rank) as the model.

The reference's checkpoint directories load in the port and the port's
in the reference. Every multi-rank case runs over gloo in processes of
`tests/torch_ckpt_runner.py` with a time limit of its own, so a hang
fails one test."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rfluid
from paddle_tpu.core.scope import Scope as RScope
from paddle_tpu.fluid import checkpoint as rckpt
from paddle_tpu.fluid import io as rio

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import distributed, fleet as tfleet
from paddle_tpu_torch.core.types import to_numpy
from paddle_tpu_torch.fluid import checkpoint as ckpt
from paddle_tpu_torch.fluid import io as tio

import torch_ckpt_runner as runner

_HERE = os.path.dirname(os.path.abspath(__file__))
#: (ranks, pods) of the data-parallel save cases
ZERO_WORLDS = ((2, 1), (4, 1), (4, 2))
SPAWN_TIMEOUT_S = 240


def _adam(fluid):
    return lambda loss: fluid.optimizer.AdamOptimizer(
        runner.MLP_LR).minimize(loss)


def _port_mlp(seed=7):
    return runner.build_mlp(tfluid, _adam(tfluid), seed)


def _state(scope, names):
    """Host copies (a CPU tensor's numpy view would follow the in-place
    writes of later steps)."""
    return {n: to_numpy(scope.find_var(n)).copy() for n in names}


def _names(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _run(exe, main, loss, scope, feed):
    return float(exe.run(main, feed=feed, fetch_list=[loss],
                         scope=scope)[0].ravel()[0])


def test_save_load_roundtrip_and_retention(tmp_path):
    root = str(tmp_path / "ckpts")
    main, startup, loss = _port_mlp()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = runner.mlp_feed()
    for step in range(5):
        _run(exe, main, loss, scope, feed)
        ckpt.save_checkpoint(exe, root, ckpt.TrainStatus(0, step), main,
                             checkpoint_num=2, scope=scope)
    nums = sorted(int(d.split(".")[1]) for d in os.listdir(root))
    assert nums == [3, 4] and ckpt.get_last_checkpoint_no(root) == 4
    # a stray .tmp directory (a kill before publication) is never listed
    os.makedirs(os.path.join(root, "__paddle_tpu_checkpoint__.9.tmp"))
    assert ckpt.get_last_checkpoint_no(root) == 4
    saved = _state(scope, _names(main))
    drift = _run(exe, main, loss, scope, feed)
    status = ckpt.load_checkpoint(exe, root, main, scope=scope)
    assert status.step_no == 4 and status.epoch_no == 0
    for n, v in saved.items():
        np.testing.assert_array_equal(to_numpy(scope.find_var(n)), v)
    assert _run(exe, main, loss, scope, feed) == drift


def test_load_checkpoint_falls_back_past_corrupt_latest(tmp_path):
    root = str(tmp_path / "ckpts")
    main, startup, loss = _port_mlp()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    for step in range(3):
        _run(exe, main, loss, scope, runner.mlp_feed())
        ckpt.save_checkpoint(exe, root, ckpt.TrainStatus(0, step), main,
                             scope=scope)
    with open(os.path.join(ckpt.latest_checkpoint_dir(root),
                           "persistables.pkl"), "wb") as f:
        f.write(b"\x00truncated")
    assert ckpt.load_checkpoint(exe, root, main, scope=scope).step_no == 1
    for d in os.listdir(root):
        with open(os.path.join(root, d, "persistables.pkl"), "wb") as f:
            f.write(b"\x00truncated")
    with pytest.raises(RuntimeError, match="no intact checkpoint"):
        ckpt.load_checkpoint(exe, root, main, scope=scope)


def test_schema_mismatch_raises_at_once(tmp_path):
    """A program with a persistable the checkpoints lack fails on the
    newest one, without falling back (every older one lacks it too),
    and leaves the scope untouched."""
    root = str(tmp_path / "ckpts")
    main, startup, loss = _port_mlp()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    for step in range(2):
        ckpt.save_checkpoint(exe, root, ckpt.TrainStatus(0, step), main,
                             scope=scope)
    bigger, bstart, _ = runner.build_mlp(tfluid, _adam(tfluid))
    with tfluid.program_guard(bigger, bstart):
        tfluid.layers.create_parameter([3], "float32", name="extra_w")
    s2 = tfluid.Scope()
    exe.run(bstart, scope=s2)
    before = _state(s2, _names(bigger))
    with pytest.raises(RuntimeError, match="missing vars.*extra_w"):
        ckpt.load_checkpoint(exe, root, bigger, scope=s2)
    for n, v in before.items():
        np.testing.assert_array_equal(to_numpy(s2.find_var(n)), v)


def test_load_checkpoint_empty_dir(tmp_path):
    main = _port_mlp()[0]
    exe = tfluid.Executor(tfluid.CPUPlace())
    assert ckpt.load_checkpoint(exe, str(tmp_path / "nope"), main) is None
    with pytest.raises(RuntimeError, match="no checkpoint"):
        ckpt.load_checkpoint(exe, str(tmp_path / "nope"), main,
                             ignore_empty=False)


def _graph_exe():
    """An executor whose blocks run the captured path on the CPU: the
    step over static buffers that each "replay" overwrites in place."""
    return tfluid.Executor(tfluid.CPUPlace(),
                           graph_runner=lambda body: body())


def test_async_snapshot_survives_in_place_replays(tmp_path):
    """`save_async` at step 3 while the captured block's replays write
    steps 4-6 into the very tensors the scope holds: the checkpoint is
    step 3's state, bit-equal to a synchronous save of it."""
    main, startup, loss = _port_mlp()
    exe = _graph_exe()
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = runner.mlp_feed()
    for _ in range(3):
        _run(exe, main, loss, scope, feed)
    assert exe.last_entry.phase == "captured"
    names = _names(main)
    buffers = {n: scope.find_var(n) for n in names}
    want = _state(scope, names)
    ckpt.save_checkpoint(exe, str(tmp_path / "sync"),
                         ckpt.TrainStatus(0, 3), main, scope=scope)
    writer = ckpt.AsyncCheckpointer(str(tmp_path / "async"), main,
                                    scope=scope)
    writer.save_async(ckpt.TrainStatus(0, 3))
    for _ in range(3):
        _run(exe, main, loss, scope, feed)
    writer.close()
    # the replays wrote into the same tensors
    assert all(scope.find_var(n) is buffers[n] for n in names
               if not n.startswith("learning_rate"))
    assert not all(np.array_equal(to_numpy(scope.find_var(n)), want[n])
                   for n in names)
    a = tio._load_pickle(os.path.join(ckpt.latest_checkpoint_dir(
        str(tmp_path / "async")), "persistables.pkl"))
    s = tio._load_pickle(os.path.join(ckpt.latest_checkpoint_dir(
        str(tmp_path / "sync")), "persistables.pkl"))
    for n in names:
        np.testing.assert_array_equal(a[n], want[n], err_msg=n)
        np.testing.assert_array_equal(a[n], s[n], err_msg=n)


def test_load_into_captured_block_reaches_the_graph(tmp_path):
    """A checkpoint loaded into the scope of a captured block: the next
    replay copies it into the static buffers (the steps repeat bit for
    bit), and the loaded tensors keep the buffers' dtypes."""
    main, startup, loss = _port_mlp()
    exe = _graph_exe()
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = runner.mlp_feed()
    for _ in range(3):
        _run(exe, main, loss, scope, feed)
    root = str(tmp_path / "c")
    ckpt.save_checkpoint(exe, root, ckpt.TrainStatus(0, 3), main,
                         scope=scope)
    a = [_run(exe, main, loss, scope, feed) for _ in range(3)]
    ckpt.load_checkpoint(exe, root, main, scope=scope)
    assert exe.last_entry.phase == "captured"
    b = [_run(exe, main, loss, scope, feed) for _ in range(3)]
    assert a == b


def _run_runner(d, kill_at):
    r = subprocess.run(
        [sys.executable, os.path.join(_HERE, "torch_ckpt_runner.py"),
         "kill", d, str(kill_at)], capture_output=True, text=True,
        timeout=SPAWN_TIMEOUT_S, cwd=os.path.dirname(_HERE))
    steps = {int(m.group(1)): float(m.group(2))
             for m in re.finditer(r"step (\d+): ([-\d.e]+)", r.stdout)}
    start = int(re.search(r"RESUME (\d+)", r.stdout).group(1))
    return r.returncode, steps, start, r.stdout + r.stderr


def test_kill_and_resume_matches_uninterrupted(tmp_path, capsys):
    """A process killed between writing step 3's checkpoint and
    publishing it restarts from step 2's (the .tmp directory is never
    read) and repeats the uninterrupted run's losses (here, in this
    process) bit for bit."""
    threads = torch.get_num_threads()
    try:
        runner.kill_main(str(tmp_path / "full"), 0)
    finally:
        torch.set_num_threads(threads)
    full = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"step (\d+): ([-\d.e]+)", capsys.readouterr().out)}
    assert sorted(full) == list(range(6))
    d = str(tmp_path / "killed")
    rc, first, _, out = _run_runner(d, 3)
    assert rc == 9 and sorted(first) == [0, 1, 2, 3], out
    assert ckpt.get_last_checkpoint_no(d) == 2
    assert os.path.isdir(os.path.join(d, "__paddle_tpu_checkpoint__.3.tmp"))
    rc, second, start, out = _run_runner(d, 0)
    assert rc == 0 and start == 3, out
    assert {**first, **second} == full


class _Dataset:
    def __init__(self, n, batch=8):
        self.batches = [runner.mlp_feed(batch, seed=s) for s in range(n)]

    def _iter_batches(self):
        return iter(self.batches)


def test_train_from_dataset_resumes(tmp_path):
    """`Executor.train_from_dataset` with a checkpoint directory: a run
    over 4 batches saves at step 4; a run over the 7-batch dataset then
    resumes there, skips those batches and ends bit-equal to one run
    over all 7."""
    def run(n, root, scope):
        main, startup, loss = _port_mlp()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        out = exe.train_from_dataset(main, _Dataset(n), scope=scope,
                                     fetch_list=[loss], print_period=0,
                                     checkpoint_dir=root,
                                     checkpoint_every_n_steps=3)
        return out, main

    full = tfluid.Scope()
    want, main = run(7, None, full)
    root = str(tmp_path / "c")
    run(4, root, tfluid.Scope())
    assert ckpt.read_status(ckpt.latest_checkpoint_dir(root)).step_no == 4
    resumed = tfluid.Scope()
    got, _ = run(7, root, resumed)
    assert ckpt.read_status(ckpt.latest_checkpoint_dir(root)).step_no == 7
    np.testing.assert_array_equal(got[0], want[0])
    for n in _names(main):
        np.testing.assert_array_equal(to_numpy(resumed.find_var(n)),
                                      to_numpy(full.find_var(n)))


def test_elastic_tick_saves_and_resumes(tmp_path, monkeypatch):
    """fleet's `strategy.elastic`: the executor checkpoints every
    `save_steps` steps in the background, and a new job of the same
    program resumes from the newest at its first run, counting on."""
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    root = str(tmp_path / "elastic")

    def job():
        st = tfleet.DistributedStrategy()
        st.elastic = True
        st.elastic_configs = {"checkpoint_dir": root, "save_steps": 2,
                              "max_checkpoints": 2}
        main, startup, loss = runner.build_mlp(
            tfluid, lambda l: tfleet.distributed_optimizer(
                tfluid.optimizer.AdamOptimizer(runner.MLP_LR),
                st).minimize(l))
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        return main, loss, exe, scope

    main, loss, exe, scope = job()
    feed = runner.mlp_feed()
    losses = [_run(exe, main, loss, scope, feed) for _ in range(5)]
    main._elastic_cfg["_ckpt"].close()
    assert ckpt.read_status(ckpt.latest_checkpoint_dir(root)).step_no == 3
    assert ckpt.get_last_checkpoint_no(root) == 1
    main2, loss2, exe2, scope2 = job()
    # the resumed job runs step 4 from step 3's state: the first job's
    # fifth loss
    assert _run(exe2, main2, loss2, scope2, feed) == losses[4]
    assert main2._elastic_cfg["_step"] == 5


def test_checkpoints_cross_between_packages(tmp_path, rng):
    """A checkpoint directory the reference wrote loads in the port, and
    the port's in the reference: every value bit-equal, the status
    kept."""
    main, startup, loss = _port_mlp()
    rmain, rstartup, rloss = runner.build_mlp(
        rfluid, lambda l: rfluid.optimizer.AdamOptimizer(
            runner.MLP_LR).minimize(l))
    rexe = rfluid.Executor(rfluid.CPUPlace())
    rs = RScope()
    with rfluid.scope_guard(rs):
        rexe.run(rstartup)
        rexe.run(rmain, feed=runner.mlp_feed(), fetch_list=[rloss])
        rckpt.save_checkpoint(rexe, str(tmp_path / "ref"),
                              rckpt.TrainStatus(1, 5), rmain)
    names = _names(main)
    want = {n: np.asarray(rs.find_var(n)) for n in names}
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    st = ckpt.load_checkpoint(exe, str(tmp_path / "ref"), main, scope=scope)
    assert (st.epoch_no, st.step_no) == (1, 5)
    for n in names:
        np.testing.assert_array_equal(to_numpy(scope.find_var(n)), want[n])
    ckpt.save_checkpoint(exe, str(tmp_path / "port"),
                         ckpt.TrainStatus(2, 6), main, scope=scope)
    r2 = RScope()
    with rfluid.scope_guard(r2):
        st = rckpt.load_checkpoint(rexe, str(tmp_path / "port"), rmain)
    assert (st.epoch_no, st.step_no) == (2, 6)
    for n in names:
        got = np.asarray(r2.find_var(n))
        assert got.dtype == want[n].dtype
        np.testing.assert_array_equal(got, want[n])


# -- data-parallel worlds --------------------------------------------------

@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The multi-rank cases, started together, joined by the tests."""
    runs = {}
    for world, dcn in ZERO_WORLDS:
        d = str(tmp_path_factory.mktemp("zero%d_%d" % (world, dcn)))
        runs["zero", world, dcn] = (d, distributed.spawn(
            runner.zero_ranks, (d, dcn), nprocs=world, backend="gloo",
            join=False))
    d = str(tmp_path_factory.mktemp("agree"))
    runs["agree"] = (d, distributed.spawn(runner.agree_ranks, (d,),
                                          nprocs=2, backend="gloo",
                                          join=False))
    yield runs
    for _, sc in runs.values():
        try:
            sc.join(1)
        except (RuntimeError, TimeoutError):
            pass


def _ranks(spawned, key, name, n):
    d, sc = spawned[key]
    sc.join(SPAWN_TIMEOUT_S)
    out = []
    for r in range(n):
        with np.load(os.path.join(d, "%s.rank%d.npz" % (name, r))) as f:
            out.append(dict(f))
    return d, out


@pytest.mark.parametrize("world,dcn", ZERO_WORLDS)
def test_zero_saves_logical_state(spawned, world, dcn):
    """With the sharded update, every rank calls the saves and rank 0
    writes each var at its logical shape: the per-var files, the
    pickles and the checkpoint equal `read_logical` bit for bit, on a
    flat world and on 2 pods, and read the same in the reference."""
    d, ranks = _ranks(spawned, ("zero", world, dcn), "zero", world)
    r0 = ranks[0]
    assert int(r0["sharded_vars"]) > 0
    assert str(r0["axes"]) == ("dcn,ici" if dcn > 1 else "dp")
    logical = {k[len("logical."):]: v for k, v in r0.items()
               if k.startswith("logical.")}
    for r in ranks[1:]:
        for n, v in logical.items():
            np.testing.assert_array_equal(r["logical." + n], v)
    files = tio._load_dict(os.path.join(d, "persist"))
    ref_files = rio._load_dict(os.path.join(d, "persist"))
    pd = tio.load_program_state(os.path.join(d, "model", "m"))
    ck = tio._load_pickle(os.path.join(ckpt.latest_checkpoint_dir(
        os.path.join(d, "ckpt")), "persistables.pkl"))
    assert sorted(files) == sorted(logical) == sorted(pd) == sorted(ck)
    for n, v in logical.items():
        for got in (files[n], ref_files[n], pd[n], ck[n]):
            assert got.shape == v.shape, n
            np.testing.assert_array_equal(got, v, err_msg=n)


@pytest.mark.parametrize("world,dcn", ZERO_WORLDS)
def test_zero_resume_repeats_the_steps(spawned, world, dcn):
    """A fresh executor and scope loaded from each save (per-var files,
    `fluid.save`, the checkpoint) hold logical values until their first
    run lays them out, then repeat the uninterrupted job's next steps
    bit for bit, on every rank."""
    _, ranks = _ranks(spawned, ("zero", world, dcn), "zero", world)
    for r in ranks:
        assert int(r["status_step"]) == runner.STEPS
        for how in ("persist", "model", "ckpt"):
            assert bool(r["loaded_logical." + how]), how
            np.testing.assert_array_equal(r["resumed." + how], r["after"])
        assert np.isfinite(r["after"]).all()


def test_agreement_on_truncated_rank(spawned):
    """Rank 1's newest checkpoint is truncated: under the launcher's
    ``PADDLE_CKPT_AGREE=1`` both ranks agree on step 1, the newest step
    intact on every rank (rank 0 alone would take step 2)."""
    _, ranks = _ranks(spawned, "agree", "agree", 2)
    assert [str(r["agree"]) for r in ranks] == ["1", "1"]
    assert [int(r["step"]) for r in ranks] == [1, 1]
