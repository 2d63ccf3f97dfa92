"""Fleet collective data parallelism in the port (paddle_tpu_torch.fleet,
fluid.CompiledProgram.with_data_parallel, distributed.launch) at two
ranks over gloo on the CPU against the JAX package's data parallelism on
a 2-device mesh of the virtual CPU devices.

One cohort of two ranks (`tests/torch_dp_runner.py`, started by the
port's launcher on free ports) runs every case in turn while this
process runs the reference's, each from the reference's startup state
(which rank 0 loads; rank 1 runs its own startup and takes rank 0's
state from the executor's first-run broadcast):
- the MLP of tests/test_parallel.py over SGD(0.1), 5 steps of a global
  batch of 64, through fleet (`distributed_optimizer(...).minimize`,
  against the reference's `transpile_collective(nranks=2)`) and through
  `with_data_parallel` (against the reference program on the mesh):
  the per-rank losses (shape (2,), one a replica, as the reference
  fetches them) within 1e-5 relative and every persistable after the
  steps within 1e-5;
- a conv + batch_norm net with `sync_batch_norm`: losses, parameters
  and running statistics within 1e-5;
- ResNet50 at full depth (`scan_stages`), 32 x 32, 10 classes, fp32,
  Momentum(3e-3, 0.9), a global batch of 8 (4 a rank, the batch of
  tests/test_torch_fluid_resnet.py; see `torch_dp_runner.RESNET`), from the
  zero-gamma start of tests/test_torch_fluid_resnet.py, 3 steps through
  fleet: losses within 1e-4, every parameter within 1e-3 in norm and
  rank 0's running statistics within 1e-4 of the reference's (which
  reads device 0's);
- random_seed 0 with dropout, through both entries, each rank starting
  from its own startup: the replicas end bit-equal and share rank 0's
  step seed.
Every case ends with the two replicas' parameters and optimizer states
bit-equal (running statistics stay per rank, as in the reference). The
transpiled fleet program equals the reference's op by op; the
launcher's environment equals the reference launcher's; a failing rank
fails the launch.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import paddle_tpu.fluid as rfluid
from paddle_tpu import fleet as rfleet
from paddle_tpu.core.scope import Scope as RScope
from paddle_tpu.distributed import launch as rlaunch
from paddle_tpu.models import resnet as rresnet
from paddle_tpu.parallel import env as renv
from paddle_tpu.parallel.sharded_update import unshard_scope_value

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import fleet as tfleet
from paddle_tpu_torch.distributed import launch as tlaunch

import torch_dp_runner as runner

pytestmark = pytest.mark.dist

CASES = ["mlp_fleet", "mlp_dp", "mlp_fleet_seed0", "mlp_dp_seed0",
         "cnn_sync_bn", "resnet", "fleet_util"]
MLP_RTOL, RESNET_LOSS_RTOL, RESNET_PARAM_RTOL, RESNET_STAT_RTOL = \
    1e-5, 1e-4, 1e-3, 1e-4


@pytest.fixture
def reference_env():
    """The reference's ring registry and global mesh, restored after
    (its transpile installs a 2-device mesh)."""
    saved = dict(renv._RINGS), renv.global_mesh()
    yield
    renv._RINGS.clear()
    renv._RINGS.update(saved[0])
    renv.set_global_mesh(saved[1])


def _startup_state(main, startup):
    exe = rfluid.Executor(rfluid.CPUPlace())
    scope = RScope()
    exe.run(startup, scope=scope)
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in main.list_vars() if v.persistable}


def _ref_run(main, loss, state, feed, steps, dp=False):
    """`steps` reference steps from `state` on the 2-device mesh: the
    losses (2 a step) and every persistable after."""
    prog = main
    if dp:
        main._mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
        prog = rfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
    exe = rfluid.Executor(rfluid.CPUPlace())
    scope = RScope()
    for n, v in state.items():
        scope.set_var(n, jnp.asarray(v))
    losses = np.stack([np.asarray(exe.run(
        prog, feed=feed, fetch_list=[loss.name], scope=scope)[0])
        for _ in range(steps)])
    # optimizer moments sharded over the mesh (the reference's ZeRO-1
    # update) back at their logical shapes
    return losses, {n: np.asarray(unshard_scope_value(
        main, n, np.asarray(scope.find_var(n)))) for n in state}


def _sgd(fluid, lr):
    return lambda: fluid.optimizer.SGDOptimizer(learning_rate=lr)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(reference results, the port's per-rank results) by case."""
    saved = dict(renv._RINGS), renv.global_mesh()
    d = str(tmp_path_factory.mktemp("fleet_dp"))
    ref_min = {
        "mlp": lambda loss: _sgd(rfluid, runner.MLP_LR)().minimize(loss),
        "cnn": runner.fleet_minimize(rfluid, rfleet,
                                     _sgd(rfluid, runner.CNN["lr"]),
                                     sync_bn=True, nranks=2),
        "resnet": runner.fleet_minimize(
            rfluid, rfleet, lambda: rfluid.optimizer.MomentumOptimizer(
                runner.RESNET["lr"], momentum=0.9), nranks=2)}
    built = {
        "mlp": runner.build_mlp(rfluid, 1234, ref_min["mlp"]),
        "cnn": runner.build_cnn(rfluid, ref_min["cnn"]),
        "resnet": runner.build_resnet(rfluid, rresnet, ref_min["resnet"])}
    states = {k: _startup_state(m, s) for k, (m, s, _) in built.items()}
    states["resnet"].update(
        (n, np.zeros_like(v)) for n, v in states["resnet"].items()
        if n.endswith("2c_bn_scale"))
    for k, st in states.items():
        np.savez(os.path.join(d, k + ".state.npz"), **st)
    proc = runner.start_cohort(CASES, d)
    try:
        ref = {}
        fleet_mlp = runner.build_mlp(rfluid, 1234, runner.fleet_minimize(
            rfluid, rfleet, _sgd(rfluid, runner.MLP_LR), nranks=2))
        ref["mlp_fleet"] = _ref_run(fleet_mlp[0], fleet_mlp[2],
                                    states["mlp"], runner.mlp_feed(),
                                    runner.MLP_STEPS)
        main, _, loss = built["mlp"]
        ref["mlp_dp"] = _ref_run(main, loss, states["mlp"],
                                 runner.mlp_feed(), runner.MLP_STEPS,
                                 dp=True)
        main, _, loss = built["cnn"]
        ref["cnn_sync_bn"] = _ref_run(main, loss, states["cnn"],
                                      runner.image_feed(runner.CNN),
                                      runner.CNN["steps"])
        main, _, loss = built["resnet"]
        ref["resnet"] = _ref_run(main, loss, states["resnet"],
                                 runner.image_feed(runner.RESNET),
                                 runner.RESNET["steps"])
    finally:
        rc, out = runner.wait_cohort(proc, d, timeout=300)
        renv._RINGS.clear()
        renv._RINGS.update(saved[0])
        renv.set_global_mesh(saved[1])
    assert rc == 0, out
    return ref, {c: runner.results(d, c) for c in CASES}, states


def _rel(a, b):
    a, b = np.asarray(a, "float64"), np.asarray(b, "float64")
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("case", ["mlp_fleet", "mlp_dp", "cnn_sync_bn"])
def test_small_models_match_reference(case, run):
    """Per-rank losses (2 a step) within 1e-5 and every persistable after
    the steps within 1e-5 of the reference's."""
    ref, port, _ = run
    want_losses, want_state = ref[case]
    rank0 = port[case][0]
    assert rank0["losses"].shape == want_losses.shape
    assert want_losses.shape[1:] == (2,)
    np.testing.assert_allclose(rank0["losses"], want_losses, rtol=MLP_RTOL)
    for n, want in want_state.items():
        np.testing.assert_allclose(rank0[n], want, rtol=MLP_RTOL,
                                   atol=1e-7, err_msg=n)


def test_resnet50_matches_reference(run):
    """ResNet50 fleet DP: losses within 1e-4, every parameter and
    velocity within 1e-3 in norm, rank 0's running statistics within
    1e-4 (in norm) of the reference's, whose read gives device 0's."""
    ref, port, states = run
    want_losses, want_state = ref["resnet"]
    rank0 = port["resnet"][0]
    np.testing.assert_allclose(rank0["losses"], want_losses,
                               rtol=RESNET_LOSS_RTOL)
    stats = [n for n in want_state if n.endswith(("_bn_mean", "_bn_var"))]
    # conv1's and, in each of the 4 stages, the first block's 4 and the
    # scanned blocks' 3 (stacked) batch norms: 29, 2 statistics each
    assert len(stats) == 58, len(stats)
    bad = {n: _rel(rank0[n], want_state[n]) for n in want_state
           if n not in stats
           and _rel(rank0[n], want_state[n]) > RESNET_PARAM_RTOL}
    assert not bad, bad
    bad = {n: _rel(rank0[n], want_state[n]) for n in stats
           if _rel(rank0[n], want_state[n]) > RESNET_STAT_RTOL}
    assert not bad, bad
    # training moved the parameters
    start = states["resnet"]
    assert not np.array_equal(rank0["conv1_weights"], start["conv1_weights"])
    # the for_test clone's run: one loss a rank, the per-rank running
    # statistics left as they were (and still differing across ranks)
    r1 = port["resnet"][1]
    for rank in (rank0, r1):
        assert rank["test_losses"].shape == (2,)
        assert bool(rank["stats_kept"])
    assert not np.array_equal(rank0["conv1_bn_mean"], r1["conv1_bn_mean"])


@pytest.mark.parametrize("case", CASES[:-1])
def test_replicas_are_bit_equal(case, run):
    """After the steps both ranks hold the same bits in every parameter
    and optimizer state, and fetched the same gathered losses; with
    random_seed 0 they started from different startups and share rank
    0's step seed. Batch-norm running statistics are per rank, as in
    the reference (they stay equal where sync_batch_norm averages the
    moments)."""
    _, port, _ = run
    r0, r1 = port[case]
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    keys = [k for k in r0 if k not in ("start_sum", "losses",
                                       "test_losses")]
    if case == "resnet":
        keys = [k for k in keys if not k.endswith(("_bn_mean", "_bn_var"))]
    assert len(keys) > 3
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    if case.endswith("seed0"):
        assert r0["start_sum"] != r1["start_sum"]
        assert int(r0["shared_seed"]) >= 0


def test_fleet_util_and_metrics(run):
    """fleet.util's all-reduce, all-gather (ranks of other lengths),
    broadcast, barrier and file shards, and fleet.metrics' sum and
    accuracy over the host gloo group."""
    _, port, _ = run
    for rank in port["fleet_util"]:
        np.testing.assert_array_equal(rank["all_reduce_sum"], [3.0, 4.0])
        np.testing.assert_array_equal(rank["all_reduce_max"], [2.0])
        np.testing.assert_array_equal(rank["all_gather0"], [0.0, 1.0])
        np.testing.assert_array_equal(rank["all_gather1"], [0.0, 1.0, 2.0])
        np.testing.assert_array_equal(rank["broadcast"], [10.0])
        np.testing.assert_array_equal(rank["metrics_sum"], [3.0])
        assert float(rank["metrics_acc"]) == 7.0 / 20.0
    r0, r1 = port["fleet_util"]
    assert list(r0["file_shard"]) == ["f0", "f1", "f2"]
    assert list(r1["file_shard"]) == ["f3", "f4"]


def test_rank_device(monkeypatch):
    """A rank's default card: FLAGS_selected_gpus when set, else its
    trainer id modulo the card count (one card: every rank on card 0)."""
    from paddle_tpu_torch.core import place

    monkeypatch.delenv("FLAGS_selected_gpus", raising=False)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    assert place.rank_device_index() == 0
    monkeypatch.setenv("FLAGS_selected_gpus", "3")
    assert place.rank_device_index() == 3
    assert place._current_expected_place() == place.CUDAPlace(3)


def _program_record(program):
    ops = []
    for block in program.blocks:
        for op in block.ops:
            attrs = {k: v for k, v in op.attrs.items()
                     if op.type != "backward"
                     or k in ("loss_name", "loss_scale")}
            ops.append((op.type, op.input_names, op.output_names, attrs))
    return ops


@pytest.mark.parametrize("sync_bn", [False, True])
def test_fleet_program_matches_transpiled_reference(sync_bn, monkeypatch,
                                                    reference_env):
    """At world 2 the port's `distributed_optimizer(...).minimize` gives
    the reference's `transpile_collective(nranks=2)` program: the same
    ops, slots and attrs, the backward's loss_scale 1/2, one c_allreduce_sum
    per gradient right after it, and batch_norm swapped for
    sync_batch_norm when asked."""
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    t_main = runner.build_cnn(tfluid, runner.fleet_minimize(
        tfluid, tfleet, _sgd(tfluid, 0.1), sync_bn=sync_bn))[0]
    r_main = runner.build_cnn(rfluid, runner.fleet_minimize(
        rfluid, rfleet, _sgd(rfluid, 0.1), sync_bn=sync_bn, nranks=2))[0]
    assert _program_record(t_main) == _program_record(r_main)
    types = [op.type for op in t_main.global_block().ops]
    bwd = types.index("backward")
    n_grads = len(t_main.global_block().ops[bwd].output_names["Grad"])
    assert types[bwd + 1:bwd + 1 + n_grads] == ["c_allreduce_sum"] * n_grads
    assert t_main.global_block().ops[bwd].attrs["loss_scale"] == 0.5
    assert ("sync_batch_norm" in types) == sync_bn
    assert t_main._data_parallel


def test_fleet_at_one_worker_leaves_the_program(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    main = runner.build_mlp(tfluid, 1, runner.fleet_minimize(
        tfluid, tfleet, _sgd(tfluid, 0.1)))[0]
    assert "c_allreduce_sum" not in [op.type
                                     for op in main.global_block().ops]
    assert not main._data_parallel


@pytest.mark.parametrize("knob", ["a_sync", "dgc", "localsgd", "elastic",
                                  "recompute", "lamb"])
def test_unported_strategy_knobs_raise(knob):
    st = tfleet.DistributedStrategy()
    setattr(st, knob, True)
    if knob == "recompute":
        # ported: the checkpoints are recorded on the backward op
        st.recompute_configs = {"checkpoints": ["x"]}
        main = runner.build_mlp(tfluid, 1, lambda loss:
                                tfleet.distributed_optimizer(
                                    _sgd(tfluid, 0.1)(), st).minimize(
                                        loss))[0]
        bop = next(op for op in main.global_block().ops
                   if op.type == "backward")
        assert bop.attrs["checkpoints"] == ["x"]
        return
    if knob == "lamb":
        # ported: the user optimizer is swapped for LAMB, with Adam's
        # betas and epsilon
        main = runner.build_mlp(tfluid, 1, lambda loss:
                                tfleet.distributed_optimizer(
                                    tfluid.optimizer.AdamOptimizer(
                                        0.01, beta1=0.8), st).minimize(
                                        loss))[0]
        lamb = [op for op in main.global_block().ops if op.type == "lamb"]
        assert lamb and all(op.attrs["beta1"] == 0.8 for op in lamb)
        return
    if knob == "elastic":
        # its checkpoint half is ported: the program is marked, and the
        # elastic restart it leads to (live_resize) still raises
        main = runner.build_mlp(tfluid, 1, lambda loss:
                                tfleet.distributed_optimizer(
                                    _sgd(tfluid, 0.1)(), st).minimize(loss))[0]
        assert main._elastic_cfg["save_steps"] == 100
        with pytest.raises(NotImplementedError, match="Queue 1 #"):
            tfluid.Executor(tfluid.CPUPlace()).live_resize(main)
        return
    with pytest.raises(NotImplementedError, match="Queue 1 #"):
        runner.build_mlp(tfluid, 1, lambda loss: tfleet.distributed_optimizer(
            _sgd(tfluid, 0.1)(), st).minimize(loss))


def test_strategy_prototxt_round_trip(tmp_path):
    """The port's strategy file loads in the reference and back."""
    st = tfleet.DistributedStrategy()
    st.sync_batch_norm = True
    st.amp_configs = {"custom_white_list": ["conv2d", "mul"]}
    path = str(tmp_path / "s.prototxt")
    st.save_to_prototxt(path)
    r = rfleet.DistributedStrategy().load_from_prototxt(path)
    assert r._fields() == st._fields()
    r.save_to_prototxt(path)
    assert tfleet.DistributedStrategy().load_from_prototxt(
        path)._fields() == st._fields()


def test_launcher_env_matches_reference():
    """The PADDLE_* contract of each worker equals the reference
    launcher's for the same endpoints; the port adds the rank's card and
    the backend."""
    eps = ["127.0.0.1:6170", "127.0.0.1:6171", "127.0.0.1:6172"]
    for tid in range(3):
        want = rlaunch._worker_env(eps, tid, 1, base_env={})
        got = tlaunch._worker_env(eps, tid, 1, base_env={}, backend="gloo",
                                  ndev=1)
        assert {k: v for k, v in got.items()
                if k != "PADDLE_DISTRI_BACKEND"} == dict(
            want, FLAGS_selected_gpus="0")
        assert got["PADDLE_DISTRI_BACKEND"] == "gloo"
    assert tlaunch._worker_env(eps, 2, 0, base_env={},
                               ndev=2)["FLAGS_selected_gpus"] == "0"


def test_failing_rank_fails_the_launch(tmp_path):
    """Rank 1 exits 3 while rank 0 waits for it in a barrier: the
    launcher stops rank 0 at once and exits 3, and each rank's output is
    in the log dir."""
    import time

    t0 = time.monotonic()
    proc = runner.start_cohort(["fail_rank1"], str(tmp_path))
    rc, out = runner.wait_cohort(proc, str(tmp_path), timeout=100)
    assert rc == 3, out
    assert time.monotonic() - t0 < 60, out
    assert "worker 1 exited with 3" in out
    assert {"workerlog.0", "workerlog.1"} <= set(os.listdir(tmp_path))


def test_spawn_starts_a_world_and_fails_fast(tmp_path):
    """`distributed.spawn` starts 2 gloo ranks with the launcher's
    contract; a rank that fails (rank 1 exits 5; rank 0, waiting for it
    in a barrier, then fails too, whichever the join sees first) fails
    the spawn at once, and no process is left."""
    import time

    from paddle_tpu_torch import distributed

    distributed.spawn(runner.spawn_probe, (str(tmp_path),), nprocs=2,
                      backend="gloo", timeout=60)
    for r in range(2):
        got = np.load(str(tmp_path / ("spawn.rank%d.npz" % r)))
        assert (int(got["rank"]), int(got["world"]), str(got["backend"])) \
            == (r, 2, "gloo")
        np.testing.assert_array_equal(got["sum"], [2.0])
    t0 = time.monotonic()
    sc = distributed.spawn(runner.spawn_probe, (str(tmp_path), 1),
                           nprocs=2, backend="gloo", join=False)
    with pytest.raises(RuntimeError, match="exited with code"):
        sc.join(60)
    assert time.monotonic() - t0 < 45
    assert not any(p.is_alive() for p in sc.processes)


def test_unported_launch_options_raise():
    """`--num_pods` is ported (the pods of a hybrid world); the options
    of elastic restarts, tensor parallelism and the hang watch still
    raise naming their item."""
    args = tlaunch._parse_args(["--num_pods", "2", "train.py"])
    assert args.num_pods == 2 and tlaunch._launch_num_pods(args, 4) == 2
    for opt in (["--mp_degree", "2"], ["--min_ranks", "1"],
                ["--hang_timeout", "5"]):
        with pytest.raises(NotImplementedError, match="Queue 1 #10"):
            tlaunch._parse_args(opt + ["train.py"])
