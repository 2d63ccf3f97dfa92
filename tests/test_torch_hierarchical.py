"""Hierarchical (dcn x ici) data parallelism of the port
(paddle_tpu_torch.parallel.env's hybrid mesh, the sharded update's
cross-pod sum, the launcher's pods, fleet's hierarchical knob), the
gradient exchange launched from the backward (`Executor.overlap_report`)
and `Executor.warmup(background=True)`, against the JAX package's.

In this process: `create_hybrid_mesh`'s fallbacks, `dcn_replicas`, the
launcher's pod topology and fleet's knob, each beside the reference's;
the background warmup against the foreground one.

Ranks: one spawn of 4 gloo ranks on a (dcn 2, ici 2) world and one of 4
flat ranks (`tests/torch_dp_runner.py hier_ranks`), and one process of
the reference's hierarchical sharded update on a (2, 2) mesh of 4
virtual CPU devices (`reference_hier`), all from the port's startup
states and started at the module's first test. Tolerances:
- the port's hierarchical sharded update against the reference's
  (SGD, Momentum, Adam with L2 decay and fused ops, bucketed; Adam one
  collective a variable; fleet's explicit sync): losses and every
  persistable at its logical shape within fp32 rtol 1e-5; Adam at bf16
  AMP O2 with its masters sharded: losses within bf16 rtol 1e-2 and each
  kind of state (masters, first and second moments, the rest) as one
  vector within 2e-2 in norm, the bounds of the flat ZeRO BERT test (the
  two frameworks round a bf16 gradient differently; measured 1.8e-4 and
  2.9e-3);
- sharded against replicated on the hybrid world, and bucketed (the
  exchange launched from the backward) against a cap of 0 (one exchange
  after the backward): bit-equal, and the ranks hold the same bits (a
  pod sums two values, then the pods sum two: the order is fixed);
- hierarchical against flat: the fp32 losses within 2 ulps (the sum's
  association differs: pods first); at bf16 AMP the gradients are
  summed in bf16, where that association moves a gradient by a bf16
  step, so the AMP MLP is held to the bf16 rtol 1e-2;
- a rank holds 1/ici = 1/2 of the sharded state, up to the padding.
"""
import argparse
import json
import os
import signal

import numpy as np
import pytest

import paddle_tpu.fluid as rfluid
from paddle_tpu import fleet as rfleet
from paddle_tpu.distributed import launch as rlaunch
from paddle_tpu.parallel import env as renv
from paddle_tpu.utils import flags as rflags

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import distributed, fleet as tfleet
from paddle_tpu_torch.core.scope import dump_numpy_state
from paddle_tpu_torch.distributed import launch as tlaunch
from paddle_tpu_torch.parallel import env as tenv
from paddle_tpu_torch.utils import flags as tflags

import torch_dp_runner as runner

RTOL, BF16_RTOL, BF16_STATE_RTOL = 1e-5, 1e-2, 2e-2
DCN = runner.HIER_DCN


@pytest.fixture
def flags_restored():
    keys = ["FLAGS_tpu_dcn_replicas", "FLAGS_tpu_sharded_weight_update",
            "FLAGS_tpu_comm_bucket_mb"]
    saved = rflags.get_flags(keys), tflags.get_flags(keys)
    yield
    rflags.set_flags(saved[0])
    tflags.set_flags(saved[1])


# -- in this process ---------------------------------------------------------

def test_hybrid_mesh_fallbacks_match_reference():
    """No hybrid mesh at one pod; a pod count that does not divide the
    world warns and falls back to the flat world, never a wrong mesh;
    the factorization of 4 ranks in 2 pods is the reference's."""
    for pkg in (renv, tenv):
        assert pkg.create_hybrid_mesh(nranks=4, dcn=1) is None
        with pytest.warns(UserWarning, match="not divisible"):
            assert pkg.create_hybrid_mesh(nranks=6, dcn=4) is None
        assert pkg.mesh_hierarchy(None) is None
    ref = renv.create_hybrid_mesh(nranks=4, dcn=2)
    assert tenv.hybrid_shape(4, 2) == (ref.shape["dcn"], ref.shape["ici"])
    assert (tenv.DCN_AXIS, tenv.ICI_AXIS, tenv.MODEL_AXIS) == (
        renv.DCN_AXIS, renv.ICI_AXIS, renv.MODEL_AXIS)
    with pytest.raises(NotImplementedError, match="#10"):
        tenv.create_hybrid_mesh(nranks=4, dcn=2, mp=2)


def test_dcn_replicas_flag_and_env(monkeypatch, flags_restored):
    monkeypatch.delenv("PADDLE_NUM_PODS", raising=False)
    for flags, env, want in ((0, None, 1), (0, "2", 2), (4, "2", 4)):
        if env is not None:
            monkeypatch.setenv("PADDLE_NUM_PODS", env)
        rflags.set_flags({"FLAGS_tpu_dcn_replicas": flags})
        tflags.set_flags({"FLAGS_tpu_dcn_replicas": flags})
        assert tenv.dcn_replicas() == renv.dcn_replicas() == want


def test_launch_pods_match_reference(monkeypatch, capsys):
    """`--num_pods` and PADDLE_NUM_PODS give each worker the reference's
    PADDLE_NUM_PODS and PADDLE_POD_ID (contiguous blocks of ranks); a
    flat cohort pops an inherited topology; a count that does not divide
    the ranks warns and runs flat."""
    eps = ["127.0.0.1:%d" % (6170 + i) for i in range(4)]
    inherited = {"PADDLE_NUM_PODS": "3", "PADDLE_POD_ID": "1"}
    pods = ("PADDLE_NUM_PODS", "PADDLE_POD_ID")
    for npods in (1, 2, 4):
        for tid in range(4):
            want = rlaunch._worker_env(eps, tid, 0, base_env=inherited,
                                       npods=npods)
            got = tlaunch._worker_env(eps, tid, 0, base_env=inherited,
                                      ndev=1, npods=npods)
            assert {k: got.get(k) for k in pods} == \
                {k: want.get(k) for k in pods}
    monkeypatch.delenv("PADDLE_NUM_PODS", raising=False)
    for num_pods, env, world in ((2, None, 4), (3, None, 4), (0, "2", 4),
                                 (0, None, 4), (4, None, 4)):
        if env is not None:
            monkeypatch.setenv("PADDLE_NUM_PODS", env)
        args = argparse.Namespace(num_pods=num_pods)
        assert tlaunch._launch_num_pods(args, world) == \
            rlaunch._launch_num_pods(args, world)
    assert "not divisible into 3 pods" in capsys.readouterr().err


def _knob_program(fluid, fleet, st):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(input=x, size=2))
        fleet.distributed_optimizer(fluid.optimizer.SGDOptimizer(0.1),
                                    st).minimize(loss)
    return main


def test_fleet_hierarchical_knob(monkeypatch, flags_restored):
    """`use_hierarchical_allreduce` with `hierarchical_allreduce_inter_nranks`
    pods sets FLAGS_tpu_dcn_replicas (an explicit flag wins), and the
    transpiled program of a 4-rank world shards over "ici" with "dcn"
    across pods, as the reference's knob does."""
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    st = tfleet.DistributedStrategy()
    st.use_hierarchical_allreduce = True
    st.hierarchical_allreduce_inter_nranks = 2
    tflags.set_flags({"FLAGS_tpu_dcn_replicas": 0})
    main = _knob_program(tfluid, tfleet, st)
    assert tflags.get_flag("FLAGS_tpu_dcn_replicas") == 2
    assert (main._dp_axis, main._dcn_axis) == ("ici", "dcn")
    tflags.set_flags({"FLAGS_tpu_dcn_replicas": 4})
    _knob_program(tfluid, tfleet, st)
    assert tflags.get_flag("FLAGS_tpu_dcn_replicas") == 4
    # the reference's knob under the same strategy
    rst = rfleet.DistributedStrategy()
    rst.use_hierarchical_allreduce = True
    rst.hierarchical_allreduce_inter_nranks = 2
    rflags.set_flags({"FLAGS_tpu_dcn_replicas": 0})
    saved = dict(renv._RINGS), renv.global_mesh()
    try:
        with rfluid.program_guard(rfluid.Program(), rfluid.Program()), \
                rfluid.unique_name_guard():
            x = rfluid.layers.data(name="x", shape=[8], dtype="float32")
            loss = rfluid.layers.mean(rfluid.layers.fc(input=x, size=2))
            rfleet.CollectiveOptimizer(rfluid.optimizer.SGDOptimizer(0.1),
                                       rst).minimize(loss)
            rmain = loss.block.program
    finally:
        renv._RINGS.clear()
        renv._RINGS.update(saved[0])
        renv.set_global_mesh(saved[1])
    assert rflags.get_flag("FLAGS_tpu_dcn_replicas") == 2
    assert (rmain._dp_axis, rmain._dcn_axis) == (main._dp_axis,
                                                 main._dcn_axis)


def test_warmup_in_background_matches_foreground():
    """`warmup(background=True)` returns the "paddle-tpu-warmup" daemon
    thread, whose report equals a foreground warmup's of a fresh
    executor; the background one leaves its executor's cache, the scope
    and the program's seed counter as they were."""
    reports, names = [], None
    for background in (False, True):
        main, startup, loss = runner.build_zero_mlp(tfluid, "adam")
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        before = dump_numpy_state(scope, names)
        counter, blocks = main._seed_counter, exe.compiled_blocks()
        shapes = [{"img": (8, 32), "label": (8, 1)},
                  {"img": (16, 32), "label": (16, 1)}, {"nope": (1,)}]
        got = exe.warmup(main, shapes=shapes, fetch_list=[loss],
                         scope=scope, background=background)
        if background:
            assert got.name == "paddle-tpu-warmup" and got.daemon
            got.join(60)
            assert not got.is_alive()
            got = got.warmup_report
            assert exe.compiled_blocks() == blocks
        reports.append(got)
        assert main._seed_counter == counter
        after = dump_numpy_state(scope, names)
        for n in names:
            np.testing.assert_array_equal(before[n], after[n], err_msg=n)
    assert reports[1] == reports[0]
    assert len(reports[0]["compiled"]) == 2 and len(reports[0]["skipped"]) \
        == 1


# -- ranks -------------------------------------------------------------------

def _startup_state(main, startup):
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    return dump_numpy_state(scope, [v.name for v in main.list_vars()
                                    if v.persistable])


CASES = list(runner.HIER_MLPS) + ["size1", "cnn"]


@pytest.fixture(scope="module")
def hier_launch(tmp_path_factory):
    """The start states (the port's startups of a 4-rank program), the
    reference's process and the two spawns, started at the module's
    first test that needs them."""
    d = str(tmp_path_factory.mktemp("hier"))
    saved = os.environ.get("PADDLE_TRAINERS_NUM")
    os.environ["PADDLE_TRAINERS_NUM"] = str(runner.HIER_WORLD)
    try:
        for case in CASES:
            runner.save_state(d, "zero_" + case, _startup_state(
                *runner._hier_build(tfluid, case)[:2]))
    finally:
        if saved is None:
            os.environ.pop("PADDLE_TRAINERS_NUM")
        else:
            os.environ["PADDLE_TRAINERS_NUM"] = saved
    ref = runner.start_reference_hier(d)
    ranks = {dcn: distributed.spawn(runner.hier_ranks, (d, dcn),
                                    nprocs=runner.HIER_WORLD,
                                    backend="gloo", join=False)
             for dcn in (DCN, 1)}
    try:
        yield d, ranks, ref
    finally:
        for sc in ranks.values():
            try:
                sc.join(1)
            except (RuntimeError, TimeoutError):
                pass  # hier_runs reports a failed rank
        if ref.poll() is None:
            os.killpg(ref.pid, signal.SIGKILL)
            ref.communicate()


@pytest.fixture(scope="module")
def hier_runs(hier_launch):
    """(the reference's results by (case, variant), the port's per-rank
    results by pod count), once every process has finished."""
    d, ranks, ref = hier_launch
    for sc in ranks.values():
        sc.join(180)
    rc, out = runner.wait_cohort(ref, d, timeout=180)
    assert rc == 0, out
    want = {}
    for name in os.listdir(d):
        if name.startswith("ref_hier_"):
            case, variant = name[len("ref_hier_"):-len(".npz")].split(".")
            with np.load(os.path.join(d, name)) as f:
                got = dict(f)
            want[case, variant] = (got.pop("losses"), {
                k[len("state."):]: v for k, v in got.items()})
    port = {}
    for dcn in (DCN, 1):
        port[dcn] = []
        for r in range(runner.HIER_WORLD):
            with np.load(os.path.join(d, "hier%d.rank%d.npz" % (dcn, r))) \
                    as f:
                port[dcn].append(dict(f))
    return want, port


def _run(rank, case, variant):
    pre = "%s.%s." % (case, variant)
    state = {k[len(pre) + 6:]: v for k, v in rank.items()
             if k.startswith(pre + "state.")}
    return rank[pre + "losses"], state


def _json(rank, key):
    return json.loads(str(rank[key]))


def test_hybrid_world_layout(hier_runs):
    """FLAGS_tpu_dcn_replicas 2 makes the world of 4 a (dcn 2, ici 2)
    mesh, pods of contiguous ranks, its hierarchy the reference's; the
    program shards over "ici"; at 1 the world stays flat."""
    _, port = hier_runs
    want = list(renv.mesh_hierarchy(renv.create_hybrid_mesh(nranks=4,
                                                            dcn=DCN)))
    for r, rank in enumerate(port[DCN]):
        mesh = _json(rank, "mesh")
        assert mesh["axis_names"] == ["dcn", "ici"]
        assert mesh["shape"] == {"dcn": 2, "ici": 2}
        assert mesh["coords"] == [r // 2, r % 2]
        assert mesh["hierarchy"] == want == ["dcn", "ici", 2, 2]
        assert mesh["ici"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert mesh["dcn"] == [r % 2, r % 2 + 2]
        assert (mesh["dp_axis"], mesh["dcn_axis"]) == ("ici", "dcn")
        plan = _json(rank, "sgd.on.plan")
        assert (plan["ndev"], plan["dcn_axis"], plan["dcn_size"],
                plan["world"]) == (2, "dcn", 2, 4)
    for rank in port[1]:
        assert _json(rank, "mesh") is None
        assert _json(rank, "sgd.on.plan")["dcn_axis"] is None


def test_feed_splits_over_both_axes(hier_runs):
    """A global batch of 64 splits over (dcn, ici), dcn-major: rank r of
    the pair keeps rows [16 r, 16 r + 16); `feed_sharding` names both
    axes (the reference's P(("dcn", "ici"))), a flat world "dp"."""
    _, port = hier_runs
    for r, rank in enumerate(port[DCN]):
        assert rank["rows"].tolist() == [r, 4, 16 * r, 16 * r + 16]
        assert _json(rank, "spec") == [["dcn", "ici"]]
        assert _json(port[1][r], "spec") == ["dp"]


def test_collective_ops_on_hybrid_world(hier_runs):
    """Every collective op of a data-parallel program on ring 0 of the
    hybrid world runs over the (dcn, ici) pair (sums within the pod, then
    across pods) and gives the flat world's values: exactly, as these
    inputs sum exactly in any order, but the legacy product
    (exp(sum(log)), within 1e-6)."""
    _, port = hier_runs
    legacy_prod = runner.COLLECTIVE_CASES.index(
        ("allreduce", {"reduce_type": 3}, "pos"))
    for hier, flat in zip(port[DCN], port[1]):
        assert {"all_reduce.ici", "all_reduce.dcn"} <= set(
            hier["coll.kinds"].tolist())
        assert not any("." in k for k in flat["coll.kinds"].tolist())
        for k, v in flat.items():
            if not k.startswith("coll.") or k == "coll.kinds":
                continue
            if k == "coll.op%d" % legacy_prod:
                np.testing.assert_allclose(hier[k], v, rtol=1e-6)
            else:
                np.testing.assert_array_equal(hier[k], v, err_msg=k)


REF_CASES = [(c, "on") for c in runner.HIER_MLPS] + [
    ("adam_reg_fused", "cap0"), ("size1", "on")]


@pytest.mark.parametrize("case,variant", REF_CASES)
def test_hierarchical_zero_matches_reference(case, variant, hier_runs):
    """The port's sharded update on the hybrid world against the
    reference's on its (2, 2) mesh: the losses (one a rank a step) and
    every persistable after the steps at its logical shape."""
    want, port = hier_runs
    want_losses, want_state = want[case, variant]
    rank0 = port[DCN][0]
    plan = _json(rank0, "%s.%s.plan" % (case, variant))
    assert plan["dcn_axis"] == "dcn" and plan["ndev"] == 2
    assert bool(plan["buckets"]) == (variant == "on")
    if case == "adam_amp":
        assert plan["masters"] > 0
    if case == "size1":
        assert plan["explicit_sync"]
    losses, state = _run(rank0, case, variant)
    assert losses.shape == want_losses.shape == (runner.ZERO_STEPS, 4)
    np.testing.assert_allclose(losses, want_losses,
                               rtol=BF16_RTOL if case == "adam_amp" else RTOL)
    assert sorted(state) == sorted(want_state)
    if case == "adam_amp":
        kinds = {}
        for n in want_state:
            kinds.setdefault("master" if n.endswith("@MASTER") else
                             "moment1" if "moment1" in n else
                             "moment2" if "moment2" in n else "other",
                             []).append(n)
        assert set(kinds) == {"master", "moment1", "moment2", "other"}
        for kind, names in kinds.items():
            got, ref = (np.concatenate([np.asarray(
                st[n], "float64").ravel() for n in names])
                for st in (state, want_state))
            rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
            assert rel <= BF16_STATE_RTOL, (kind, rel)
        return
    for n, v in want_state.items():
        np.testing.assert_allclose(np.asarray(state[n], "float64"),
                                   np.asarray(v, "float64"), rtol=RTOL,
                                   atol=1e-7, err_msg=n)


HIER_CASES = [c for c in CASES if c != "cnn"]


@pytest.mark.parametrize("case", HIER_CASES)
def test_hierarchical_zero_equals_replicated(case, hier_runs):
    """On the hybrid world the sharded update equals the replicated one
    (a sum within the pod, then across pods, then / world) bit for bit,
    and so does one collective a variable after the backward (cap 0)
    against the buckets launched from it; the ranks hold the same
    bits."""
    _, port = hier_runs
    rank0 = port[DCN][0]
    on = _run(rank0, case, "on")
    for variant in runner.hier_variants(case, DCN)[1:]:
        got = _run(rank0, case, variant)
        np.testing.assert_array_equal(got[0], on[0], err_msg=variant)
        assert sorted(got[1]) == sorted(on[1])
        for n, v in on[1].items():
            np.testing.assert_array_equal(got[1][n], v,
                                          err_msg="%s %s" % (variant, n))
    for rank in port[DCN][1:]:
        for k, v in rank0.items():
            if k.startswith(case + ".") and not k.endswith(
                    ("local_bytes", "overlap")):
                np.testing.assert_array_equal(rank[k], v, err_msg=k)


def _max_ulp32(a, b):
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max())


@pytest.mark.parametrize("case", HIER_CASES)
def test_hierarchical_vs_flat_within_two_ulps(case, hier_runs):
    """Pods first changes only the sum's association: the losses of the
    hybrid world lie within 2 fp32 ulps of the flat world's (within the
    bf16 rtol for the AMP MLP, whose gradients are summed in bf16)."""
    _, port = hier_runs
    hier, flat = (_run(port[dcn][0], case, "on")[0] for dcn in (DCN, 1))
    if case == "adam_amp":
        np.testing.assert_allclose(hier, flat, rtol=BF16_RTOL)
        np.testing.assert_array_equal(hier[0], flat[0])
    else:
        assert _max_ulp32(hier, flat) <= 2


@pytest.mark.parametrize("case", [c for c in HIER_CASES if c != "sgd"])
def test_state_is_sharded_within_the_pod(case, hier_runs):
    """A rank holds 1/ici = 1/2 of the sharded moments and masters (the
    same shards in both pods), against 1/4 on the flat world; the bytes
    `CompiledBlock.info()` reports are the scope's."""
    _, port = hier_runs
    for dcn, shards in ((DCN, 2), (1, 4)):
        for rank in port[dcn]:
            pre = "%s.on." % case
            logical = int(rank[pre + "info.opt_state_logical_bytes"])
            per = int(rank[pre + "info.opt_state_per_replica_bytes"])
            nvars = int(rank[pre + "info.opt_state_sharded_vars"])
            assert nvars > 0 and int(rank[pre + "local_bytes"]) == per
            assert logical / shards <= per < logical / shards + 16 * nvars


def test_sync_batch_norm_on_hybrid_world(hier_runs):
    """fleet's sync_batch_norm on the hybrid world syncs its moments over
    the (dcn, ici) pair (the reference's axis name): its losses are
    finite and lie within 1e-5 of the flat world's."""
    _, port = hier_runs
    assert _json(port[DCN][0], "cnn.on.bn_axis") == [["dcn", "ici"]]
    assert _json(port[1][0], "cnn.on.bn_axis") == ["dp"]
    hier, flat = (_run(port[dcn][0], "cnn", "on") for dcn in (DCN, 1))
    assert np.isfinite(hier[0]).all()
    np.testing.assert_allclose(hier[0], flat[0], rtol=RTOL)
    for n, v in flat[1].items():
        np.testing.assert_allclose(hier[1][n], v, rtol=1e-4, atol=1e-6,
                                   err_msg=n)


@pytest.mark.parametrize("dcn", [DCN, 1])
def test_overlap_report(dcn, hier_runs):
    """With buckets each reduce-scatter is launched from the backward:
    bucket 0 has backward left to run after it, in production order
    (earlier buckets more), the last none; with a cap of 0 the exchange
    follows the last gradient and every collective shows 0. Replicated,
    each gradient's all-reduce launches from the backward too."""
    _, port = hier_runs
    for rank in port[dcn]:
        rep = _json(rank, "adam_reg_fused.on.overlap")
        rs = rep["collectives"]
        assert rep["launched_in_backward"] and not rep["captured"]
        assert rep["n_buckets"] == len(rs) >= 2
        assert [c["bucket"] for c in rs] == list(range(len(rs)))
        after = [c["backward_after"] for c in rs]
        assert after[0] > 0 and after[-1] == 0
        assert after == sorted(after, reverse=True)
        assert rep["overlappable_reduce_scatters"] >= 1
        assert rs[0]["starts_before_final_backward"]
        if dcn == 1:
            continue
        rep0 = _json(rank, "adam_reg_fused.cap0.overlap")
        assert not rep0["launched_in_backward"] and rep0["n_buckets"] == 0
        assert rep0["n_backward"] > 0 and len(rep0["collectives"]) == 4
        assert all(c["backward_after"] == 0 and c["bucket"] is None
                   for c in rep0["collectives"])
        off = _json(rank, "adam_reg_fused.off.overlap")
        assert {c["kind"] for c in off["collectives"]} == {"all_reduce"}
        assert off["collectives"][0]["backward_after"] > 0
    # fleet's explicit in-place sums launch from the backward as well
    rep = _json(port[dcn][0], "size1.on.overlap")
    assert rep["launched_in_backward"] and rep["n_buckets"] >= 1
    assert {c["kind"] for c in rep["collectives"]} == {"reduce_scatter"}
