"""The sharded weight update of data-parallel fluid programs (ZeRO-1,
paddle_tpu_torch.parallel.sharded_update and .planner) against the JAX
package's.

Plan parity, with no ranks: the same program is built in both packages
and both planners run with the same world size (2 and 4) and a bucket
cap small enough for several buckets (`torch_dp_runner.ZERO_CAP_MB`):
the 31-wide MLP of tests/test_sharded_update.py under Adam with L2
decay and fused ops, under Momentum and under SGD; fleet's conv + batch
norm net with its explicit `c_allreduce_sum` ops; BERT-tiny at bf16 AMP
O2 with fused Adam. The plans must be equal entry for entry: the buckets
and their gradients in order, the sharded state with its padding, the
deferred gathers, the AMP masters, the explicit-sync targets and the
kinds of the fallback trail; a program the reference declines (a grad
read by an op with no shard-aware rule) is declined by the port too, and
a moment read outside its optimizer op stays replicated in both.

Ranks: one spawn of 2 and one of 4 gloo ranks on the CPU
(`tests/torch_dp_runner.py zero_ranks`) run MLPs with the sharded update
on (buckets) and off (at 2 ranks all three, also on with a cap of 0,
a 1-layer BERT at bf16 AMP O2 with fused Adam and the reference's
single-element-parameter head through fleet, on and off; at 4 the Adam
MLP); two processes run the reference's sharded update on meshes of 2
and 4 virtual CPU devices from the same start states (the port's
startups), one the BERT, the other the MLPs and the head. The ranks and
those processes start at the module's first test, so the plan tests run
meanwhile.
Tolerances:
- the port's sharded update against the reference's: losses within fp32
  rtol 1e-5, every persistable (at its logical shape) within 1e-5;
  BERT's first loss within bf16 rtol 1e-2 and its state after that
  step, each kind (masters, first and second moments, the rest) as one
  vector, within `BERT_STATE_RTOL` in norm (the reference's BERT runs
  one step: its second compiles again);
- on against off and bucketed against a cap of 0: bit-equal at 2 ranks
  (a gloo sum of two is exact, and each element is summed and divided
  as in the all-reduce it replaces); at 4 ranks gloo's all-reduce sums
  an element in an order that depends on where it sits in the buffer,
  so the sharded and replicated runs may differ in the last bit: within
  `WORLD4_RTOL` (measured largest 1.7e-7 relative, off and cap 0 alike);
- a rank's scope holds the flat 1/N slices of the moments and masters,
  as `CompiledBlock.info()` reports, and the ranks agree bit for bit.
"""
import functools
import os
import signal

import numpy as np
import pytest

import paddle_tpu.fluid as rfluid
from paddle_tpu import fleet as rfleet
from paddle_tpu.fluid.contrib import mixed_precision as rmp
from paddle_tpu.models import bert as rbert
from paddle_tpu.parallel import env as renv
from paddle_tpu.parallel import sharded_update as rsu
from paddle_tpu.utils import flags as rflags

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import distributed, fleet as tfleet
from paddle_tpu_torch.core.scope import dump_numpy_state
from paddle_tpu_torch.fluid.contrib import mixed_precision as tmp
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.parallel import planner as tplanner
from paddle_tpu_torch.parallel import sharded_update as tsu
from paddle_tpu_torch.utils import flags as tflags

import torch_dp_runner as runner

RTOL, BF16_RTOL, WORLD4_RTOL = 1e-5, 1e-2, 1e-6
#: BERT's state after its first AMP Adam step, each kind relative in
#: norm (the second moment squares the bf16 gradient's error; measured
#: largest 8.4e-3)
BERT_STATE_RTOL = 2e-2
WORLDS = (2, 4)


@pytest.fixture
def flags_restored():
    """Both packages' ZeRO flags, restored after."""
    keys = ("FLAGS_tpu_sharded_weight_update", "FLAGS_tpu_comm_bucket_mb")
    saved = (rflags.get_flags(list(keys)), tflags.get_flags(list(keys)))
    yield
    rflags.set_flags(saved[0])
    tflags.set_flags(saved[1])


def _set_cap(mb):
    rflags.set_flags({"FLAGS_tpu_comm_bucket_mb": mb})
    tflags.set_flags({"FLAGS_tpu_comm_bucket_mb": mb})


# -- plan parity ---------------------------------------------------------------

def _momentum(fluid):
    return lambda: fluid.optimizer.MomentumOptimizer(0.1, momentum=0.9)


@functools.lru_cache(maxsize=None)
def _built(case, fluid):
    """`case`'s program for every world size, built once a module (the
    planners only read it, and reset its fallback trail)."""
    if case in runner.ZERO_MLPS:
        return runner.build_zero_mlp(fluid, **runner.ZERO_MLPS[case])[0]
    mp, bert = (rmp, rbert) if fluid is rfluid else (tmp, tbert)
    return runner.build_zero_bert(fluid, mp, bert, bert.BertConfig.tiny(),
                                  seq=32, scan=True)[0]


def _build(case, fluid, ndev, monkeypatch):
    """`case`'s program built with `fluid` (either package): main."""
    if case in runner.ZERO_MLPS or case == "bert_tiny_amp":
        return _built(case, fluid)
    if case == "fleet_cnn":
        if fluid is rfluid:
            return runner.build_cnn(fluid, runner.fleet_minimize(
                fluid, rfleet, _momentum(fluid), nranks=ndev))[0]
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", str(ndev))
        return runner.build_cnn(fluid, runner.fleet_minimize(
            fluid, tfleet, _momentum(fluid)))[0]
    # the reference's two declines, after an Adam MLP: an op reading a
    # gradient after the update, or a moment read outside its op
    main = runner.build_zero_mlp(fluid, "adam")[0]
    block = main.global_block()
    with fluid.program_guard(main):
        read = "fc_0.w_0@GRAD" if case == "declined" else \
            "AdamOptimizer_0_fc_0.w_0_moment1_0"
        fluid.layers.mean(block.var(read))
    return main


def _record(plan):
    if plan is None:
        return None
    return {
        "buckets": [[(e.grad, e.param, e.param_out, e.shape, str(e.dtype),
                      e.numel, e.padded, e.topo) for e in b.entries]
                    for b in plan.buckets],
        "sharded": {n: (i.shape, str(i.dtype), i.numel, i.padded)
                    for n, i in plan.sharded_state.items()},
        "defer_gather": sorted(plan.defer_gather),
        "master_of": plan.master_of,
        "rs_targets": sorted(plan.rs_targets),
        "grad_names": sorted(plan.grad_names),
        "explicit_sync": plan.explicit_sync,
        "opt_ops": len(plan.opt_op_ids),
        "bucket_cap": plan.bucket_cap,
        "ndev": plan.ndev,
    }


def _kinds(program):
    return [e["kind"] for e in program._sharded_update_fallback]


@pytest.mark.parametrize("ndev", WORLDS)
@pytest.mark.parametrize("case", sorted(runner.ZERO_MLPS) + [
    "fleet_cnn", "bert_tiny_amp", "declined", "degraded"])
def test_plan_matches_reference(case, ndev, flags_restored, monkeypatch):
    _set_cap(runner.ZERO_CAP_MB)
    saved = dict(renv._RINGS), renv.global_mesh()
    try:
        r_main = _build(case, rfluid, ndev, monkeypatch)
    finally:
        renv._RINGS.clear()
        renv._RINGS.update(saved[0])
        renv.set_global_mesh(saved[1])
    t_main = _build(case, tfluid, ndev, monkeypatch)
    want = rsu.plan_sharded_update(r_main, r_main.global_block(), ndev,
                                   "dp")
    got = tplanner.plan_parallel(t_main, t_main.global_block(),
                                 _FakeRing(ndev)).shard_plan
    assert _record(got) == _record(want)
    assert _kinds(t_main) == _kinds(r_main)
    if case == "declined":
        assert got is None and _kinds(t_main) == ["declined"]
        return
    assert got is not None
    if case == "degraded":
        assert "state_degraded" in _kinds(t_main)
        assert "AdamOptimizer_0_fc_0.w_0_moment1_0" not in \
            got.sharded_state
    if case != "sgd":
        assert got.sharded_state
    if case != "degraded":
        assert len(got.buckets) > 1
    if case == "fleet_cnn":
        assert got.explicit_sync and got.rs_targets
    if case == "bert_tiny_amp":
        assert got.master_of and set(got.master_of.values()) <= set(
            got.sharded_state)


class _FakeRing:
    """A stand-in for a world of `size` ranks (planning reads its size
    only)."""

    def __init__(self, size):
        self.size, self.rank = size, 0


def test_one_rank_or_flag_off_plans_nothing(flags_restored):
    main = runner.build_zero_mlp(tfluid, "adam")[0]
    assert tsu.plan_sharded_update(main, main.global_block(), 1) is None
    tflags.set_flags({"FLAGS_tpu_sharded_weight_update": False})
    assert tsu.plan_sharded_update(main, main.global_block(), 2) is None


def test_later_items_raise():
    """The hybrid (dcn, ici) plan (#7.5) is built: shards over the pod,
    a mean over the whole world; tensor parallelism (#10) and dygraph
    (#8) still raise naming their items."""
    main = runner.build_zero_mlp(tfluid, "adam")[0]
    block = main.global_block()
    plan = tsu.plan_sharded_update(main, block, 2, dcn_axis="dcn",
                                   dcn_size=2)
    assert plan is not None and plan.sharded_state and plan.buckets
    assert (plan.ndev, plan.dcn_axis, plan.dcn_size, plan.world) == \
        (2, "dcn", 2, 4)
    with pytest.raises(NotImplementedError, match="#10"):
        tsu.ShardInfo("w", (4, 4), "float32", 2, tp_dim=0, mp=2)
    with pytest.raises(NotImplementedError, match="#8"):
        tsu.eager_accumulator_sharding((8, 4))


def test_layout_helpers_match_reference():
    """A rank's slice and the unshard of the gathered buffer, against the
    reference's flat layout (pad to a multiple of N, rank r owns slice
    r), for a size no world divides."""
    import torch

    value = np.arange(31 * 3, dtype="float32").reshape(31, 3)
    for ndev in WORLDS:
        rinfo = rsu.ShardInfo("m", value.shape, "float32", ndev)
        tinfo = tsu.ShardInfo("m", value.shape, "float32", ndev)
        assert (tinfo.numel, tinfo.padded) == (rinfo.numel, rinfo.padded)
        slices = [tsu.to_sharded_local(torch.from_numpy(value), tinfo, r,
                                       ndev) for r in range(ndev)]
        flat = torch.cat(slices)
        want = np.pad(value.reshape(-1), (0, rinfo.padded - rinfo.numel))
        np.testing.assert_array_equal(flat.numpy(), want)
        np.testing.assert_array_equal(tinfo.unshard(flat).numpy(),
                                      rinfo.unshard(want))
        # a buffer padded for another world unshards and re-lays out
        other = torch.from_numpy(np.pad(value.reshape(-1), (0, 5)))
        np.testing.assert_array_equal(
            torch.cat([tsu.to_sharded_local(other, tinfo, r, ndev)
                       for r in range(ndev)]).numpy(), want)
    # unshard_scope_value through each package's plan of the Adam MLP
    r_main, t_main = (_built("adam_reg_fused", f) for f in (rfluid, tfluid))
    t_main._shard_plan = tsu.plan_sharded_update(
        t_main, t_main.global_block(), 2)
    r_main._shard_plan = rsu.plan_sharded_update(
        r_main, r_main.global_block(), 2, "dp")
    for n, info in t_main._shard_plan.sharded_state.items():
        flat = np.arange(info.padded, dtype="float32")
        np.testing.assert_array_equal(
            tsu.unshard_scope_value(t_main, n, flat),
            rsu.unshard_scope_value(r_main, n, flat))
    assert tsu.unshard_scope_value(t_main, "fc_0.w_0", value) is value


@pytest.mark.parametrize("op_type", ["lamb", "lars_momentum"])
def test_norm_optimizers_match_reference(op_type):
    """LAMB and LARS in shard space (`_sharded_norm_opt`) on one shard
    holding the whole parameter against the reference's op computes (the
    ops themselves come with ROADMAP Queue 1 #5)."""
    import jax.numpy as jnp
    import torch

    from paddle_tpu import ops as rops

    r = np.random.RandomState(1)
    ins = {"Param": r.randn(37).astype("float32"),
           "Grad": r.randn(37).astype("float32"),
           "LearningRate": np.array([0.01], "float32")}
    if op_type == "lamb":
        ins.update(Moment1=r.rand(37).astype("float32"),
                   Moment2=r.rand(37).astype("float32"),
                   Beta1Pow=np.array([0.9], "float32"),
                   Beta2Pow=np.array([0.999], "float32"))
    else:
        ins["Velocity"] = r.randn(37).astype("float32")
    attrs = {}
    want = rops.normalize_outs(rops.get_op(op_type).compute(
        {k: [jnp.asarray(v)] for k, v in ins.items()}, attrs))
    plan = tsu.ShardedUpdatePlan(None, 1, (), (), {}, False, ())
    got = tsu._sharded_norm_opt(
        op_type, {k: [torch.from_numpy(v)] for k, v in ins.items()}, attrs,
        plan)
    for slot, vals in got.items():
        np.testing.assert_allclose(vals[0].numpy(),
                                   np.asarray(want[slot][0]).reshape(
                                       vals[0].shape), rtol=1e-6,
                                   atol=1e-7, err_msg=slot)


# -- ranks -----------------------------------------------------------------------

def _startup_state(main, startup):
    """The port's startup values of `main`'s persistables (on the CPU)."""
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    return dump_numpy_state(scope, [v.name for v in main.list_vars()
                                    if v.persistable])


@pytest.fixture(scope="module", autouse=True)
def zero_launch(tmp_path_factory):
    """Start the ranks and the reference's runs at the module's first
    test, so the plan tests above run meanwhile: the start states (the
    port's startups), one spawn of 2 and one of 4 gloo ranks, and two
    processes of the reference's runs (the BERT, whose compile takes
    longest; the MLPs and the head). Yields (dirs, spawns, those
    processes, states)."""
    d = {w: str(tmp_path_factory.mktemp("zero%d" % w)) for w in WORLDS}
    states = {n: _startup_state(*runner.build_zero_mlp(tfluid, **c)[:2])
              for n, c in runner.ZERO_MLPS.items()}
    states["bert_amp"] = _startup_state(
        *runner.build_zero_bert(tfluid, tmp, tbert)[:2])
    states["size1"] = _startup_state(
        *runner.build_zero_size1(tfluid, tfleet)[:2])
    for n, st in states.items():
        for w in WORLDS:
            runner.save_state(d[w], "zero_" + n, st)
    ranks = {w: distributed.spawn(runner.zero_ranks, (d[w],), nprocs=w,
                                  backend="gloo", join=False)
             for w in WORLDS}
    refs = [runner.start_reference_zero([(d[2], "bert_amp", 2)]),
            runner.start_reference_zero(
                [(d[2], n, 2) for n in runner.zero_mlps(2) + ["size1"]]
                + [(d[4], n, 4) for n in runner.zero_mlps(4)])]
    try:
        yield d, ranks, refs, states
    finally:
        for sc in ranks.values():
            try:
                sc.join(1)  # stops what is still running
            except (RuntimeError, TimeoutError):
                pass  # zero_runs reports a failed rank
        for p in refs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()


@pytest.fixture(scope="module")
def zero_runs(zero_launch):
    """(reference results by (world, case), the port's per-rank results
    by world, start states), once the ranks and the reference's
    processes have finished."""
    d, ranks, refs, states = zero_launch
    for sc in ranks.values():
        sc.join(240)
    for p in refs:
        rc, out = runner.wait_cohort(p, d[2], timeout=240)
        assert rc == 0, out
    ref = {}
    for w in WORLDS:
        for n in list(runner.ZERO_MLPS) + ["bert_amp", "size1"]:
            path = os.path.join(d[w], "ref_%s.npz" % n)
            if os.path.exists(path):
                with np.load(path) as f:
                    got = dict(f)
                ref[w, n] = (got.pop("losses"), {
                    k[len("state."):]: v for k, v in got.items()})
    port = {w: runner.results(d[w], "zero", nproc=w) for w in WORLDS}
    return ref, port, states


def _get(rank, case, variant, what):
    pre = "%s.%s.%s" % (case, variant, what)
    if what in ("state", "step1"):
        return {k[len(pre) + 1:]: v for k, v in rank.items()
                if k.startswith(pre + ".")}
    return rank[pre]


RUN_CASES = [(w, c) for w in WORLDS for c in runner.zero_mlps(w)] \
    + [(2, "bert_amp"), (2, "size1")]


@pytest.mark.parametrize("world,case", RUN_CASES)
def test_zero_matches_reference(world, case, zero_runs):
    """The port's sharded update against the reference's: the losses
    (one a rank a step) and every persistable after the steps."""
    ref, port, _ = zero_runs
    want_losses, want_state = ref[world, case]
    rank0 = port[world][0]
    rtol = BF16_RTOL if case == "bert_amp" else RTOL
    got = _get(rank0, case, "on", "losses")[:len(want_losses)]
    assert got.shape == want_losses.shape == (
        1 if case == "bert_amp" else runner.ZERO_STEPS, world)
    np.testing.assert_allclose(got, want_losses, rtol=rtol)
    state = _get(rank0, case, "on",
                 "step1" if case == "bert_amp" else "state")
    assert sorted(state) == sorted(want_state)
    if case == "bert_amp":
        # each kind of state as one vector, relative in norm: a var whose
        # bf16 gradient is rounding noise (the attention's key bias,
        # whose exact gradient is zero) takes an Adam step of either
        # sign, so no per-var tolerance holds
        kinds = {}
        for n in want_state:
            kind = "master" if n.endswith("@MASTER") else \
                "moment1" if "moment1" in n else \
                "moment2" if "moment2" in n else "other"
            kinds.setdefault(kind, []).append(n)
        assert set(kinds) == {"master", "moment1", "moment2", "other"}
        for kind, names in kinds.items():
            got, want = (np.concatenate([np.asarray(
                st[n], "float64").ravel() for n in names])
                for st in (state, want_state))
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= BERT_STATE_RTOL, (kind, rel)
        return
    for n, want in want_state.items():
        np.testing.assert_allclose(np.asarray(state[n], "float64"),
                                   np.asarray(want, "float64"),
                                   rtol=rtol, atol=1e-7, err_msg=n)


@pytest.mark.parametrize("world,case", RUN_CASES)
def test_zero_equals_replicated_and_unbucketed(world, case, zero_runs):
    """On against off, and bucketed against a cap of 0: bit-equal at 2
    ranks, within WORLD4_RTOL at 4; the ranks hold the same bits."""
    _, port, _ = zero_runs
    rank0 = port[world][0]
    on = {"losses": _get(rank0, case, "on", "losses"),
          **_get(rank0, case, "on", "state")}
    for other in ("off", "cap0"):
        if "%s.%s.losses" % (case, other) not in rank0:
            continue
        got = {"losses": _get(rank0, case, other, "losses"),
               **_get(rank0, case, other, "state")}
        assert sorted(got) == sorted(on)
        for k, v in on.items():
            if world == 2:
                np.testing.assert_array_equal(got[k], v,
                                              err_msg="%s %s" % (other, k))
            else:
                np.testing.assert_allclose(got[k], v, rtol=WORLD4_RTOL,
                                           atol=1e-9,
                                           err_msg="%s %s" % (other, k))
    for rank in port[world][1:]:
        for k, v in rank0.items():
            if not k.endswith("local_bytes"):
                np.testing.assert_array_equal(rank[k], v, err_msg=k)


@pytest.mark.parametrize("world,case", RUN_CASES)
def test_state_is_sharded(world, case, zero_runs):
    """A rank's scope holds the flat 1/N slices of the moments (and AMP
    masters): the bytes `CompiledBlock.info()` reports, 1/N of the
    logical bytes up to the padding; off, nothing is sharded."""
    _, port, states = zero_runs
    for rank in port[world]:
        sharded = list(_get(rank, case, "on", "sharded"))
        if case == "sgd":
            assert sharded == []
            continue
        logical = int(_get(rank, case, "on", "info.opt_state_logical_bytes"))
        per = int(_get(rank, case, "on",
                       "info.opt_state_per_replica_bytes"))
        assert int(_get(rank, case, "on", "local_bytes")) == per
        want_logical = sum(states[case][n].nbytes for n in sharded)
        assert logical == want_logical
        assert logical / world <= per < logical / world + 16 * len(sharded)
        assert int(_get(rank, case, "on", "info.opt_state_sharded_vars")) \
            == len(sharded)
        assert int(_get(rank, case, "off",
                        "info.opt_state_sharded_vars")) == 0
        # slot identity decides what is sharded, so a (1,) param's
        # update runs in shard space, but its one-element moments stay
        # replicated
        moments = {n for n, v in states[case].items()
                   if ("moment" in n or "velocity" in n)}
        assert {n for n in moments if states[case][n].size > 1} == \
            moments & set(sharded)
        if case == "bert_amp":
            masters = [n for n in states[case] if n.endswith("@MASTER")]
            assert masters and set(masters) <= set(sharded)


def test_reshard_scope_to_logical_round_trip(zero_runs):
    """`reshard_scope_to_logical` rewrites each sharded var at its
    logical shape, equal to what `read_logical` gathers; the next step
    lays them out as slices again and runs on."""
    _, port, _ = zero_runs
    for rank in port[2]:
        assert int(rank["momentum.on.resharded"]) == 4
        assert bool(rank["momentum.on.reshard_equal"])
        assert bool(rank["momentum.on.relaid"])
        assert np.isfinite(rank["momentum.on.after_reshard"]).all()


def test_prefetched_dp_run_equals_hand_fed(zero_runs):
    """At 2 ranks, a run fed by `prefetch_to_device` with the executor's
    `feed_sharding` (each rank copies only its rows) equals the run fed
    by hand bit for bit."""
    _, port, _ = zero_runs
    for rank in port[2]:
        np.testing.assert_array_equal(
            _get(rank, "momentum", "prefetch", "losses"),
            _get(rank, "momentum", "on", "losses"))
        assert int(rank["momentum.prefetch.rows"]) == 32


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_sums_bf16_gradients_as_nccl_does(world, zero_runs):
    """Gloo adds bf16 values one pair at a time in float32 and rounds
    each sum to bf16, as NCCL's bf16 reduction does: at 2 ranks both give
    the float32 sum rounded once, exactly; at 4 the order of the
    additions is each library's own, so a sum may differ from the
    once-rounded one by the roundings of its partial sums (three sums of
    up to 3x the largest addend): within 6 bf16 steps of that addend
    (measured 4 at 4 ranks)."""
    _, port, _ = zero_runs
    for rank in port[world]:
        if world == 2:
            assert bool(rank["bf16_sum.exact"])
        assert float(rank["bf16_sum.max_ulps"]) <= 6, float(
            rank["bf16_sum.max_ulps"])



