"""The port's collective ops (paddle_tpu_torch/ops/collective_ops.py) at
two ranks over gloo on the CPU against the JAX package's, run under
`shard_map` on a 2-device mesh of the virtual CPU devices, as
tests/test_parallel.py::test_collective_ops_in_shard_map runs them.

Two ranks (`tests/torch_dp_runner.py`, started by the port's launcher on
free ports) run one data-parallel program holding every op of the
reference's `collective_ops.py`: the program takes the global [8, 4]
inputs and each rank keeps its rows (the reference's P("dp") in spec),
and each fetch is gathered over the ranks along axis 0 (its P("dp") out
spec). The inputs are integer-valued floats, so every op must match
exactly: a product over zeros and negatives, a broadcast from root 1, a
tiled all-gather and reduce-scatter, an all-to-all, the legacy
`allreduce` (its reduce_type 3, exp(sum(log)), on positive inputs within
1e-6). `c_embedding` (each rank holding half of the table) is held
against numpy's lookup; the eager API of `paddle_tpu_torch.distributed`
against numpy. The cohort runs once per module.
"""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu import ops as rops
from paddle_tpu.parallel import env as renv

import torch_dp_runner as runner

pytestmark = pytest.mark.dist


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("collective"))
    proc = runner.start_cohort(["collective"], d)
    rc, out = runner.wait_cohort(proc, d, timeout=180)
    assert rc == 0, out
    return runner.results(d, "collective")


@pytest.fixture(scope="module")
def reference():
    """Every case's reference output on the 2-device mesh (the ring
    registry and global mesh restored after)."""
    saved = dict(renv._RINGS), renv.global_mesh()
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    renv.register_ring(0, "dp", 2)
    ins = runner.collective_inputs()
    out = []
    try:
        for op, attrs, src in runner.COLLECTIVE_CASES:
            def inner(v, op=op, attrs=attrs):
                with renv.collective_scope({"dp": 2}):
                    return rops.run_op(op, {"X": [v]},
                                       dict(attrs, ring_id=0))["Out"][0]

            f = jax.jit(renv.shard_map_compat(
                inner, mesh=mesh, in_specs=P("dp"), out_specs=P("dp"),
                check_vma=False))
            out.append(np.asarray(f(ins[src])))
    finally:
        renv._RINGS.clear()
        renv._RINGS.update(saved[0])
        renv.set_global_mesh(saved[1])
    return out


CASE_IDS = ["%s%s" % (op, "".join("-%s%s" % kv for kv in attrs.items()))
            for op, attrs, _ in runner.COLLECTIVE_CASES]


@pytest.mark.parametrize("i", range(len(runner.COLLECTIVE_CASES)),
                         ids=CASE_IDS)
def test_op_matches_reference(i, cohort, reference):
    """The gathered output of each op equals the reference's exactly
    (shape and values; within 1e-6 for the exp(sum(log)) product), on
    both ranks."""
    op, attrs, _ = runner.COLLECTIVE_CASES[i]
    want = reference[i]
    for rank in cohort:
        got = rank["op%d" % i]
        assert got.shape == want.shape
        if op == "allreduce" and attrs["reduce_type"] == 3:
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


def test_prod_covers_zeros_and_negatives(reference):
    """The reference's product over a zero and negatives (no NaN), which
    the port's must equal (test_op_matches_reference)."""
    i = [c[0] for c in runner.COLLECTIVE_CASES].index("c_allreduce_prod")
    x = runner.collective_inputs()["signed"]
    want = np.tile(x[:4] * x[4:], (2, 1))
    np.testing.assert_array_equal(reference[i], want)
    assert (want == 0).any() and (want < 0).any()


def test_c_embedding_matches_lookup(cohort):
    """Each rank holds rows [5r, 5r + 5) of the table; the summed lookup
    is the whole table's, on both ranks."""
    ins = runner.collective_inputs()
    want = np.tile(ins["table"][ins["ids"]], (2, 1, 1))
    for rank in cohort:
        np.testing.assert_array_equal(rank["c_embedding"], want)


def test_eager_api(cohort):
    """all_reduce, broadcast (from rank 1), all_gather (tiled, appended)
    and reduce_scatter of rank r's arange(4) + 10 r."""
    t = [np.arange(4, dtype="float32") + 10 * r for r in range(2)]
    for r, rank in enumerate(cohort):
        np.testing.assert_array_equal(rank["eager_all_reduce"], t[0] + t[1])
        np.testing.assert_array_equal(rank["eager_broadcast"], t[1])
        np.testing.assert_array_equal(rank["eager_all_gather"],
                                      np.concatenate(t))
        np.testing.assert_array_equal(rank["eager_reduce_scatter"],
                                      (t[0] + t[1])[2 * r:2 * r + 2])


def test_gloo_block_runs_eagerly_and_says_why(cohort):
    """Offered capture (a CPU graph runner), a data-parallel block over
    gloo runs eagerly, naming gloo."""
    for rank in cohort:
        assert str(rank["mode"]) == "eager"
        assert "gloo collectives run on the host" in str(rank["reason"])


def test_capture_blockers_of_data_parallel_blocks():
    """A data-parallel block over gloo, or over NCCL at more than one
    rank, runs eagerly and names why; over NCCL at one rank it may be
    captured."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.lowering import capture_blocker
    from paddle_tpu_torch.parallel import env as tenv

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        fluid.layers.collective._c_allreduce(x)
    block = main.global_block()
    assert capture_blocker(main, block) is None
    assert capture_blocker(main, block, tenv.Ring(None, "nccl", [0], 0)) \
        is None
    assert "gloo collectives run on the host" in capture_blocker(
        main, block, tenv.Ring(None, "gloo", [0], 0))
    assert "NCCL collectives across ranks" in capture_blocker(
        main, block, tenv.Ring(None, "nccl", [0, 1, 2, 3], 2))


def test_leaving_the_world_releases_collective_graphs():
    """NCCL's destroy of a communicator waits for the CUDA graphs that
    captured its collectives (4 ranks then never exited):
    `shutdown_parallel_env` releases the registered graphs first, and a
    released graph leaves the registry."""
    from paddle_tpu_torch.core import graphs

    g = graphs.Graph("cpu", runner=lambda body: body())
    g.capture(lambda: None)
    graphs._COLLECTIVE_GRAPHS.add(g)
    graphs.release_collective_graphs()
    assert not g.captured and g not in graphs._COLLECTIVE_GRAPHS


def test_ops_are_identities_without_a_live_ring():
    """Outside a data-parallel run every collective op returns its input,
    as the reference's do outside a mesh; dgc raises."""
    import torch

    from paddle_tpu_torch import ops as tops

    x = torch.arange(8.0).reshape(2, 4)
    for op, attrs, _ in runner.COLLECTIVE_CASES:
        out = tops.run_op(op, {"X": [x]}, dict(attrs, ring_id=0))["Out"][0]
        assert torch.equal(out, x), op
    with pytest.raises(NotImplementedError, match="Queue 1 #10"):
        tops.run_op("dgc", {"Grad": [x]}, {})


def test_nccl_without_a_card_raises():
    """NCCL that cannot come up raises; it never turns into gloo."""
    import torch

    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.parallel import env as tenv

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="nccl"):
        distributed.init_parallel_env(backend="nccl")
    assert tenv.global_mesh() is None


def test_feed_that_does_not_split_raises():
    from paddle_tpu_torch.fluid.executor import Executor
    from paddle_tpu_torch.parallel import env as tenv

    ring = tenv.Ring(None, "gloo", [0, 1], 1)
    feed = {"x": np.arange(12.0).reshape(6, 2)}
    np.testing.assert_array_equal(Executor._split_feed(feed, ring)["x"],
                                  feed["x"][3:])
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        Executor._split_feed({"x": np.zeros((5, 2))}, ring)

