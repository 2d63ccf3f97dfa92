"""Data parallelism over NCCL on the card at world size 1 (one card is
what the GPU machine has, and NCCL needs one card per rank). Every test
here needs an NVIDIA GPU (marker ``cuda``) and skips without one. The
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_fleet_dp_cuda.py

The module joins an NCCL world of one rank (`init_parallel_env`) and
leaves it at the end. A data-parallel program of every single-input
collective op runs eagerly, then is captured as a CUDA graph and
replayed: the replays equal the eager run bit for bit, which equals the
ops' identity outside a world (at world 1 every collective returns its
input). The MNIST MLP through `with_data_parallel`, captured, gives the
plain program's losses bit for bit (data parallelism at world 1 is the
identity, in the reference too). Leaving the world releases the graphs
that captured its collectives."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import distributed, fluid
from paddle_tpu_torch.core.scope import dump_numpy_state, load_numpy_state
from paddle_tpu_torch.fluid.layers import collective
from paddle_tpu_torch.ops import collective_ops
from paddle_tpu_torch.parallel import env as penv

pytestmark = pytest.mark.cuda

#: the ops fluid.layers.collective does not wrap, with their attrs
EXTRA_OPS = [("c_reduce_sum", {"root_id": 0}), ("alltoall", {}),
             ("c_concat", {"nranks": 1}), ("c_split", {"nranks": 1}),
             ("c_identity", {}), ("allreduce", {"reduce_type": 0}),
             ("allreduce", {"reduce_type": 1}), ("broadcast", {"root": 0})]


@pytest.fixture(scope="module")
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    distributed.init_parallel_env(backend="nccl")
    yield penv.global_mesh()
    distributed.shutdown_parallel_env()


@pytest.fixture
def graphs_on():
    old = fluid.get_flags("FLAGS_cuda_graphs")
    fluid.set_flags({"FLAGS_cuda_graphs": True})
    yield
    fluid.set_flags(old)


def _collective_program():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        fetch = [collective._c_allreduce(x, reduce_type=r)
                 for r in ("sum", "max", "min", "prod")]
        fetch += [collective._c_broadcast(x), collective._c_allgather(x, 1),
                  collective._c_reducescatter(x, 1),
                  collective._c_sync_calc_stream(x),
                  collective._c_sync_comm_stream(x)]
        block = main.global_block()
        for i, (op, attrs) in enumerate(EXTRA_OPS):
            o = block.create_var(name="extra%d" % i, dtype="float32",
                                 shape=(-1, 4))
            block.append_op(type=op, inputs={"X": [x]}, outputs={"Out": [o]},
                            attrs=attrs)
            fetch.append(o)
    return main, fetch


def test_world_of_one_over_nccl(world):
    assert (world.backend, world.size, world.rank) == ("nccl", 1, 0)
    assert distributed.get_world_size() == 1 and distributed.get_rank() == 0
    t = torch.arange(4.0, device="cuda")
    assert torch.equal(distributed.all_reduce(t.clone()), t)
    assert torch.equal(distributed.all_gather([], t)[0], t)


def test_collectives_capture_and_replay_bit_equal(world, graphs_on):
    main, fetch = _collective_program()
    prog = fluid.CompiledProgram(main).with_data_parallel()
    exe = fluid.Executor()
    x = np.arange(32, dtype="float32").reshape(8, 4) - 9.0
    collective_ops.reset_stats()
    runs, phases = [], []
    for _ in range(4):
        runs.append(exe.run(prog, feed={"x": x}, fetch_list=fetch))
        phases.append(exe.last_entry.phase)
    assert exe.last_entry.mode == "graph"
    assert phases == ["warm", "captured", "captured", "captured"]
    assert collective_ops.stats["all_reduce"]["calls"] > 0
    for r in runs[1:]:
        for a, b in zip(r, runs[0]):
            np.testing.assert_array_equal(a, b)
    plain = main.clone()
    plain._data_parallel = False
    ident = fluid.Executor(fluid.CPUPlace()).run(plain, feed={"x": x},
                                                 fetch_list=fetch)
    for a, b in zip(runs[0], ident):
        np.testing.assert_array_equal(a, b)


def _mlp():
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data(name="img", shape=[784], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=img, size=128, act="relu")
        h = fluid.layers.fc(input=h, size=64, act="relu")
        logits = fluid.layers.fc(input=h, size=10)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.SGDOptimizer(learning_rate=0.5).minimize(loss)
    return main, startup, loss


def test_dp_mlp_at_world_one_equals_plain(world, graphs_on):
    """8 captured SGD steps through with_data_parallel and of the plain
    program from one start state: equal losses, bit for bit."""
    r = np.random.RandomState(0)
    feeds = [{"img": r.rand(64, 784).astype("float32"),
              "label": r.randint(0, 10, (64, 1)).astype("int64")}
             for _ in range(8)]
    out, state = {}, None
    for dp in (False, True):
        main, startup, loss = _mlp()
        exe = fluid.Executor()
        scope = fluid.Scope()
        if state is None:
            exe.run(startup, scope=scope)
            state = dump_numpy_state(scope, [v.name for v in main.list_vars()
                                             if v.persistable])
        else:
            load_numpy_state(scope, state)
        prog = fluid.CompiledProgram(main).with_data_parallel() if dp \
            else main
        out[dp] = np.stack([exe.run(prog, feed=f, fetch_list=[loss],
                                    scope=scope)[0] for f in feeds])
        assert exe.last_entry.mode == "graph"
        assert exe.last_entry.phase == "captured"
    assert out[True].shape == (8, 1)
    np.testing.assert_array_equal(out[True], out[False])


def test_leaving_the_world_releases_its_captured_graphs(world, graphs_on):
    """A captured data-parallel block is registered as a graph holding
    collectives (NCCL does not destroy a communicator while such a graph
    lives); `shutdown_parallel_env` releases it. Runs last: it leaves the
    world and joins a new one for the module's teardown."""
    from paddle_tpu_torch.core import graphs

    main, fetch = _collective_program()
    prog = fluid.CompiledProgram(main).with_data_parallel()
    exe = fluid.Executor()
    x = np.ones((8, 4), dtype="float32")
    for _ in range(3):
        exe.run(prog, feed={"x": x}, fetch_list=fetch)
    graph = exe.last_entry._step.graph
    assert exe.last_entry.phase == "captured" and graph.replays == 2
    assert graph in graphs._COLLECTIVE_GRAPHS
    distributed.shutdown_parallel_env()
    assert penv.global_mesh() is None
    assert len(graphs._COLLECTIVE_GRAPHS) == 0 and graph.graph is None
    distributed.init_parallel_env(backend="nccl")
    assert penv.global_mesh().backend == "nccl"
