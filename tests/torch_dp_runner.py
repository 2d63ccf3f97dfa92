"""Worker of the port's data-parallel tests: one rank of a world that
`paddle_tpu_torch.distributed.launch` starts over gloo on the CPU.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        --backend gloo tests/torch_dp_runner.py <cases> <dir>

`<cases>` is a comma-separated list of the `CASES` below, each run in
turn in this process; `<dir>` holds the inputs the test wrote
(`inputs.npz`, start states `<name>.state.npz`) and gets this rank's
results, `<case>.rank<r>.npz`. The model builders take the `fluid`
package (and model module) as an argument, so the tests build the same
programs in the JAX package for the reference.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: the MLP of tests/test_parallel.py
MLP_BATCH, MLP_STEPS, MLP_LR = 64, 5, 0.1
#: ResNet50 at 32 x 32, 10 classes, batch 4 a rank (at 2 a rank the last
#: stage normalizes 2 values a channel, where the reference's variance,
#: E[x^2] - E[x]^2, loses its digits: one process from one zero-gamma
#: state, batch 2, gives second losses 1.57666 there and 1.57377 in the
#: port; at batch 4, 1.5799648 and 1.5799650)
RESNET = dict(img=32, classes=10, batch=8, steps=3, lr=3e-3)
#: a small conv net with batch norm (sync_batch_norm)
CNN = dict(img=8, classes=4, batch=8, steps=3, lr=0.1)


def build_mlp(fluid, seed, minimize, dropout=None):
    """The MLP of tests/test_parallel.py (32-32-4, softmax cross-entropy,
    mean) in fresh programs, `minimize(loss)` called inside them: (main,
    startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        img = fluid.layers.data(name="img", shape=[32], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=img, size=32, act="relu")
        if dropout:
            h = fluid.layers.dropout(h, dropout_prob=dropout)
        logits = fluid.layers.fc(input=h, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        minimize(loss)
    return main, startup, loss


def mlp_feed():
    rng = np.random.RandomState(42)
    return {"img": rng.rand(MLP_BATCH, 32).astype("float32"),
            "label": rng.randint(0, 4, (MLP_BATCH, 1)).astype("int64")}


def build_cnn(fluid, minimize):
    """conv 3x3 (8 channels) -> batch_norm -> relu -> fc over 8 x 8
    images, softmax cross-entropy, mean, then `minimize(loss)`: (main,
    startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        img = fluid.layers.data("image", shape=[3, CNN["img"], CNN["img"]],
                                dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        c = fluid.layers.conv2d(img, num_filters=8, filter_size=3,
                                padding=1, bias_attr=False)
        h = fluid.layers.batch_norm(c, act="relu")
        logits = fluid.layers.fc(input=h, size=CNN["classes"])
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        minimize(loss)
    return main, startup, loss


def image_feed(c, seed=0):
    r = np.random.RandomState(seed)
    return {"image": r.randn(c["batch"], 3, c["img"], c["img"]).astype(
                "float32"),
            "label": r.randint(0, c["classes"], (c["batch"], 1)).astype(
                "int64")}


def build_resnet(fluid, resnet, minimize):
    """ResNet50 (full depth, `scan_stages`) over 32 x 32 images, then
    `minimize(loss)`: (main, startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 6
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        img = fluid.layers.data("image", shape=[3, RESNET["img"],
                                                RESNET["img"]],
                                dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        logits = resnet.resnet(img, class_dim=RESNET["classes"], depth=50,
                               scan_stages=True)
        loss = fluid.layers.mean(
            fluid.layers.loss.softmax_with_cross_entropy(logits, label))
        minimize(loss)
    return main, startup, loss


#: (op type, attrs) of the single-input collective ops, held against the
#: reference op under shard_map; "x" an integer-valued float [8, 4]
#: global input, "pos" a positive one (the legacy exp(sum(log)) product)
COLLECTIVE_CASES = [
    ("c_allreduce_sum", {}, "x"), ("c_allreduce_max", {}, "x"),
    ("c_allreduce_min", {}, "x"), ("c_allreduce_prod", {}, "signed"),
    ("c_broadcast", {"root": 1}, "x"), ("c_allgather", {"nranks": 2}, "x"),
    ("c_reducescatter", {"nranks": 2}, "x"),
    ("c_reduce_sum", {"root_id": 1}, "x"), ("alltoall", {}, "x"),
    ("c_concat", {"nranks": 2}, "x"), ("c_split", {"nranks": 2}, "x"),
    ("c_identity", {}, "x"), ("c_sync_calc_stream", {}, "x"),
    ("c_sync_comm_stream", {}, "x"), ("allreduce", {"reduce_type": 0}, "x"),
    ("allreduce", {"reduce_type": 1}, "x"),
    ("allreduce", {"reduce_type": 2}, "x"),
    ("allreduce", {"reduce_type": 3}, "pos"),
    ("broadcast", {"root": 1}, "x"),
]


def collective_inputs():
    x = np.arange(32, dtype="float32").reshape(8, 4) - 9.0
    signed = np.linspace(-2.0, 2.0, 32).astype("float32").reshape(8, 4)
    signed[3, 1] = 0.0
    signed[6, 2] = -3.0
    pos = np.linspace(0.5, 4.0, 32).astype("float32").reshape(8, 4)
    return {"x": x, "signed": signed, "pos": pos,
            "table": np.arange(40, dtype="float32").reshape(10, 4),
            "ids": np.array([[0], [4], [9], [5], [2], [7]], "int64")}


# -- the cases, in the worker ------------------------------------------------

def _run_collective(out, rank, world):
    """Every collective op in one data-parallel program, fed the global
    inputs and fetching the gathered outputs (the reference's P(dp) in
    and out specs); c_embedding over this rank's half of the table; the
    eager API on tensors."""
    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import fluid

    ins = collective_inputs()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        block = main.global_block()
        data = {k: fluid.layers.data(k, shape=[4], dtype="float32")
                for k in ("x", "signed", "pos")}
        table = fluid.layers.data("table", shape=[4], dtype="float32")
        ids = fluid.layers.data("ids", shape=[1], dtype="int64")
        fetch = []
        for i, (op, attrs, src) in enumerate(COLLECTIVE_CASES):
            o = block.create_var(name="out%d" % i, dtype="float32",
                                 shape=(-1, 4))
            block.append_op(type=op, inputs={"X": [data[src]]},
                            outputs={"Out": [o]},
                            attrs=dict(attrs, ring_id=0))
            fetch.append(o)
        emb = block.create_var(name="emb", dtype="float32", shape=(-1, 4))
        block.append_op(type="c_embedding",
                        inputs={"W": [table], "Ids": [ids]},
                        outputs={"Out": [emb]},
                        attrs={"ring_id": 0, "start_index": rank * 5})
    prog = fluid.CompiledProgram(main).with_data_parallel()
    # a graph runner stands in for capture: the gloo ring still runs the
    # block eagerly, and says why
    exe = fluid.Executor(fluid.CPUPlace(), graph_runner=lambda body: body())
    feed = {k: ins[k] for k in ("x", "signed", "pos", "table")}
    # the ids are replicated: each rank gets all six
    feed["ids"] = np.concatenate([ins["ids"]] * world)
    res = exe.run(prog, feed=feed, fetch_list=fetch + [emb])
    for i, r in enumerate(res[:-1]):
        out["op%d" % i] = r
    out["c_embedding"] = res[-1]
    out["mode"] = np.array(exe.last_entry.mode)
    out["reason"] = np.array(exe.last_entry.reason)
    # the eager API on this rank's tensors
    t = torch.arange(4, dtype=torch.float32) + 10 * rank
    out["eager_all_reduce"] = dist.all_reduce(t.clone()).numpy()
    out["eager_broadcast"] = dist.broadcast(t.clone(), src=1).numpy()
    out["eager_all_gather"] = dist.all_gather([], t)[0].numpy()
    out["eager_reduce_scatter"] = dist.reduce_scatter(t).numpy()
    dist.barrier()


def _train(fluid, main, startup, loss, feed, steps, state, mode, out):
    """`steps` steps of `main` (fleet-transpiled, or through
    `with_data_parallel` when mode is "dp"): rank 0 starts from `state`
    (None: its own startup), the other ranks from their own startup.
    Records the gathered losses, every persistable after the steps, the
    sum of this rank's own start values and the program's shared seed."""
    from paddle_tpu_torch.core.scope import dump_numpy_state, \
        load_numpy_state
    from paddle_tpu_torch.distributed import get_rank

    names = sorted(v.name for v in main.list_vars() if v.persistable)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    if state is not None and get_rank() == 0:
        load_numpy_state(scope, state, "cpu")
    out["start_sum"] = np.array(sum(
        float(v.sum()) for v in dump_numpy_state(scope, names).values()))
    prog = fluid.CompiledProgram(main).with_data_parallel() \
        if mode == "dp" else main
    out["losses"] = np.stack([exe.run(prog, feed=feed, fetch_list=[loss],
                                      scope=scope)[0]
                              for _ in range(steps)])
    out.update(dump_numpy_state(scope, names))
    out["shared_seed"] = np.array(main._shared_seed or -1)
    return exe, scope


def _load(d, name):
    with np.load(os.path.join(d, name + ".state.npz")) as f:
        return dict(f)


def fleet_minimize(fluid, fleet, opt_fn, sync_bn=False, nranks=None):
    """A `minimize(loss)` through fleet's distributed optimizer over
    `opt_fn()` (with the JAX package's fleet: its inner minimize, then
    `transpile_collective(nranks=nranks)`)."""
    def minimize(loss):
        st = fleet.DistributedStrategy()
        st.sync_batch_norm = sync_bn
        if nranks is None:
            fleet.distributed_optimizer(opt_fn(), st).minimize(loss)
        else:
            opt_fn().minimize(loss)
            fleet.transpile_collective(loss.block.program, nranks=nranks,
                                       sync_batch_norm=sync_bn)
    return minimize


def _run_mlp(out, d, mode, seed0=False):
    """The MLP over SGD(0.1): fleet or with_data_parallel from the
    reference's start state; with `seed0`, random_seed 0 everywhere, a
    dropout layer and each rank's own start (the replicas must agree
    all the same)."""
    from paddle_tpu_torch import fleet, fluid

    def sgd():
        return fluid.optimizer.SGDOptimizer(learning_rate=MLP_LR)

    minimize = fleet_minimize(fluid, fleet, sgd) if mode == "fleet" \
        else (lambda loss: sgd().minimize(loss))
    main, startup, loss = build_mlp(fluid, 0 if seed0 else 1234, minimize,
                                    dropout=0.5 if seed0 else None)
    _train(fluid, main, startup, loss, mlp_feed(),
           3 if seed0 else MLP_STEPS, None if seed0 else _load(d, "mlp"),
           mode, out)


def _run_cnn_sync_bn(out, d):
    from paddle_tpu_torch import fleet, fluid

    main, startup, loss = build_cnn(fluid, fleet_minimize(
        fluid, fleet, lambda: fluid.optimizer.SGDOptimizer(CNN["lr"]),
        sync_bn=True))
    _train(fluid, main, startup, loss, image_feed(CNN), CNN["steps"],
           _load(d, "cnn"), "fleet", out)


def _run_resnet(out, d):
    from paddle_tpu_torch import fleet, fluid
    from paddle_tpu_torch.core.types import to_numpy
    from paddle_tpu_torch.models import resnet

    main, startup, loss = build_resnet(fluid, resnet, fleet_minimize(
        fluid, fleet, lambda: fluid.optimizer.MomentumOptimizer(
            RESNET["lr"], momentum=0.9)))
    exe, scope = _train(fluid, main, startup, loss, image_feed(RESNET),
                        RESNET["steps"], _load(d, "resnet"), "fleet", out)
    # the for_test clone's first run leaves each rank's running
    # statistics as they are
    test = main.clone(for_test=True)
    out["test_losses"] = exe.run(test, feed=image_feed(RESNET),
                                 fetch_list=[loss], scope=scope)[0]
    stats = [n for n in out if n.endswith(("_bn_mean", "_bn_var"))]
    out["stats_kept"] = np.array(all(np.array_equal(
        out[n], to_numpy(scope.find_var(n))) for n in stats))


def _run_fleet_util(out, rank, world):
    """fleet.util and fleet.metrics over the host gloo group."""
    from paddle_tpu_torch.fleet import metrics, util

    util.barrier()
    out["all_reduce_sum"] = util.all_reduce(np.array([rank + 1.0, 2.0]))
    out["all_reduce_max"] = util.all_reduce(np.array([rank + 1.0]), "max")
    for i, a in enumerate(util.all_gather(np.arange(rank + 2.0))):
        out["all_gather%d" % i] = a
    out["broadcast"] = util.broadcast(np.array([rank * 10.0]), root=1)
    out["metrics_sum"] = metrics.sum(np.array([rank + 1.0]))
    out["metrics_acc"] = np.array(metrics.acc(np.array([rank + 3.0]),
                                              np.array([10.0])))
    out["file_shard"] = np.array(util.get_file_shard(
        ["f%d" % i for i in range(5)]))


CASES = {
    "fleet_util": lambda out, d, r, n: _run_fleet_util(out, r, n),
    "collective": lambda out, d, r, n: _run_collective(out, r, n),
    "mlp_fleet": lambda out, d, r, n: _run_mlp(out, d, "fleet"),
    "mlp_dp": lambda out, d, r, n: _run_mlp(out, d, "dp"),
    "mlp_fleet_seed0": lambda out, d, r, n: _run_mlp(out, d, "fleet", True),
    "mlp_dp_seed0": lambda out, d, r, n: _run_mlp(out, d, "dp", True),
    "cnn_sync_bn": lambda out, d, r, n: _run_cnn_sync_bn(out, d),
    "resnet": lambda out, d, r, n: _run_resnet(out, d),
    # rank 1 fails while rank 0 waits for it in a barrier: the launcher
    # must stop rank 0 and exit with rank 1's code
    "fail_rank1": lambda out, d, r, n: sys.exit(3) if r == 1 else
    __import__("paddle_tpu_torch.distributed").distributed.barrier(),
}


def main(argv):
    import torch

    from paddle_tpu_torch import fleet

    torch.set_num_threads(2)
    cases, d = argv[0].split(","), argv[1]
    fleet.init(is_collective=True)
    rank, world = fleet.worker_index(), fleet.worker_num()
    for case in cases:
        out = {}
        CASES[case](out, d, rank, world)
        np.savez(os.path.join(d, "%s.rank%d.npz" % (case, rank)), **out)


if __name__ == "__main__":
    main(sys.argv[1:])


def spawn_probe(d, fail_rank=None):
    """A `distributed.spawn` target: writes this rank's view of the
    world, or exits 5 on `fail_rank` while the others wait in a
    barrier."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.parallel import env as penv

    rank = dist.get_rank()
    if rank == fail_rank:
        sys.exit(5)
    if fail_rank is not None:
        dist.barrier()
    ring = penv.global_mesh()
    np.savez(os.path.join(d, "spawn.rank%d.npz" % rank), rank=rank,
             world=dist.get_world_size(), backend=ring.backend,
             sum=dist.all_reduce(__import__("torch").ones(1)).numpy())


# -- the tests' side ---------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start_cohort(cases, d, nproc=2):
    """Launch `nproc` ranks of this worker over gloo on free ports, in a
    session of their own (so `wait_cohort` can kill every process)."""
    import subprocess

    from paddle_tpu_torch.distributed.launch import free_port_base

    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(nproc), "--started_port",
           str(free_port_base(nproc + 1)), "--backend", "gloo",
           "--log_dir", d, os.path.abspath(__file__), ",".join(cases), d]
    env = dict(os.environ, PYTHONPATH=REPO, PADDLE_DIST_TIMEOUT_S="120")
    return subprocess.Popen(cmd, env=env, cwd=REPO, start_new_session=True,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def wait_cohort(proc, d, timeout=240):
    """The launcher's exit code and output, with the workers' logs; the
    whole session is killed if it outlives `timeout` seconds."""
    import signal
    import subprocess

    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        out += "\n(killed after %d s)" % timeout
    for name in sorted(os.listdir(d)):
        if name.startswith("workerlog."):
            with open(os.path.join(d, name)) as f:
                out += "\n--- %s\n%s" % (name, f.read()[-4000:])
    return proc.returncode, out


def results(d, case, nproc=2):
    """Each rank's results of `case`."""
    out = []
    for r in range(nproc):
        with np.load(os.path.join(d, "%s.rank%d.npz" % (case, r))) as f:
            out.append(dict(f))
    return out
