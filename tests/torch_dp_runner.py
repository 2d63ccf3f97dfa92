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

try:  # bfloat16 values come back as numpy arrays (`core.types.to_numpy`)
    import ml_dtypes  # noqa: F401
except ImportError:  # the GPU machine: no bfloat16 arrays asked for there
    pass

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


def collective_inputs(table_rows=10):
    x = np.arange(32, dtype="float32").reshape(8, 4) - 9.0
    signed = np.linspace(-2.0, 2.0, 32).astype("float32").reshape(8, 4)
    signed[3, 1] = 0.0
    signed[6, 2] = -3.0
    pos = np.linspace(0.5, 4.0, 32).astype("float32").reshape(8, 4)
    return {"x": x, "signed": signed, "pos": pos,
            "table": np.arange(4 * table_rows,
                               dtype="float32").reshape(table_rows, 4),
            "ids": np.array([[0], [4], [9], [5], [2], [7]], "int64")}


#: the sharded weight update (tests/test_torch_sharded_update.py): the
#: 31-wide MLP of tests/test_sharded_update.py (31 divides no world, so
#: every sharded tensor is padded) under each optimizer, and a 1-layer
#: BERT at bf16 AMP O2 with fused Adam; steps, a bucket cap small enough
#: for several buckets, and the variants each world runs
ZERO_STEPS = 3
ZERO_CAP_MB = 0.002
ZERO_MLPS = {
    "adam_reg_fused": dict(opt="adam", reg=True, fuse=True),
    "momentum": dict(opt="momentum"),
    "sgd": dict(opt="sgd"),
}
ZERO_BERT = dict(vocab_size=128, hidden_size=32, num_hidden_layers=1,
                 num_attention_heads=2, intermediate_size=64,
                 max_position_embeddings=16, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0)
ZERO_BERT_SEQ, ZERO_BERT_BATCH = 16, 4
#: the reference's BERT runs one step (its second step compiles again,
#: the slowest part of the test); the ranks keep their state after it
#: variant -> (FLAGS_tpu_sharded_weight_update, FLAGS_tpu_comm_bucket_mb)
ZERO_VARIANTS = {"on": (True, ZERO_CAP_MB), "off": (False, ZERO_CAP_MB),
                 "cap0": (True, 0.0)}


def zero_mlps(world):
    """The MLPs a world runs: all at 2 ranks, the Adam one at 4."""
    return list(ZERO_MLPS) if world == 2 else ["adam_reg_fused"]


def build_zero_mlp(fluid, opt, reg=False, fuse=False, mp=None):
    """The 31-wide MLP (32-31-4, softmax cross-entropy, mean) over `opt`
    ("adam" at 0.01, "momentum" at 0.1 and 0.9, "sgd" at 0.1), with L2
    decay 1e-3 and `fuse_optimizer_ops` when asked, and bf16 AMP O2 when
    given the `mp` (mixed_precision) module: (main, startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1234
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        img = fluid.layers.data(name="img", shape=[32], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=img, size=31, act="relu")
        logits = fluid.layers.fc(input=h, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        kw = {}
        if reg:
            kw["regularization"] = fluid.regularizer.L2Decay(1e-3)
        O = fluid.optimizer
        optimizer = {
            "adam": lambda: O.AdamOptimizer(learning_rate=0.01, **kw),
            "momentum": lambda: O.MomentumOptimizer(
                learning_rate=0.1, momentum=0.9, **kw),
            "sgd": lambda: O.SGDOptimizer(learning_rate=0.1, **kw)}[opt]()
        if mp is not None:
            optimizer = mp.decorate(optimizer, use_dynamic_loss_scaling=False)
        optimizer.minimize(loss)
        if fuse:
            fluid.fuse_optimizer_ops(main)
    return main, startup, loss


def build_zero_size1(fluid, fleet, nranks=None):
    """The reference's single-element-parameter case
    (tests/test_sharded_update.py:279): an 8 -> 1 regression head, whose
    bias is a (1,) parameter, through fleet over Adam(1e-3) (the JAX
    package's fleet: `transpile_collective(nranks=nranks)`): (main,
    startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        err = fluid.layers.fc(input=x, size=1) - y
        loss = fluid.layers.mean(err * err)
        fleet_minimize(fluid, fleet,
                       lambda: fluid.optimizer.AdamOptimizer(1e-3),
                       nranks=nranks)(loss)
    return main, startup, loss


def zero_size1_feed():
    r = np.random.RandomState(0)
    return {"x": r.rand(16, 8).astype("float32"),
            "y": r.rand(16, 1).astype("float32")}


def zero_mlp_feed():
    r = np.random.RandomState(0)
    return {"img": r.rand(64, 32).astype("float32"),
            "label": r.randint(0, 4, (64, 1)).astype("int64")}


def build_zero_bert(fluid, mp, bert, cfg=None, seq=ZERO_BERT_SEQ,
                    scan=False):
    """BERT pretraining (`cfg`, default `ZERO_BERT`), bf16 AMP O2 over
    Adam(1e-3) with `fuse_optimizer_ops`, as bench.py builds BERT, with
    the scan encoder when asked (the reference compiles the 1-layer
    default's unrolled encoder faster): (main, startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        total, _, _, _ = bert.bert_pretrain_loss(
            cfg or bert.BertConfig(**ZERO_BERT), seq, scan_layers=scan)
        opt = mp.decorate(fluid.optimizer.AdamOptimizer(1e-3),
                          use_dynamic_loss_scaling=False)
        opt.minimize(total)
        fluid.fuse_optimizer_ops(main)
    return main, startup, total


def zero_bert_feed(bert):
    return bert.bert_feed(bert.BertConfig(**ZERO_BERT), ZERO_BERT_BATCH,
                          ZERO_BERT_SEQ)


# -- the cases, in the worker ------------------------------------------------

def _run_collective(out, rank, world, table_rows=10):
    """Every collective op in one data-parallel program, fed the global
    inputs and fetching the gathered outputs (the reference's P(dp) in
    and out specs); c_embedding over this rank's 5 rows of a table of
    `table_rows` (5 a rank); the eager API on tensors."""
    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import fluid

    ins = collective_inputs(table_rows)
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


def logical_state(exe, program, scope, names):
    """name -> numpy value at its logical shape (the sharded moments and
    masters gathered over the ranks: every rank calls it)."""
    from paddle_tpu_torch.core.types import to_numpy

    return {n: to_numpy(exe.read_logical(n, program, scope))
            for n in names}


def _train(fluid, main, startup, loss, feed, steps, state, mode, out):
    """`steps` steps of `main` (fleet-transpiled, or through
    `with_data_parallel` when mode is "dp"): rank 0 starts from `state`
    (None: its own startup), the other ranks from their own startup.
    Records the gathered losses, every persistable after the steps (at
    its logical shape), the sum of this rank's own start values and the
    program's shared seed."""
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
    out.update(logical_state(exe, main, scope, names))
    out["shared_seed"] = np.array(main._shared_seed or -1)
    return exe, scope


def save_state(d, name, state):
    """Write a start state to `<d>/<name>.state.npz`; bfloat16 arrays go
    as float32 (exact) and are named under "__bf16__"."""
    bf16 = [n for n, v in state.items() if v.dtype.name == "bfloat16"]
    np.savez(os.path.join(d, name + ".state.npz"),
             __bf16__=np.array(bf16, dtype=str),
             **{n: (v.astype("float32") if n in bf16 else v)
                for n, v in state.items()})


def _load(d, name):
    with np.load(os.path.join(d, name + ".state.npz")) as f:
        st = dict(f)
    bf16 = list(st.pop("__bf16__", []))
    if bf16:
        import ml_dtypes

        for n in bf16:
            st[n] = st[n].astype(ml_dtypes.bfloat16)
    return st


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


def _run_zero(out, d, world):
    """Each MLP of `zero_mlps(world)` (and at 2 ranks the AMP BERT and
    the size-1 head through fleet) under the variants of `ZERO_VARIANTS`
    (at 4 ranks, and for those two, on and off) through
    `with_data_parallel`, from the
    reference's start state (`zero_<name>.state.npz`, rank 0 loads it):
    the gathered losses, every persistable after the steps at its
    logical shape, and the entry's `info()` numbers, keyed
    "<name>.<variant>.<what>"."""
    from paddle_tpu_torch import fleet, fluid
    from paddle_tpu_torch.core.scope import load_numpy_state
    from paddle_tpu_torch.distributed import get_rank
    from paddle_tpu_torch.fluid.contrib import mixed_precision as mp
    from paddle_tpu_torch.models import bert

    mlps = zero_mlps(world)
    builds = {n: (lambda c=ZERO_MLPS[n]: build_zero_mlp(fluid, **c))
              for n in mlps}
    feeds = {n: zero_mlp_feed() for n in mlps}
    # a cap of 0 against the buckets is held bit-equal at 2 ranks only
    variants = {n: ZERO_VARIANTS if world == 2 else {
        k: ZERO_VARIANTS[k] for k in ("on", "off")} for n in mlps}
    if world == 2:
        builds["bert_amp"] = lambda: build_zero_bert(fluid, mp, bert)
        feeds["bert_amp"] = zero_bert_feed(bert)
        builds["size1"] = lambda: build_zero_size1(fluid, fleet)
        feeds["size1"] = zero_size1_feed()
        for n in ("bert_amp", "size1"):
            variants[n] = {k: ZERO_VARIANTS[k] for k in ("on", "off")}
    for name, build in builds.items():
        state = _load(d, "zero_" + name)
        for variant, (flag, cap) in variants[name].items():
            fluid.set_flags({"FLAGS_tpu_sharded_weight_update": flag,
                             "FLAGS_tpu_comm_bucket_mb": cap})
            main, startup, loss = build()
            exe = fluid.Executor(fluid.CPUPlace())
            scope = fluid.Scope()
            exe.run(startup, scope=scope)
            if get_rank() == 0:
                load_numpy_state(scope, state, "cpu")
            prog = main if name == "size1" else \
                fluid.CompiledProgram(main).with_data_parallel()
            key = "%s.%s." % (name, variant)
            losses = []
            for i in range(ZERO_STEPS):
                losses.append(exe.run(prog, feed=feeds[name],
                                      fetch_list=[loss], scope=scope)[0])
                if i == 0 and name == "bert_amp" and variant == "on":
                    for n, v in logical_state(exe, main, scope,
                                              state).items():
                        out[key + "step1." + n] = v.astype("float32")
            out[key + "losses"] = np.stack(losses)
            for n, v in logical_state(exe, main, scope, state).items():
                # bfloat16 as float32 (exact): npz has no bfloat16
                out[key + "state." + n] = v.astype("float32") \
                    if v.dtype.name == "bfloat16" else v
            for k, v in exe.last_entry.info().items():
                if k.startswith(("opt_state", "grad_buckets")):
                    out[key + "info." + k] = np.array(v)
            out[key + "sharded"] = np.array(sorted(
                main._shard_plan.sharded_state) if main._shard_plan
                else [], dtype=str)
            out[key + "local_bytes"] = np.array(sum(
                scope.find_var(n).numel() * scope.find_var(n).element_size()
                for n in (main._shard_plan.sharded_state
                          if main._shard_plan else ())))
            if name == "momentum" and variant == "on":
                _reshard_round_trip(out, key, exe, main, prog, scope,
                                    feeds[name], loss)
    if world == 2:
        _run_zero_prefetched(out, d)
    _gloo_bf16_sum(out, world)
    fluid.set_flags({"FLAGS_tpu_sharded_weight_update": True,
                     "FLAGS_tpu_comm_bucket_mb": 25.0})


def _reshard_round_trip(out, key, exe, main, prog, scope, feed, loss):
    """`reshard_scope_to_logical` puts the sharded vars back at their
    logical shapes (equal to `read_logical`'s), and the next step lays
    them out again."""
    from paddle_tpu_torch.core.types import to_numpy
    from paddle_tpu_torch.parallel import sharded_update

    want = {n: to_numpy(exe.read_logical(n, main, scope))
            for n in main._shard_plan.sharded_state}
    out[key + "resharded"] = np.array(
        sharded_update.reshard_scope_to_logical(main, scope))
    out[key + "reshard_equal"] = np.array(all(
        np.array_equal(to_numpy(scope.find_var(n)), v)
        for n, v in want.items()))
    out[key + "after_reshard"] = exe.run(prog, feed=feed, fetch_list=[loss],
                                         scope=scope)[0]
    out[key + "relaid"] = np.array(all(
        scope.find_var(n).dim() == 1 and scope.find_var(n).numel()
        < v.size for n, v in want.items()))


#: gradient merge over the ranks: window, steps, the variants
#: (FLAGS_tpu_sharded_weight_update, FLAGS_tpu_comm_bucket_mb)
GM_K, GM_STEPS = 3, 6
GM_VARIANTS = {"replicated": (False, ZERO_CAP_MB),
               "zero": (True, ZERO_CAP_MB)}
#: the collectives of the gradient exchange, counted a step
GM_EXCHANGE_KINDS = ("all_reduce", "zero.reduce_scatter", "zero.all_gather")


def build_gm_mlp(fluid, k=GM_K):
    """The 31-wide MLP over Adam(0.01) under GradientMergeOptimizer(k,
    avg): (main, startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1234
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        img = fluid.layers.data(name="img", shape=[32], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=img, size=31, act="relu")
        logits = fluid.layers.fc(input=h, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.GradientMergeOptimizer(
            fluid.optimizer.AdamOptimizer(learning_rate=0.01), k_steps=k,
            avg=True).minimize(loss)
    return main, startup, loss


def gm_feeds(steps=GM_STEPS):
    """A global batch of 64 a step, a different one each step."""
    r = np.random.RandomState(5)
    return [{"img": r.rand(64, 32).astype("float32"),
             "label": r.randint(0, 4, (64, 1)).astype("int64")}
            for _ in range(steps)]


def gm_ranks(d):
    """A `distributed.spawn` target: the gradient-merge MLP through
    `with_data_parallel` from the start state `gm.state.npz`, replicated
    and with the sharded update: each step's gathered loss and
    collective calls, every persistable at its logical shape after the
    steps; in `<d>/gm.rank<r>.npz`."""
    import torch

    from paddle_tpu_torch import distributed, fluid
    from paddle_tpu_torch.core.scope import load_numpy_state
    from paddle_tpu_torch.ops import collective_ops

    torch.set_num_threads(2)
    out = {}
    state = _load(d, "gm")
    for variant, (flag, cap) in GM_VARIANTS.items():
        fluid.set_flags({"FLAGS_tpu_sharded_weight_update": flag,
                         "FLAGS_tpu_comm_bucket_mb": cap})
        main, startup, loss = build_gm_mlp(fluid)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        load_numpy_state(scope, state, "cpu")
        prog = fluid.CompiledProgram(main).with_data_parallel()
        losses, calls = [], []

        def count():
            return [collective_ops.stats.get(k, {}).get("calls", 0)
                    for k in GM_EXCHANGE_KINDS]

        for feed in gm_feeds():
            before = count()
            losses.append(exe.run(prog, feed=feed, fetch_list=[loss],
                                  scope=scope)[0])
            calls.append([a - b for a, b in zip(count(), before)])
        key = variant + "."
        out[key + "losses"] = np.stack(losses)
        out[key + "calls"] = np.array(calls)
        out[key + "sharded"] = np.array(len(
            main._shard_plan.sharded_state if main._shard_plan else ()))
        for n, v in logical_state(exe, main, scope, state).items():
            out[key + "state." + n] = v
    fluid.set_flags({"FLAGS_tpu_sharded_weight_update": True,
                     "FLAGS_tpu_comm_bucket_mb": 25.0})
    np.savez(os.path.join(d, "gm.rank%d.npz" % distributed.get_rank()),
             **out)


def zero_ranks(d):
    """A `distributed.spawn` target: case "zero" on this rank, its
    results in `<d>/zero.rank<r>.npz`."""
    import torch

    from paddle_tpu_torch import distributed

    torch.set_num_threads(2)
    out = {}
    _run_zero(out, d, distributed.get_world_size())
    np.savez(os.path.join(d, "zero.rank%d.npz" % distributed.get_rank()),
             **out)


def _gloo_bf16_sum(out, world):
    """A bf16 all-reduce over gloo against each rank's values summed in
    float32 and rounded once: `bf16_sum.exact` (every element equal) and
    `bf16_sum.max_ulps` (the largest difference in bf16 steps of the
    element's largest addend)."""
    import torch

    from paddle_tpu_torch.distributed import get_rank
    from paddle_tpu_torch.ops import collective_ops
    from paddle_tpu_torch.parallel import env as penv

    vals = [torch.randn(4096, generator=torch.Generator().manual_seed(r))
            .to(torch.bfloat16) for r in range(world)]
    got = collective_ops.all_reduce(vals[get_rank()], penv.global_mesh())
    want = sum(v.float() for v in vals).to(torch.bfloat16)
    scale = torch.stack([v.float().abs() for v in vals]).amax(0)
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    out["bf16_sum.exact"] = np.array(torch.equal(got, want))
    out["bf16_sum.max_ulps"] = np.array(float(
        ((got.float() - want.float()).abs() / ulp).max()))


def _run_zero_prefetched(out, d):
    """The Momentum MLP, sharded, fed by `reader.prefetch_to_device` with
    the executor's `feed_sharding` (this rank's rows only)."""
    from paddle_tpu_torch import fluid, reader
    from paddle_tpu_torch.core.scope import load_numpy_state
    from paddle_tpu_torch.distributed import get_rank

    fluid.set_flags({"FLAGS_tpu_sharded_weight_update": True,
                     "FLAGS_tpu_comm_bucket_mb": ZERO_CAP_MB})
    main, startup, loss = build_zero_mlp(fluid, **ZERO_MLPS["momentum"])
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    if get_rank() == 0:
        load_numpy_state(scope, _load(d, "zero_momentum"), "cpu")
    prog = fluid.CompiledProgram(main).with_data_parallel()
    losses = []
    with reader.prefetch_to_device(
            [zero_mlp_feed() for _ in range(ZERO_STEPS)],
            sharding=exe.feed_sharding(prog), device="cpu") as batches:
        for feed in batches:
            out["momentum.prefetch.rows"] = np.array(feed["img"].shape[0])
            losses.append(exe.run(prog, feed=feed, fetch_list=[loss],
                                  scope=scope)[0])
    out["momentum.prefetch.losses"] = np.stack(losses)


# -- the hybrid (dcn, ici) world -------------------------------------------

#: the hierarchical cases on 4 ranks, 2 pods of 2: the MLPs of
#: `ZERO_MLPS`, the Adam MLP at bf16 AMP O2 ("adam_amp"), the size-1 head
#: through fleet's explicit sync ("size1") and the conv net with
#: sync_batch_norm through fleet ("cnn"); the variants each world runs
#: (the hybrid world all of `ZERO_VARIANTS`; the flat one "on")
HIER_DCN, HIER_WORLD = 2, 4
HIER_MLPS = dict(ZERO_MLPS, adam_amp=dict(opt="adam", amp=True))


def hier_variants(case, dcn):
    if dcn == 1 or case == "cnn":
        return ["on"]
    return ["on", "off"] if case in ("adam_amp", "size1") \
        else list(ZERO_VARIANTS)


def _hier_build(fluid, case):
    from paddle_tpu_torch import fleet
    from paddle_tpu_torch.fluid.contrib import mixed_precision as mp

    if case == "size1":
        return build_zero_size1(fluid, fleet)
    if case == "cnn":
        return build_cnn(fluid, fleet_minimize(
            fluid, fleet, lambda: fluid.optimizer.SGDOptimizer(CNN["lr"]),
            sync_bn=True))
    c = dict(HIER_MLPS[case])
    amp = c.pop("amp", False)
    return build_zero_mlp(fluid, mp=mp if amp else None, **c)


def _hier_feed(case):
    return zero_size1_feed() if case == "size1" else \
        image_feed(CNN) if case == "cnn" else zero_mlp_feed()


def hier_ranks(d, dcn):
    """A `distributed.spawn` target: each case of `HIER_MLPS`, "size1"
    and "cnn" under `hier_variants` on a world of `dcn` pods
    (FLAGS_tpu_dcn_replicas), from `<d>/zero_<case>.state.npz` (rank 0
    loads it; the first run broadcasts it): the gathered losses, every
    persistable after the steps at its logical shape, the entry's
    `info()` numbers and `overlap_report`, keyed "<case>.<variant>.";
    the world's layout ("mesh.*") and this rank's rows of a global batch
    ("rows"); first every collective op's program of `_run_collective`
    ("coll.*", with the kinds `collective_ops.stats` counted). Results
    in `<d>/hier<dcn>.rank<r>.npz`."""
    import json

    import torch

    from paddle_tpu_torch import distributed, fluid
    from paddle_tpu_torch.core.scope import load_numpy_state
    from paddle_tpu_torch.parallel import env as penv

    from paddle_tpu_torch.ops import collective_ops

    torch.set_num_threads(1)
    rank = distributed.get_rank()
    out = {}
    fluid.set_flags({"FLAGS_tpu_dcn_replicas": dcn})
    # every collective op on the program's ring 0 (the pair, hybrid)
    collective_ops.reset_stats()
    coll = {}
    _run_collective(coll, rank, HIER_WORLD, table_rows=5 * HIER_WORLD)
    out.update(("coll." + k, v) for k, v in coll.items())
    out["coll.kinds"] = np.array(sorted(collective_ops.stats), dtype=str)
    for case in list(HIER_MLPS) + ["size1", "cnn"]:
        state = _load(d, "zero_" + case)
        for variant in hier_variants(case, dcn):
            flag, cap = ZERO_VARIANTS[variant]
            fluid.set_flags({"FLAGS_tpu_sharded_weight_update": flag,
                             "FLAGS_tpu_comm_bucket_mb": cap})
            main, startup, loss = _hier_build(fluid, case)
            exe = fluid.Executor(fluid.CPUPlace())
            scope = fluid.Scope()
            exe.run(startup, scope=scope)
            if rank == 0:
                load_numpy_state(scope, state, "cpu")
            prog = main if case in ("size1", "cnn") else \
                fluid.CompiledProgram(main).with_data_parallel()
            feed = _hier_feed(case)
            key = "%s.%s." % (case, variant)
            out[key + "losses"] = np.stack([
                exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)[0]
                for _ in range(ZERO_STEPS)])
            for n, v in logical_state(exe, main, scope, state).items():
                out[key + "state." + n] = v.astype("float32") \
                    if v.dtype.name == "bfloat16" else v
            for k, v in exe.last_entry.info().items():
                if k.startswith(("opt_state", "grad_buckets")):
                    out[key + "info." + k] = np.array(v)
            plan = main._shard_plan
            out[key + "local_bytes"] = np.array(sum(
                scope.find_var(n).numel() * scope.find_var(n).element_size()
                for n in (plan.sharded_state if plan else ())))
            out[key + "plan"] = np.array(json.dumps(None if plan is None else {
                "ndev": plan.ndev, "dcn_axis": plan.dcn_axis,
                "dcn_size": plan.dcn_size, "world": plan.world,
                "buckets": len(plan.buckets),
                "explicit_sync": plan.explicit_sync,
                "masters": len(plan.master_of)}))
            out[key + "overlap"] = np.array(json.dumps(exe.overlap_report(
                prog, feed=feed, fetch_list=[loss], scope=scope)))
            if case == "cnn":
                out[key + "bn_axis"] = np.array(json.dumps([
                    op.attrs.get("axis_name") for op in
                    main.global_block().ops if op.type == "sync_batch_norm"]))
            if case == "sgd" and variant == "on":
                ring = penv.program_ring(main)
                mesh = main._mesh
                out["mesh"] = np.array(json.dumps(None if mesh is None else {
                    "axis_names": mesh.axis_names, "shape": mesh.shape,
                    "coords": mesh.coords,
                    "hierarchy": penv.mesh_hierarchy(mesh),
                    "ici": mesh.ring("ici").ranks,
                    "dcn": mesh.ring("dcn").ranks,
                    "dp_axis": main._dp_axis, "dcn_axis": main._dcn_axis}))
                shard = exe.feed_sharding(prog)
                out["rows"] = np.array(
                    [ring.rank, ring.size] + list(shard.rows(64)))
                out["spec"] = np.array(json.dumps(shard.spec))
    np.savez(os.path.join(d, "hier%d.rank%d.npz" % (dcn, rank)), **out)


def reference_hier(d):
    """The JAX package's hierarchical sharded update on a (dcn 2, ici 2)
    mesh of 4 virtual CPU devices, from the start states in `<d>`: for
    each MLP of `HIER_MLPS` bucketed ("on", `ZERO_CAP_MB`), the Adam MLP
    one collective a variable too ("cap0"), and the size-1 head through
    fleet with FLAGS_tpu_dcn_replicas 2 (its transpile builds the hybrid
    mesh). Writes `<d>/ref_hier_<case>.<variant>.npz` (losses, every
    persistable at its logical shape)."""
    import jax
    from jax.sharding import Mesh

    jax.config.update("jax_platforms", "cpu")
    import paddle_tpu.fluid as rfluid
    from paddle_tpu import fleet as rfleet
    from paddle_tpu.core.scope import Scope
    from paddle_tpu.fluid.contrib import mixed_precision as rmp
    from paddle_tpu.parallel.sharded_update import unshard_scope_value
    from paddle_tpu.utils.flags import set_flags

    jobs = [(c, "on", ZERO_CAP_MB) for c in HIER_MLPS] + [
        ("adam_reg_fused", "cap0", 0.0), ("size1", "on", ZERO_CAP_MB)]
    for case, variant, cap in jobs:
        set_flags({"FLAGS_tpu_comm_bucket_mb": cap,
                   "FLAGS_tpu_sharded_weight_update": True,
                   "FLAGS_tpu_dcn_replicas": HIER_DCN if case == "size1"
                   else 0})
        if case == "size1":
            main, _, loss = build_zero_size1(rfluid, rfleet,
                                             nranks=HIER_WORLD)
            prog = main
        else:
            c = dict(HIER_MLPS[case])
            amp = c.pop("amp", False)
            main, _, loss = build_zero_mlp(rfluid, mp=rmp if amp else None,
                                           **c)
            main._mesh = Mesh(np.array(jax.devices()[:HIER_WORLD]).reshape(
                HIER_DCN, HIER_WORLD // HIER_DCN), ("dcn", "ici"))
            prog = rfluid.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name)
        state = _load(d, "zero_" + case)
        exe = rfluid.Executor(rfluid.CPUPlace())
        scope = Scope()
        for n, v in state.items():
            scope.set_var(n, jax.numpy.asarray(v))
        feed = _hier_feed(case)
        losses = np.stack([np.asarray(exe.run(
            prog, feed=feed, fetch_list=[loss.name], scope=scope)[0])
            for _ in range(ZERO_STEPS)])
        plan = main._shard_plan
        if plan is None or plan.dcn_axis != "dcn":
            raise RuntimeError("the reference did not shard %s over the "
                               "hybrid mesh" % case)
        out = {}
        for n in state:
            v = np.asarray(unshard_scope_value(
                main, n, np.asarray(scope.find_var(n))))
            out["state." + n] = v.astype("float32") \
                if v.dtype.name == "bfloat16" else v
        np.savez(os.path.join(d, "ref_hier_%s.%s.npz" % (case, variant)),
                 losses=losses, **out)


def start_reference_hier(d):
    """`reference_hier(d)` in a process of its own (JAX on the CPU, 4
    virtual devices)."""
    import subprocess

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO,
                                                              "tests")]),
               XLA_FLAGS="--xla_force_host_platform_device_count=%d"
               % HIER_WORLD)
    return subprocess.Popen(
        [sys.executable, "-c", "import torch_dp_runner as r; "
         "r.reference_hier(%r)" % d], env=env, cwd=REPO,
        start_new_session=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


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


def reference_zero(jobs):
    """The JAX package's sharded update for each (dir, name, world) of
    `jobs` (name "bert_amp" or one of `ZERO_MLPS`), on a mesh of `world`
    virtual CPU devices from `<dir>/zero_<name>.state.npz`: writes
    `<dir>/ref_<name>.npz` with the losses and every persistable after
    the steps at its logical shape (bfloat16 as float32). The tests run
    it in their process, and as a process of its own
    (`start_reference_zero`) beside the ranks."""
    import jax
    from jax.sharding import Mesh

    jax.config.update("jax_platforms", "cpu")
    import paddle_tpu.fluid as rfluid
    from paddle_tpu import fleet as rfleet
    from paddle_tpu.core.scope import Scope
    from paddle_tpu.fluid.contrib import mixed_precision as rmp
    from paddle_tpu.models import bert as rbert
    from paddle_tpu.parallel.sharded_update import unshard_scope_value
    from paddle_tpu.utils.flags import get_flags, set_flags
    from paddle_tpu_torch.models import bert as tbert

    saved = get_flags(["FLAGS_tpu_comm_bucket_mb"])
    set_flags({"FLAGS_tpu_comm_bucket_mb": ZERO_CAP_MB})
    try:
        _reference_zero_jobs(jobs, jax, Mesh, rfluid, rfleet, Scope, rmp,
                             rbert, unshard_scope_value, tbert)
    finally:
        set_flags(saved)


def _reference_zero_jobs(jobs, jax, Mesh, rfluid, rfleet, Scope, rmp,
                         rbert, unshard_scope_value, tbert):
    for d, name, world in jobs:
        if name == "bert_amp":
            main, _, loss = build_zero_bert(rfluid, rmp, rbert)
            feed = zero_bert_feed(tbert)
        elif name == "size1":
            main, _, loss = build_zero_size1(rfluid, rfleet, nranks=world)
            feed = zero_size1_feed()
        else:
            main, _, loss = build_zero_mlp(rfluid, **ZERO_MLPS[name])
            feed = zero_mlp_feed()
        state = _load(d, "zero_" + name)
        prog = main  # fleet's transpile installed its mesh
        if name != "size1":
            main._mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))
            prog = rfluid.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name)
        exe = rfluid.Executor(rfluid.CPUPlace())
        scope = Scope()
        for n, v in state.items():
            scope.set_var(n, jax.numpy.asarray(v))
        losses = np.stack([np.asarray(exe.run(
            prog, feed=feed, fetch_list=[loss.name], scope=scope)[0])
            for _ in range(1 if name == "bert_amp" else ZERO_STEPS)])
        if main._shard_plan is None:
            raise RuntimeError("the reference did not shard %s" % name)
        out = {}
        for n in state:
            v = np.asarray(unshard_scope_value(
                main, n, np.asarray(scope.find_var(n))))
            out["state." + n] = v.astype("float32") \
                if v.dtype.name == "bfloat16" else v
        np.savez(os.path.join(d, "ref_%s.npz" % name), losses=losses,
                 **out)


def start_reference_zero(jobs):
    """`reference_zero(jobs)` in a process of its own (JAX on the CPU,
    as many virtual devices as the largest world)."""
    import subprocess

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO,
                                                              "tests")]),
               XLA_FLAGS="--xla_force_host_platform_device_count=%d"
               % max(w for _, _, w in jobs))
    code = "import torch_dp_runner as r; r.reference_zero(%r)" % (
        list(jobs),)
    return subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                            start_new_session=True,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


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
