"""Spawn targets and a subprocess worker of the port's checkpoint tests,
on the CPU over gloo.

- `zero_ranks(d, dcn)`: a `distributed.spawn` target. The fleet Adam
  MLP with the sharded weight update (ZeRO-1) on a flat world or on
  `dcn` pods: 2 steps, then `save_persistables` (per-var files),
  `fluid.save` and `checkpoint.save_checkpoint` from every rank (rank 0
  writes), 2 more steps; then a fresh executor and scope load each of
  the three and run the same 2 steps. Each rank writes
  `zero.rank<r>.npz`: the losses, every persistable at its logical
  shape (`read_logical`) when saved, and the losses after each load.
- `agree_ranks(d)`: a `distributed.spawn` target (``PADDLE_CKPT_AGREE=1``
  from the launcher's contract). Each rank saves 3 numbered checkpoints
  of its own MLP into a directory of its own; rank 1 truncates its
  newest; `load_checkpoint` then agrees on the newest step every rank
  can load. Writes `agree.rank<r>.npz`.
- `mesh_save(d, tp)`: a `distributed.spawn` target. The SPMD trainer at
  `MESH_CFG` on a tp mesh of the world, from the global params in
  `<d>/init.npz`: `STEPS` steps, `ShardedCheckpointManager.save` of the
  params and Adam moments (with their specs), `STEPS` more steps; then a
  restore into the same mesh's layout and the same `STEPS` steps. Rank 0
  writes `mesh_save.npz`: the tree gathered to global shapes at the
  save, both runs' losses.
- `mesh_restore(d, tp)`: a `distributed.spawn` target: the step saved on
  another mesh restored into a tp mesh of this world: each rank's
  blocks, and the tree gathered back (`mesh_restore.rank<r>.npz`).
- `python torch_ckpt_runner.py kill <dir> <kill_at>`: an MLP trained 6
  steps with a checkpoint after each; with `kill_at` > 0 the process
  dies (``os._exit``) at the publication seam of that step's
  checkpoint, its payload written. A run resumes from the newest
  checkpoint under `<dir>` and prints each step's loss.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

MLP_LR = 0.05
STEPS = 2


def build_mlp(fluid, minimize, seed=7):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        x = fluid.layers.data(name="x", shape=[12], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=24, act="relu")
        logits = fluid.layers.fc(input=h, size=5)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            logits, y))
        minimize(loss)
    return main, startup, loss


def mlp_feed(batch=8, seed=3):
    r = np.random.RandomState(seed)
    return {"x": r.randn(batch, 12).astype("float32"),
            "y": r.randint(0, 5, (batch, 1)).astype("int64")}


def _fleet_adam(fluid, fleet):
    def minimize(loss):
        fleet.distributed_optimizer(
            fluid.optimizer.AdamOptimizer(learning_rate=MLP_LR),
            fleet.DistributedStrategy()).minimize(loss)
    return minimize


def zero_ranks(d, dcn):
    import torch

    from paddle_tpu_torch import distributed, fleet, fluid
    from paddle_tpu_torch.core.types import to_numpy
    from paddle_tpu_torch.fluid import checkpoint, io

    torch.set_num_threads(1)
    if dcn > 1:
        fluid.set_flags({"FLAGS_tpu_dcn_replicas": dcn})
    fluid.set_flags({"FLAGS_tpu_sharded_weight_update": True})
    fleet.init(is_collective=True)
    rank = distributed.get_rank()
    n = distributed.get_world_size()
    main, startup, loss = build_mlp(fluid, _fleet_adam(fluid, fleet))
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    feed = mlp_feed(batch=2 * n)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)

    def steps(e, s, k):
        return np.stack([e.run(main, feed=feed, fetch_list=[loss],
                               scope=s)[0] for _ in range(k)])

    out = {"before": steps(exe, scope, STEPS)}
    out["sharded_vars"] = np.array(
        exe.last_entry.info()["opt_state_sharded_vars"])
    out["axes"] = np.array(",".join(main._mesh.axis_names)
                           if main._mesh is not None else "dp")
    for nm in names:
        out["logical." + nm] = to_numpy(exe.read_logical(nm, main, scope))
    with fluid.scope_guard(scope):
        io.save_persistables(exe, os.path.join(d, "persist"), main)
        io.save(main, os.path.join(d, "model", "m"))
    checkpoint.save_checkpoint(exe, os.path.join(d, "ckpt"),
                               checkpoint.TrainStatus(0, STEPS), main,
                               scope=scope)
    out["after"] = steps(exe, scope, STEPS)
    for how in ("persist", "model", "ckpt"):
        e2 = fluid.Executor(fluid.CPUPlace())
        s2 = fluid.Scope()
        e2.run(startup, scope=s2)
        with fluid.scope_guard(s2):
            if how == "persist":
                io.load_persistables(e2, os.path.join(d, "persist"), main)
            elif how == "model":
                io.load(main, os.path.join(d, "model", "m"), e2)
            else:
                st = checkpoint.load_checkpoint(e2, os.path.join(d, "ckpt"),
                                                main, scope=s2)
                out["status_step"] = np.array(st.step_no)
        # the scope holds the logical values until the next run lays
        # them out as this rank's slices
        out["loaded_logical." + how] = np.array(all(
            tuple(s2.find_var(nm).shape) == out["logical." + nm].shape
            for nm in names))
        out["resumed." + how] = steps(e2, s2, STEPS)
    np.savez(os.path.join(d, "zero.rank%d.npz" % rank), **out)


def agree_ranks(d):
    import torch

    from paddle_tpu_torch import distributed, fluid
    from paddle_tpu_torch.fluid import checkpoint

    torch.set_num_threads(1)
    rank = distributed.get_rank()
    main, startup, loss = build_mlp(
        fluid, lambda l: fluid.optimizer.SGDOptimizer(MLP_LR).minimize(l))
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    root = os.path.join(d, "rank%d" % rank)
    feed = mlp_feed()
    for step in range(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        checkpoint.save_checkpoint(exe, root,
                                   checkpoint.TrainStatus(0, step), main,
                                   scope=scope)
    if rank == 1:
        with open(os.path.join(checkpoint.latest_checkpoint_dir(root),
                               "persistables.pkl"), "wb") as f:
            f.write(b"\x00truncated")
    distributed.barrier()
    st = checkpoint.load_checkpoint(exe, root, main, scope=scope)
    np.savez(os.path.join(d, "agree.rank%d.npz" % rank),
             step=np.array(st.step_no),
             agree=np.array(os.environ.get("PADDLE_CKPT_AGREE", "")))


def kill_main(d, kill_at):
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import checkpoint

    torch.set_num_threads(1)
    main, startup, loss = build_mlp(
        fluid, lambda l: fluid.optimizer.AdamOptimizer(MLP_LR).minimize(l))
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    st = checkpoint.load_checkpoint(exe, d, main, scope=scope)
    start = st.step_no + 1 if st is not None else 0
    print("RESUME %d" % start, flush=True)
    feeds = [mlp_feed(seed=s) for s in range(6)]

    def die(tmp):
        os._exit(9)

    for step in range(start, 6):
        loss_v = exe.run(main, feed=feeds[step], fetch_list=[loss],
                         scope=scope)[0]
        print("step %d: %r" % (step, float(loss_v.ravel()[0])), flush=True)
        if kill_at and step == kill_at:
            checkpoint._before_publish = die
        checkpoint.save_checkpoint(exe, d, checkpoint.TrainStatus(0, step),
                                   main, scope=scope)


#: the trainer's tiny config of the mesh cases (float32 compute)
MESH_CFG = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, seq_len=16,
                n_layers=2, dtype="float32", use_flash=False)


def _mesh_trees(tt, cfg):
    specs = tt.param_specs(cfg)
    return specs, {"params": specs, "opt": (specs, specs)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], "%s%s/" % (prefix, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, "%s%d/" % (prefix, i))
    else:
        yield prefix[:-1], tree


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out


def _gathered(tt, cfg, mesh, state):
    return {"params": tt.params_to_numpy(state["params"], cfg, mesh),
            "opt": tuple(tt.params_to_numpy(m, cfg, mesh)
                         for m in state["opt"])}


def mesh_save(d, tp):
    import torch

    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.distributed import ShardedCheckpointManager
    from paddle_tpu_torch.parallel import transformer as tt

    torch.set_num_threads(1)
    cfg = tt.SPMDConfig(tp=tp, **MESH_CFG)
    mesh = cfg.mesh(device="cpu")
    _, specs = _mesh_trees(tt, cfg)
    with np.load(os.path.join(d, "init.npz")) as f:
        params = tt.shard_params(_unflat(dict(f)), cfg, mesh)
    opt = tt.init_opt_state(params)
    step = tt.make_train_step(cfg, mesh)
    tokens, labels = tt.demo_batch(cfg, 2)

    def run(p, o, k0):
        losses = []
        for k in range(STEPS):
            p, o, loss = step(p, o, tokens, labels, k0 + k)
            losses.append(float(loss))
        return p, o, losses

    params, opt, _ = run(params, opt, 0)
    state = {"params": params, "opt": opt}
    mgr = ShardedCheckpointManager(os.path.join(d, "ckpt"), max_to_keep=2)
    mgr.save(STEPS, state, specs=specs, mesh=mesh)
    saved = _gathered(tt, cfg, mesh, state)
    _, _, after = run(params, opt, STEPS)
    template = {"params": tt._tree_map(torch.zeros_like, params),
                "opt": tuple(tt._tree_map(torch.zeros_like, m)
                             for m in opt)}
    back = mgr.restore(template=template, specs=specs, mesh=mesh)
    _, _, resumed = run(back["params"], tuple(back["opt"]), STEPS)
    if distributed.get_rank() == 0:
        np.savez(os.path.join(d, "mesh_save.npz"), after=np.array(after),
                 resumed=np.array(resumed),
                 steps=np.array(mgr.all_steps()),
                 **{"saved/" + k: v for k, v in _flat(saved)})


def mesh_restore(d, tp):
    import torch

    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.distributed import ShardedCheckpointManager
    from paddle_tpu_torch.parallel import transformer as tt

    torch.set_num_threads(1)
    cfg = tt.SPMDConfig(tp=tp, **MESH_CFG)
    mesh = cfg.mesh(device="cpu")
    _, specs = _mesh_trees(tt, cfg)
    with np.load(os.path.join(d, "init.npz")) as f:
        params = tt.shard_params(_unflat(dict(f)), cfg, mesh)
    template = {"params": tt._tree_map(torch.zeros_like, params),
                "opt": tuple(tt._tree_map(torch.zeros_like, params)
                             for _ in range(2))}
    mgr = ShardedCheckpointManager(os.path.join(d, "ckpt"))
    back = mgr.restore(template=template, specs=specs, mesh=mesh)
    out = {"local/" + k: v.numpy() for k, v in _flat(back)}
    out.update(("gathered/" + k, v) for k, v in _flat(
        _gathered(tt, cfg, mesh, back)))
    np.savez(os.path.join(d, "mesh_restore.rank%d.npz"
                          % distributed.get_rank()), **out)


if __name__ == "__main__":
    if sys.argv[1] == "kill":
        kill_main(sys.argv[2], int(sys.argv[3]))
