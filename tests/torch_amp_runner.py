"""Worker of tests/test_torch_amp.py's data-parallel cases: one rank of a
world that `paddle_tpu_torch.distributed.spawn` starts over gloo on the
CPU (`run(d)`), and the JAX package's counterpart on a mesh of virtual
CPU devices (`reference(d, world)`, in the test's process).

Every case is the MLP of `build`, from the start state in
`<d>/start_<case>.npz` (the reference's startup), fed the global batch of
`feeds()` (each rank keeps its rows), through
`CompiledProgram.with_data_parallel`:
- "f16_replicated" / "f16_zero": float16 O2 with dynamic loss scaling
  over SGD, the sharded update off / on. The third batch puts 1e4 into
  input feature 3, whose weight row lies in rank 0's shard of
  `fc_0.w_0`: its scaled gradient overflows there only, so only the
  found-inf count's all-reduce makes rank 1 skip too;
- "lamb_zero" / "lars_zero": float32 LAMB (global-norm clip) and LARS
  with the sharded update on: their norms are sums over the shards.
Each writes the losses and every persistable at its logical shape.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CASES = ("f16_replicated", "f16_zero", "lamb_zero", "lars_zero")
STEPS, BATCH = 4, 16
SPIKE_STEP, SPIKE_FEATURE = 2, 3


def build(fluid, mp, case):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        img = fluid.layers.data(name="img", shape=[32], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=img, size=16, act="relu")
        logits = fluid.layers.fc(input=h, size=4)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            logits, label))
        if case.startswith("f16"):
            mp.decorate(fluid.optimizer.SGDOptimizer(0.1),
                        amp_dtype="float16", init_loss_scaling=256.0,
                        incr_every_n_steps=2, decr_every_n_nan_or_inf=1,
                        decr_ratio=0.5).minimize(loss)
        elif case == "lamb_zero":
            fluid.optimizer.LambOptimizer(
                0.01, grad_clip=fluid.clip.GradientClipByGlobalNorm(
                    0.5)).minimize(loss)
        else:
            fluid.optimizer.LarsMomentumOptimizer(
                0.1, momentum=0.9, lars_coeff=0.01).minimize(loss)
    return main, startup, loss


def feeds():
    r = np.random.RandomState(4)
    out = []
    for i in range(STEPS):
        x = r.rand(BATCH, 32).astype("float32")
        if i == SPIKE_STEP:
            x[:, SPIKE_FEATURE] = 1e4
        out.append({"img": x, "label": r.randint(0, 4, (BATCH, 1))
                    .astype("int64")})
    return out


def flags(case):
    return {"FLAGS_tpu_sharded_weight_update": case != "f16_replicated",
            "FLAGS_tpu_comm_bucket_mb": 0.0}


def _persistables(program):
    return sorted(v.name for v in program.list_vars() if v.persistable)


def run(d):
    """One rank: every case in turn."""
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.core.scope import load_numpy_state
    from paddle_tpu_torch.core.types import to_numpy
    from paddle_tpu_torch.distributed import get_rank
    from paddle_tpu_torch.fluid.contrib import mixed_precision as mp
    from paddle_tpu_torch.utils.flags import set_flags

    torch.set_num_threads(1)
    rank = get_rank()
    for case in CASES:
        set_flags(flags(case))
        main, startup, loss = build(fluid, mp, case)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        with np.load(os.path.join(d, "start_%s.npz" % case)) as f:
            load_numpy_state(scope, dict(f), "cpu")
        prog = fluid.CompiledProgram(main).with_data_parallel()
        losses = [exe.run(prog, feed=feed, fetch_list=[loss],
                          scope=scope)[0] for feed in feeds()]
        out = {"__losses__": np.stack(losses),
               "__sharded__": np.array(exe.last_entry.info()[
                   "opt_state_sharded_vars"])}
        out.update({n: to_numpy(exe.read_logical(n, main, scope))
                    for n in _persistables(main)})
        np.savez(os.path.join(d, "%s.rank%d.npz" % (case, rank)), **out)


def write_starts(d):
    """The reference's startup state of every case, as
    `<d>/start_<case>.npz`."""
    import paddle_tpu.fluid as rfluid
    from paddle_tpu.core.scope import Scope
    from paddle_tpu.fluid.contrib import mixed_precision as rmp

    for case in CASES:
        main, startup, _ = build(rfluid, rmp, case)
        scope = Scope()
        with rfluid.scope_guard(scope):
            rfluid.Executor(rfluid.CPUPlace()).run(startup)
        np.savez(os.path.join(d, "start_%s.npz" % case),
                 **{n: np.asarray(scope.find_var(n))
                    for n in _persistables(main)})


def reference(d, world):
    """The JAX package's runs of every case on a `world`-device mesh from
    the start states. Returns {case: {"__losses__": ..., name: value at
    its logical shape}}."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import paddle_tpu.fluid as rfluid
    from paddle_tpu.core.scope import Scope
    from paddle_tpu.fluid.contrib import mixed_precision as rmp
    from paddle_tpu.utils import flags as rflags

    saved = rflags.get_flags(list(flags(CASES[0])))
    out = {}
    try:
        for case in CASES:
            rflags.set_flags(flags(case))
            main, startup, loss = build(rfluid, rmp, case)
            exe, scope = rfluid.Executor(rfluid.CPUPlace()), Scope()
            with np.load(os.path.join(d, "start_%s.npz" % case)) as f:
                for n, v in f.items():
                    scope.set_var(n, jnp.asarray(v))
            with rfluid.scope_guard(scope):
                rfluid.CompiledProgram(main).with_data_parallel(
                    loss_name=loss.name)
                main._mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))
                losses = [np.asarray(exe.run(main, feed=feed,
                                             fetch_list=[loss])[0])
                          for feed in feeds()]
                res = {"__losses__": np.stack(losses)}
                plan = getattr(main, "_shard_plan", None)
                for n in _persistables(main):
                    v = np.asarray(scope.find_var(n))
                    info = plan.sharded_state.get(n) if plan else None
                    res[n] = info.unshard(v) if info is not None else v
            out[case] = res
    finally:
        rflags.set_flags(saved)
    return out
