"""Spawn target of the port's mesh tests: one rank of a world that
`paddle_tpu_torch.distributed.spawn` starts over gloo on the CPU.

`run(spec_path, out_dir)` reads the JSON spec the test wrote and runs
its jobs in turn, each rank writing `<job>.rank<r>.npz` into `out_dir`:

- "train": the SPMD trainer on a `cfg.mesh()`, from the global params in
  an npz (`shard_params`), `steps` steps of `demo_batch(cfg, batch,
  seed)`: the losses and the step-0 gradients gathered to global shapes
  (`params_to_numpy`, keys "grad/<leaf path>");
- "errors": the messages of a mesh whose size is not the world's, of a
  mesh on the default device where there is no card, and of a batch
  that does not split over dp;
- "collectives": each autograd collective of `mesh_collectives` on the
  inputs in an npz (one [world, ...] array a case: rank r takes row r),
  its output and the gradient of sum(output * cotangent);
- "ulysses": `ulysses_attention_sharded` on global q, k, v over the whole
  world as the sequence axis, with the plain attention and with the
  flash function's plain version, causal or not: the output shard and
  the gradients of this rank's rows of sum(output * w); then the message
  of 3 heads on a world that does not divide them.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _tree(flat):
    out = {}
    for path, v in flat.items():
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _train(job):
    from paddle_tpu_torch.parallel import transformer as tt

    cfg = tt.SPMDConfig(**job["cfg"])
    mesh = cfg.mesh(device="cpu")
    with np.load(job["params"]) as f:
        params = tt.shard_params(_tree(dict(f)), cfg, mesh)
    opt = tt.init_opt_state(params)
    step = tt.make_train_step(cfg, mesh, with_grads=True,
                              attn_impl=job.get("attn_impl", "auto"))
    tokens, labels = tt.demo_batch(cfg, job["batch"], seed=job["seed"])
    out = {"losses": []}
    for i in range(job["steps"]):
        params, opt, loss, grads = step(params, opt, tokens, labels, i)
        out["losses"].append(float(loss))
        if i == 0:
            out.update(("grad/" + k, v) for k, v in _flat(
                tt.params_to_numpy(grads, cfg, mesh)))
    return out


def _errors(job):
    from paddle_tpu_torch.parallel import transformer as tt

    out = {}
    try:
        tt.SPMDConfig(dp=2, pp=2, tp=2).mesh(device="cpu")
    except ValueError as e:
        out["world"] = str(e)
    cfg = tt.SPMDConfig(**job["cfg"])
    try:
        cfg.mesh()
    except RuntimeError as e:
        out["no_card"] = str(e)
    mesh = cfg.mesh(device="cpu")
    params = tt.shard_params(tt.init_params(cfg, device="cpu"), cfg, mesh)
    step = tt.make_train_step(cfg, mesh)
    tokens, labels = tt.demo_batch(cfg, job["batch"])
    try:
        step(params, tt.init_opt_state(params), tokens, labels, 0)
    except ValueError as e:
        out["batch"] = str(e)
    return out


def _collectives(job):
    import torch

    from paddle_tpu_torch.parallel import env as penv
    from paddle_tpu_torch.parallel import mesh_collectives as mc

    n = penv.world_size()
    mesh = penv.Mesh(("x",), (n,), device="cpu")
    ring, r = mesh.ring("x"), mesh.rank
    fns = {
        "all_gather": lambda x: mc.all_gather(x, ring, 1),
        "all_gather_untiled": lambda x: mc.all_gather(x, ring, 0,
                                                      tiled=False),
        "psum_scatter": lambda x: mc.psum_scatter(x, ring, 1),
        "ppermute": lambda x: mc.ppermute(
            x, ring, [(i, (i + 1) % n) for i in range(n)]),
        "ppermute_partial": lambda x: mc.ppermute(
            x, ring, [(i, i + 1) for i in range(n - 1)]),
        "all_to_all": lambda x: mc.all_to_all(x, ring, 0, 1),
    }
    out = {}
    with np.load(job["inputs"]) as f:
        for name, fn in fns.items():
            x = torch.tensor(f[name + "/x"][r], requires_grad=True)
            y = fn(x)
            (y * torch.tensor(f[name + "/ct"][r])).sum().backward()
            out[name + "/y"] = y.detach().numpy()
            out[name + "/dx"] = x.grad.numpy()
        x = torch.tensor(f["all_gather/x"][r])
        out["psum/y"] = mc.psum(x, [ring]).numpy()
    return out


def _ulysses(job):
    import torch

    from paddle_tpu_torch.parallel import env as penv
    from paddle_tpu_torch.parallel.ulysses import ulysses_attention_sharded

    n = penv.world_size()
    mesh = penv.Mesh(("sp",), (n,), device="cpu")
    out = {}
    with np.load(job["inputs"]) as f:
        for flash in (False, True):
            for causal in (False, True):
                qkv = [torch.tensor(f[k], requires_grad=True) for k in "qkv"]
                y = ulysses_attention_sharded(*qkv, mesh, causal=causal,
                                              use_flash=flash)
                s = y.shape[1]
                rows = slice(mesh.rank * s, (mesh.rank + 1) * s)
                (y * torch.tensor(f["w"][:, rows])).sum().backward()
                tag = "%s/%s" % ("flash" if flash else "plain",
                                 "causal" if causal else "full")
                out[tag + "/y"] = y.detach().numpy()
                for k, t in zip("qkv", qkv):
                    out["%s/d%s" % (tag, k)] = t.grad[:, rows].numpy()
    try:
        bad = torch.zeros(1, 4 * n, 3, 8)
        ulysses_attention_sharded(bad, bad, bad, mesh)
    except ValueError as e:
        out["divisibility"] = str(e)
    return out


JOBS = {"train": _train, "errors": _errors, "collectives": _collectives,
        "ulysses": _ulysses}


def run(spec_path, out_dir):
    import torch

    from paddle_tpu_torch import distributed

    torch.set_num_threads(1)
    rank = distributed.get_rank()
    with open(spec_path) as f:
        jobs = json.load(f)
    for job in jobs:
        res = JOBS[job["kind"]](job)
        np.savez(os.path.join(out_dir, "%s.rank%d.npz" % (job["name"], rank)),
                 **{k: np.asarray(v) for k, v in res.items()})


def start(jobs, out_dir, nprocs, tag):
    """Write the spec of `jobs` and spawn `nprocs` gloo ranks on it
    (without waiting): the spawn's context."""
    from paddle_tpu_torch import distributed

    spec = os.path.join(out_dir, "spec.%s.json" % tag)
    with open(spec, "w") as f:
        json.dump(jobs, f)
    return distributed.spawn(run, (spec, out_dir), nprocs=nprocs,
                             backend="gloo", join=False)


def results(out_dir, name, nprocs):
    """Each rank's results of job `name`."""
    out = []
    for r in range(nprocs):
        with np.load(os.path.join(out_dir, "%s.rank%d.npz" % (name, r))) \
                as f:
            out.append(dict(f))
    return out
