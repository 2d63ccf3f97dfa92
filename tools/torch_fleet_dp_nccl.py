#!/usr/bin/env python3
"""Fleet DP ResNet50 with one rank a card over NCCL, with the sharded
weight update (ZeRO-1, the default) and without it.

    python3 tools/torch_fleet_dp_nccl.py [--steps 5] [--batch 128]
        [--modes dp,dp_eager,dp_eager2,dp_off,dp_eager_off,single]
        [--dcn 2]
    python3 tools/torch_fleet_dp_nccl.py --cpu --nprocs 4   # a rehearsal

On a machine with N cards this spawns N ranks over NCCL, each on its own
card: `chip_smoke.py`'s phase 9 leg a ResNet50 (224 x 224, 1000 classes,
scan_stages, bf16 AMP O2 over Momentum(0.1, 0.9), fused Momentum)
through `fleet.distributed_optimizer`, `--batch` images a rank from the
global batch, 2 warm-up steps and `--steps` timed steps. Each job of
`--modes` starts from the same startup state: "dp" with its block
captured (the first step eager, the second captured, the rest replays),
"dp_eager" and "dp_eager2" with `FLAGS_cuda_graphs` off (eager), all
three with the sharded update (fleet's 89 gradient all-reduces lowered
to bucketed reduce-scatters, the velocities and AMP masters held as 1/N
slices, the params all-gathered); "dp_off" (captured) and "dp_eager_off"
the same without it (89 all-reduces); "single" one process on card 0
without fleet at the same per-rank batch, captured, as the yardstick.
Prints one JSON line: for each job per-rank median step ms, the job's
images/s, peak memory a rank, the optimizer-state bytes a rank holds
against the logical ones, the collectives a step (eager jobs: host ms,
calls and MB; a captured job's replays run them on the card), the
entry's mode and losses; the captured against the eager job, the two
eager jobs, and the sharded update against the replicated one (captured
and eager), each where both jobs ran, as equal flags and the largest
loss and state differences (rank 0's state at its logical shape); every
job's first losses (the forward of one start state, before any update);
whether every parameter and optimizer state is bit-equal across the
ranks; then the cards' names and power limits. `--dcn K` runs the fleet
jobs on a hybrid world of K pods (``FLAGS_tpu_dcn_replicas``: the
gradient sums within the pod, then across pods, the sharded state laid
out within the pod); each job also reports the pods, the optimizer-state
bytes a rank holds and `Executor.overlap_report` (bucket 0, and every
collective's launch against the backward), and the collectives a step
split by axis. Set ``FLAGS_cudnn_deterministic=1`` in the environment
for jobs that repeat bit for bit (cuDNN's timed algorithm choice
otherwise differs between runs). Rank 0 reports its progress on stderr;
`--timeout` bounds each spawn (a rank that outlives it fails the run).
`--cpu` runs the same path over gloo on the CPU at 32 x 32, 10 classes,
2 images a rank (eagerly), to rehearse it without cards.

    python3 tools/torch_fleet_dp_nccl.py --checkpoint [--steps 3]
    python3 tools/torch_fleet_dp_nccl.py --checkpoint --cpu --nprocs 4

runs the checkpoint mode instead, with ``FLAGS_cudnn_deterministic`` on
and the sharded update: a flat job (captured) takes `--steps` steps,
`fluid.checkpoint.save_checkpoint` (every rank, rank 0 writes), and
`--steps` more (the uninterrupted losses); a fresh executor and scope
of the same world load the checkpoint and take the same steps (must be
bit-equal); then a job on 2 pods (``FLAGS_tpu_dcn_replicas`` 2) loads
the flat job's checkpoint and takes them too. Its first step's exchanged
gradients, read from the Momentum velocities (after the step, less 0.9
times the loaded ones), must lie within one bf16 unit (2^-8) of the flat
resume's, relative in norm, the bound `chip_smoke.py` phase 15 holds a
hybrid step to: the pods-first bf16 sums round twice where the flat sum
rounds once, and ResNet50 amplifies that in the later losses, which are
reported beside `HYBRID_GAP`. Prints one JSON line with the losses, the
checkpoint's MB, the save, load and step ms, then the cards' names and
power limits. Exits non-zero
if a rank fails, a loss is not finite, the replicas differ, or the
captured losses or state differ from the eager ones where the two eager
runs agree (else by more than twice their difference, the rule of
`chip_smoke.py` phase 11).
"""
import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _HERE)

import chip_smoke as cs  # noqa: E402

CPU = dict(img=32, classes=10)
MODES = ("dp", "dp_eager", "dp_eager2", "dp_off", "dp_eager_off", "single")
#: the checkpoint mode's report of the hybrid resume against the flat
#: one: the gap in the losses between the hybrid and the flat jobs that
#: `--dcn 2` measured on four cards from one start state
HYBRID_GAP = 3.7e-3
#: Momentum's coefficient in `chip_smoke.build_fluid_resnet`
MOMENTUM = 0.9


def worker(out_dir, cfg, mode):
    """One rank of `mode`: "dp" (fleet, captured), "dp_eager" and
    "dp_eager2" (fleet, FLAGS_cuda_graphs off), "dp_off" and
    "dp_eager_off" (the same without the sharded update) or "single"
    (no fleet, captured)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import distributed, fleet, fluid
    from paddle_tpu_torch.ops import collective_ops

    fleet_on = mode != "single"
    if cfg["cpu"]:
        torch.set_num_threads(2)
    if fleet_on and cfg["dcn"] > 1:
        fluid.set_flags({"FLAGS_tpu_dcn_replicas": cfg["dcn"]})
    if mode.startswith("dp_eager"):
        fluid.set_flags({"FLAGS_cuda_graphs": False})
    fluid.set_flags({"FLAGS_tpu_sharded_weight_update":
                     not mode.endswith("_off")})
    rank = distributed.get_rank()
    n = distributed.get_world_size()

    def progress(what):
        if rank == 0:
            print("torch_fleet_dp_nccl: %s %s" % (mode, what),
                  file=sys.stderr, flush=True)

    progress("world of %d up" % n)
    main, startup, loss = cs.build_fluid_resnet(
        fluid, cfg["img"], cfg["classes"], 0.1, not cfg["cpu"],
        strategy=fleet.DistributedStrategy() if fleet_on else None)
    exe = fluid.Executor(fluid.CPUPlace() if cfg["cpu"] else None)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = cs.resnet_feed(cfg["batch"] * n, cfg["img"], cfg["classes"])

    def step():
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        if not cfg["cpu"]:
            torch.cuda.synchronize()
        return out.ravel().tolist()

    progress("startup done")
    losses = []
    for k in range(2):
        losses.append(step())
        progress("warm-up step %d: %s" % (k, exe.last_entry.phase))
    if not cfg["cpu"]:
        torch.cuda.reset_peak_memory_stats()
    collective_ops.reset_stats()
    step_ms = []
    for _ in range(cfg["steps"]):
        t0 = time.perf_counter()
        losses.append(step())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    stats = {k: dict(v) for k, v in collective_ops.stats.items()}
    info = exe.last_entry.info()
    # (getattr: the tool also drives an older checkout, timed against
    # this one in the same call, whose executor has no overlap_report)
    overlap = getattr(exe, "overlap_report", lambda *a, **k: None)(
        main, feed=feed, fetch_list=[loss], scope=scope) if fleet_on \
        else None
    mesh = getattr(main, "_mesh", None)
    names = sorted(v.name for v in main.list_vars() if v.persistable
                   and not v.name.endswith(("_bn_mean", "_bn_var")))
    # at the logical shape: every rank gathers the sharded vars alike
    state = {n: exe.read_logical(n, main, scope) for n in names}
    if rank == 0:
        np.savez(os.path.join(out_dir, "%s.state.npz" % mode), **{
            n: v.detach().float().cpu().numpy() for n, v in state.items()})
    cs.fleet_dump(os.path.join(out_dir, "%s%d.json" % (mode, rank)), {
        "losses": losses, "step_ms": step_ms, "device": str(exe.device),
        "peak_mem_bytes": (0 if cfg["cpu"]
                           else torch.cuda.max_memory_allocated()),
        "mode": exe.last_entry.mode, "reason": exe.last_entry.reason,
        "opt_state": {k: v for k, v in info.items()
                      if k.startswith(("opt_state", "grad_buckets"))},
        "collectives": stats,
        "pods": list(mesh.shape.values()) if mesh else None,
        "overlap": overlap,
        "c_allreduce_sum_ops": [op.type for op in main.global_block().ops]
        .count("c_allreduce_sum"),
        "digest": {n: cs.digest(v) for n, v in state.items()}})


def ckpt_worker(out_dir, cfg, job):
    """One rank of the checkpoint mode: "flat" (steps, save, steps, then
    a fresh executor and scope loaded from the checkpoint, the same
    steps) or "hybrid" (2 pods: the flat job's checkpoint loaded, the
    same steps)."""
    import torch

    from paddle_tpu_torch import distributed, fleet, fluid
    from paddle_tpu_torch.fluid import checkpoint

    if cfg["cpu"]:
        torch.set_num_threads(2)
    fluid.set_flags({"FLAGS_cudnn_deterministic": True,
                     "FLAGS_tpu_sharded_weight_update": True})
    if job == "hybrid":
        fluid.set_flags({"FLAGS_tpu_dcn_replicas": 2})
    rank = distributed.get_rank()
    n = distributed.get_world_size()
    main, startup, loss = cs.build_fluid_resnet(
        fluid, cfg["img"], cfg["classes"], 0.1, not cfg["cpu"],
        strategy=fleet.DistributedStrategy())
    feed = cs.resnet_feed(cfg["batch"] * n, cfg["img"], cfg["classes"])
    root = os.path.join(out_dir, "ckpt")

    def executor():
        return fluid.Executor(fluid.CPUPlace() if cfg["cpu"] else None)

    def sync():
        if not cfg["cpu"]:
            torch.cuda.synchronize()

    def steps(exe, scope, k=cfg["steps"]):
        out, ms = [], []
        for _ in range(k):
            t0 = time.perf_counter()
            out.append(exe.run(main, feed=feed, fetch_list=[loss],
                               scope=scope)[0].ravel().tolist())
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, ms

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        return r, (time.perf_counter() - t0) * 1e3

    res = {}
    if job == "flat":
        exe, scope = executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        res["first"], _ = steps(exe, scope)
        _, res["save_ms"] = timed(lambda: checkpoint.save_checkpoint(
            exe, root, checkpoint.TrainStatus(0, cfg["steps"]), main,
            scope=scope))
        res["losses"], res["step_ms"] = steps(exe, scope)
        res["phase"] = exe.last_entry.phase
        res["opt_state"] = {k: v for k, v in exe.last_entry.info().items()
                            if k.startswith("opt_state")}
        exe.close()
        del exe, scope
    exe, scope = executor(), fluid.Scope()
    st, res["load_ms"] = timed(lambda: checkpoint.load_checkpoint(
        exe, root, main, scope=scope))
    res["status_step"] = st.step_no
    velocities = [n for n in sorted(v.name for v in main.list_vars()
                                    if v.persistable) if "velocity" in n]
    v0 = torch.cat([scope.find_var(n).reshape(-1).float()
                    for n in velocities])
    first, first_ms = steps(exe, scope, 1)
    # the first step's exchanged gradients (every rank gathers alike)
    grads = torch.cat([exe.read_logical(n, main, scope).reshape(-1).float()
                       for n in velocities]) - MOMENTUM * v0
    if rank == 0:
        torch.save(grads.cpu(), os.path.join(out_dir, job + ".grads.pt"))
    del v0, grads
    rest, rest_ms = steps(exe, scope, cfg["steps"] - 1)
    res["resumed"], res["resumed_step_ms"] = first + rest, first_ms + rest_ms
    res["resumed_phase"] = exe.last_entry.phase
    mesh = getattr(main, "_mesh", None)
    res["pods"] = list(mesh.shape.values()) if mesh else None
    res["mb"] = cs.ckpt_dir_mb(root)
    cs.fleet_dump(os.path.join(out_dir, "%s%d.json" % (job, rank)), res)


def checkpoint_mode(args, cfg, n, backend):
    import torch

    from paddle_tpu_torch import distributed

    out_dir = tempfile.mkdtemp(prefix="fleet_ckpt_")
    for job in ("flat", "hybrid"):
        distributed.spawn(ckpt_worker, (out_dir, cfg, job), nprocs=n,
                          backend=backend, timeout=args.timeout)

    def read(name):
        with open(os.path.join(out_dir, name)) as f:
            return json.load(f)

    flat = [read("flat%d.json" % r) for r in range(n)]
    hybrid = [read("hybrid%d.json" % r) for r in range(n)]
    f0, h0 = flat[0], hybrid[0]
    gap = max(abs(x - y) for a, b in zip(h0["resumed"], f0["losses"])
              for x, y in zip(a, b))
    g_flat = torch.load(os.path.join(out_dir, "flat.grads.pt")).double()
    g_hybrid = torch.load(os.path.join(out_dir, "hybrid.grads.pt")).double()
    grad_rel = float((g_hybrid - g_flat).norm() / g_flat.norm())
    res = {"tool": "torch_fleet_dp_nccl", "mode": "checkpoint", "ranks": n,
           "backend": backend, "per_rank_batch": cfg["batch"],
           "img": cfg["img"], "steps": cfg["steps"],
           "devices": [str(torch.cuda.get_device_name(0))]
           if not args.cpu else ["cpu"],
           "first_losses": f0["first"], "losses": f0["losses"],
           "resumed_losses": f0["resumed"],
           "resumed_bit_equal": all(r["losses"] == r["resumed"]
                                    for r in flat),
           "hybrid_losses": h0["resumed"], "hybrid_pods": h0["pods"],
           "hybrid_max_loss_diff": gap, "hybrid_gap_pr14": HYBRID_GAP,
           "hybrid_within_pr14_gap": gap <= HYBRID_GAP,
           "hybrid_first_step_grad_rel_norm": grad_rel,
           "hybrid_grad_bound": cs.HYBRID_A_GRAD_RTOL,
           "phase": f0["phase"], "resumed_phase": f0["resumed_phase"],
           "hybrid_phase": h0["resumed_phase"],
           "opt_state": f0["opt_state"], "mb": f0["mb"],
           "save_ms": [r["save_ms"] for r in flat],
           "load_ms": [r["load_ms"] for r in flat],
           "hybrid_load_ms": [r["load_ms"] for r in hybrid],
           "step_ms": [r["step_ms"] for r in flat],
           "resumed_step_ms": [r["resumed_step_ms"] for r in flat],
           "status_step": [r["status_step"] for r in flat + hybrid]}
    print(json.dumps(res), flush=True)
    if not args.cpu:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    ok = res["resumed_bit_equal"] and grad_rel <= cs.HYBRID_A_GRAD_RTOL \
        and all(
        math.isfinite(v) for s in f0["losses"] for v in s) \
        and all(s == cfg["steps"] for s in res["status_step"])
    return 0 if ok else 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=None,
                    help="timed steps (default 5); the checkpoint mode's "
                         "steps before and after the save (default 3)")
    ap.add_argument("--batch", type=int, default=None,
                    help="images a rank (default 128; 2 with --cpu)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--nprocs", type=int, default=None,
                    help="ranks (default: the card count)")
    ap.add_argument("--timeout", type=float, default=900,
                    help="seconds each spawn's ranks may take")
    ap.add_argument("--dcn", type=int, default=1,
                    help="pods of the fleet jobs' world (1: flat)")
    ap.add_argument("--modes", default=",".join(MODES),
                    help="the jobs to run, of %s" % ", ".join(MODES))
    ap.add_argument("--checkpoint", action="store_true",
                    help="the checkpoint mode (see the module docstring)")
    args = ap.parse_args()
    import torch

    from paddle_tpu_torch import distributed

    if not args.cpu and not torch.cuda.is_available():
        print("torch_fleet_dp_nccl: no CUDA device (use --cpu to "
              "rehearse)", file=sys.stderr)
        return 1
    n = args.nprocs or (1 if args.cpu else torch.cuda.device_count())
    cfg = dict(cs.FLEET_A, batch=args.batch or (2 if args.cpu else 128),
               steps=args.steps or (3 if args.checkpoint else 5),
               cpu=args.cpu, dcn=args.dcn)
    if args.cpu:
        cfg.update(CPU)
    backend = "gloo" if args.cpu else "nccl"
    if args.checkpoint:
        return checkpoint_mode(args, cfg, n, backend)
    out_dir = tempfile.mkdtemp(prefix="fleet_nccl_")
    modes = args.modes.split(",")
    for mode in MODES:
        if mode in modes:
            distributed.spawn(worker, (out_dir, cfg, mode),
                              nprocs=1 if mode == "single" else n,
                              backend=backend, timeout=args.timeout)

    def read(name):
        with open(os.path.join(out_dir, name)) as f:
            return json.load(f)

    first = next(m for m in MODES if m in modes and m != "single")
    ranks = [read("%s%d.json" % (first, r)) for r in range(n)]
    eager2 = read("dp_eager20.json") if "dp_eager2" in modes else None

    def max_diff(a, b):
        return max(abs(x - y) for sa, sb in zip(a, b) for x, y in zip(sa, sb))

    def state_diff(a, b):
        """The largest absolute difference of rank 0's state after the
        steps between jobs `a` and `b`, and the var it is in."""
        import numpy as np

        with np.load(os.path.join(out_dir, a + ".state.npz")) as fa, \
                np.load(os.path.join(out_dir, b + ".state.npz")) as fb:
            diffs = {k: float(np.max(np.abs(
                fa[k].astype("float64") - fb[k].astype("float64"))))
                for k in fa.files}
        worst = max(diffs, key=diffs.get)
        return {"max_abs": diffs[worst], "var": worst,
                "vars_differing": sum(v > 0 for v in diffs.values())}

    def job(mode, nprocs):
        rs = [read("%s%d.json" % (mode, r)) for r in range(nprocs)]
        med = [statistics.median(r["step_ms"]) for r in rs]
        steps = len(rs[0]["step_ms"])
        ov = rs[0]["overlap"]
        return dict({"median_step_ms": med,
                     "step_ms": [r["step_ms"] for r in rs],
                     "images_per_sec": cfg["batch"] * nprocs
                     / (max(med) / 1e3),
                     "peak_mem_bytes": [r["peak_mem_bytes"] for r in rs],
                     "opt_state": rs[0]["opt_state"],
                     "pods": rs[0]["pods"],
                     "overlap": ov and dict(
                         {k: v for k, v in ov.items() if k != "collectives"},
                         bucket0=ov["collectives"][0] if ov["collectives"]
                         else None,
                         backward_after=[c["backward_after"]
                                         for c in ov["collectives"]]),
                     "mode": rs[0]["mode"], "reason": rs[0]["reason"],
                     "losses": rs[0]["losses"]},
                    **cs.collectives_per_step(
                        [r["collectives"] for r in rs], steps))

    def compare(a, b):
        ra, rb = read(a + "0.json"), read(b + "0.json")
        return {"losses_equal": ra["losses"] == rb["losses"],
                "state_equal": ra["digest"] == rb["digest"],
                "max_loss_diff": max_diff(ra["losses"], rb["losses"]),
                "state_diff": state_diff(a, b)}

    differ = sorted(
        "%s:%s" % (m, k) for m in modes if m != "single"
        for rs in [[read("%s%d.json" % (m, r)) for r in range(n)]]
        for k in rs[0]["digest"]
        if any(r["digest"][k] != rs[0]["digest"][k] for r in rs[1:]))
    res = {"tool": "torch_fleet_dp_nccl", "ranks": n, "backend": backend,
           "per_rank_batch": cfg["batch"], "img": cfg["img"],
           "dcn": cfg["dcn"],
           "devices": [r["device"] for r in ranks],
           "c_allreduce_sum_ops": ranks[0]["c_allreduce_sum_ops"],
           "replicas_bit_equal": not differ,
           "env": {k: v for k, v in os.environ.items()
                   if k.startswith(("NCCL_", "FLAGS_", "CUBLAS_"))}}
    for mode in modes:
        res[mode] = job(mode, 1 if mode == "single" else n)
    # every job's first losses: the forward of the same start state
    res["step0_losses"] = {m: res[m]["losses"][0] for m in modes}
    if "dp" in modes and "dp_eager" in modes:
        res["captured_vs_eager"] = compare("dp", "dp_eager")
    if eager2 is not None:
        res["eager_vs_eager2"] = compare("dp_eager2", "dp_eager")
    for on, off in (("dp", "dp_off"), ("dp_eager", "dp_eager_off")):
        if off in modes:
            res["sharded_vs_replicated_" + ("captured" if on == "dp"
                                            else "eager")] = compare(on, off)
    if "single" in modes:
        res["scaling_vs_single"] = res["dp"]["images_per_sec"] / \
            res["single"]["images_per_sec"]
    print(json.dumps(res), flush=True)
    if not args.cpu:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    ce, ee = res.get("captured_vs_eager"), res.get("eager_vs_eager2")
    eager_equal = ee is not None and ee["losses_equal"] \
        and ee["state_equal"]
    ok = not differ and all(
        math.isfinite(v) and len(s) == (1 if m == "single" else n)
        for m in modes for s in res[m]["losses"] for v in s) \
        and (ce is None or ce["losses_equal"] and ce["state_equal"]
             or ee is not None and not eager_equal
             and ce["max_loss_diff"] <= 2 * ee["max_loss_diff"]
             and ce["state_diff"]["max_abs"]
             <= 2 * ee["state_diff"]["max_abs"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
