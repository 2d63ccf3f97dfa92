#!/usr/bin/env python3
"""Fleet DP ResNet50 with one rank a card over NCCL.

    python3 tools/torch_fleet_dp_nccl.py [--steps 5] [--batch 128]
    python3 tools/torch_fleet_dp_nccl.py --cpu --nprocs 4   # a rehearsal

On a machine with N cards this spawns N ranks over NCCL, each on its own
card: `chip_smoke.py`'s phase 9 leg a ResNet50 (224 x 224, 1000 classes,
scan_stages, bf16 AMP O2 over Momentum(0.1, 0.9), fused Momentum)
through `fleet.distributed_optimizer`, `--batch` images a rank from the
global batch, 2 warm-up steps and `--steps` timed steps, each with its
89 NCCL gradient all-reduces. The job runs three times from the same
startup state: with its block captured (the first step eager, the
second captured, the rest replays) and twice with `FLAGS_cuda_graphs`
off (eager). Then one process on card 0 runs the same program without
fleet at the same per-rank batch, captured, as the yardstick. Prints
one JSON line: per-rank median step ms of the captured and of the eager
job, the job's images/s, the single process's figures, peak memory a
rank, the entries' modes, the captured and eager losses and their
largest difference beside that of the two eager runs, and whether
every parameter and optimizer state is bit-equal across the ranks;
then the cards' names and power limits. Rank 0 reports its progress on
stderr; `--timeout` bounds each spawn (a rank that outlives it fails
the run). `--cpu` runs the same path over gloo on the CPU at 32 x 32,
10 classes, 2 images a rank (eagerly), to rehearse it without cards.
Exits non-zero if a rank fails, a loss is not finite, the replicas
differ, or the captured losses differ from the eager ones where the
two eager runs agree (else by more than twice their difference, the
rule of `chip_smoke.py` phase 11).
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


def worker(out_dir, cfg, mode):
    """One rank of `mode`: "dp" (fleet, captured), "dp_eager" and
    "dp_eager2" (fleet, FLAGS_cuda_graphs off) or "single" (no fleet,
    captured)."""
    import torch

    from paddle_tpu_torch import distributed, fleet, fluid

    fleet_on = mode != "single"
    if cfg["cpu"]:
        torch.set_num_threads(2)
    if mode.startswith("dp_eager"):
        fluid.set_flags({"FLAGS_cuda_graphs": False})
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
    step_ms = []
    for _ in range(cfg["steps"]):
        t0 = time.perf_counter()
        losses.append(step())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    names = sorted(v.name for v in main.list_vars() if v.persistable
                   and not v.name.endswith(("_bn_mean", "_bn_var")))
    cs.fleet_dump(os.path.join(out_dir, "%s%d.json" % (mode, rank)), {
        "losses": losses, "step_ms": step_ms, "device": str(exe.device),
        "peak_mem_bytes": (0 if cfg["cpu"]
                           else torch.cuda.max_memory_allocated()),
        "mode": exe.last_entry.mode, "reason": exe.last_entry.reason,
        "c_allreduce_sum_ops": [op.type for op in main.global_block().ops]
        .count("c_allreduce_sum"),
        "digest": cs.fleet_state_digest(scope, names)})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=None,
                    help="images a rank (default 128; 2 with --cpu)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--nprocs", type=int, default=None,
                    help="ranks (default: the card count)")
    ap.add_argument("--timeout", type=float, default=900,
                    help="seconds each spawn's ranks may take")
    args = ap.parse_args()
    import torch

    from paddle_tpu_torch import distributed

    if not args.cpu and not torch.cuda.is_available():
        print("torch_fleet_dp_nccl: no CUDA device (use --cpu to "
              "rehearse)", file=sys.stderr)
        return 1
    n = args.nprocs or (1 if args.cpu else torch.cuda.device_count())
    cfg = dict(cs.FLEET_A, batch=args.batch or (2 if args.cpu else 128),
               steps=args.steps, cpu=args.cpu)
    if args.cpu:
        cfg.update(CPU)
    backend = "gloo" if args.cpu else "nccl"
    out_dir = tempfile.mkdtemp(prefix="fleet_nccl_")
    for mode, nprocs in (("dp", n), ("dp_eager", n), ("dp_eager2", n),
                         ("single", 1)):
        distributed.spawn(worker, (out_dir, cfg, mode), nprocs=nprocs,
                          backend=backend, timeout=args.timeout)

    def read(name):
        with open(os.path.join(out_dir, name)) as f:
            return json.load(f)

    ranks = [read("dp%d.json" % r) for r in range(n)]
    eager = [read("dp_eager%d.json" % r) for r in range(n)]
    eager2 = read("dp_eager20.json")

    def max_diff(a, b):
        return max(abs(x - y) for sa, sb in zip(a, b) for x, y in zip(sa, sb))

    single = read("single0.json")
    med = [statistics.median(r["step_ms"]) for r in ranks]
    eager_med = [statistics.median(r["step_ms"]) for r in eager]
    single_med = statistics.median(single["step_ms"])
    differ = sorted(k for k in ranks[0]["digest"] if any(
        r["digest"][k] != ranks[0]["digest"][k] for r in ranks[1:]))
    res = {"tool": "torch_fleet_dp_nccl", "ranks": n, "backend": backend,
           "per_rank_batch": cfg["batch"], "img": cfg["img"],
           "losses": ranks[0]["losses"], "median_step_ms": med,
           "step_ms": [r["step_ms"] for r in ranks],
           "images_per_sec": cfg["batch"] * n / (max(med) / 1e3),
           "peak_mem_bytes": [r["peak_mem_bytes"] for r in ranks],
           "devices": [r["device"] for r in ranks],
           "mode": ranks[0]["mode"], "reason": ranks[0]["reason"],
           "c_allreduce_sum_ops": ranks[0]["c_allreduce_sum_ops"],
           "replicas_bit_equal": not differ,
           "eager": {"median_step_ms": eager_med,
                     "images_per_sec": cfg["batch"] * n
                     / (max(eager_med) / 1e3),
                     "mode": eager[0]["mode"],
                     "reason": eager[0]["reason"]},
           "eager_losses": eager[0]["losses"],
           "losses_equal_eager": ranks[0]["losses"] == eager[0]["losses"],
           "state_equal_eager": ranks[0]["digest"] == eager[0]["digest"],
           "max_loss_diff_vs_eager": max_diff(ranks[0]["losses"],
                                              eager[0]["losses"]),
           "eager_runs_equal": eager2["losses"] == eager[0]["losses"]
           and eager2["digest"] == eager[0]["digest"],
           "max_loss_diff_eager_runs": max_diff(eager2["losses"],
                                                eager[0]["losses"]),
           "single": {"median_step_ms": single_med,
                      "images_per_sec": cfg["batch"] / (single_med / 1e3),
                      "peak_mem_bytes": single["peak_mem_bytes"],
                      "mode": single["mode"]}}
    res["scaling_vs_single"] = res["images_per_sec"] / \
        res["single"]["images_per_sec"]
    print(json.dumps(res), flush=True)
    if not args.cpu:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    ok = not differ and all(math.isfinite(v) for s in res["losses"]
                            for v in s) and len(res["losses"][0]) == n \
        and (res["losses_equal_eager"] or not res["eager_runs_equal"]
             and res["max_loss_diff_vs_eager"]
             <= 2 * res["max_loss_diff_eager_runs"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
