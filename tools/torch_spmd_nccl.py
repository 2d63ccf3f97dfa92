#!/usr/bin/env python3
"""The SPMD trainer over NCCL, one rank a card.

    python3 tools/torch_spmd_nccl.py [--steps 3]
    python3 tools/torch_spmd_nccl.py --cpu --nprocs 4   # a rehearsal

On a machine with 4 cards this runs `paddle_tpu_torch.parallel.
transformer` at the default `SPMDConfig` (vocab 32000, d_model 768, 12
heads, d_ff 3072, seq 512, 12 layers, bf16, remat; random weights from
seed 0), 4 microbatches of the global batch of 8 (`demo_batch`, seed 0),
on four meshes of 4 ranks, each a spawn over NCCL with one rank a card:
dp1 pp2 tp2 (Megatron), dp2 pp1 tp2 (Megatron), dp4 pp1 tp1 and dp1 pp1
tp4 (Ulysses, 3 heads a rank); 1 warm-up step and `--steps` timed
steps. Then one process on card 0 runs the same steps from the same
params (dp = pp = tp = 1) as the yardstick. Prints one JSON line: for
each mesh the per-rank median step ms, tokens/s (the global batch's
tokens over the slowest rank's median), the scaling against the one
card (its median over the mesh's slowest rank's), the losses and their
largest relative difference from the one card's (at most 1e-2 in bf16),
peak memory and flash launches a rank; then the cards' names and power
limits. `--cpu` runs the same meshes over gloo on the CPU at the CPU
tests' widths (vocab 64, d_model 32, 4 heads, d_ff 64, seq 16, 4 layers,
fp32, 1e-4 on the losses) to rehearse them. Exits non-zero if a rank
fails, a loss is not finite or the losses differ beyond the bound.
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

MESHES = {
    "dp1_pp2_tp2_megatron": dict(dp=1, pp=2, tp=2, sp_mode="megatron"),
    "dp2_pp1_tp2_megatron": dict(dp=2, pp=1, tp=2, sp_mode="megatron"),
    "dp4_pp1_tp1": dict(dp=4, pp=1, tp=1, sp_mode="megatron"),
    "dp1_pp1_tp4_ulysses": dict(dp=1, pp=1, tp=4, sp_mode="ulysses"),
}
N_MICRO, BATCH, WARMUP = 4, 8, 1
CPU = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, seq_len=16,
           n_layers=4, dtype="float32", remat=False)
LOSS_RTOL = {"bfloat16": 1e-2, "float32": 1e-4}


def worker(out_path, mesh_kw, cfg_kw, steps, cpu):
    import torch

    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel import transformer as tt

    if cpu:
        torch.set_num_threads(2)
    rank = distributed.get_rank()
    cfg = tt.SPMDConfig(n_micro=N_MICRO, **cfg_kw, **mesh_kw)
    mesh = cfg.mesh(device="cpu" if cpu else None)
    params = tt.shard_params(tt.init_params(cfg, seed=0, device=mesh.device),
                             cfg, mesh)
    opt = tt.init_opt_state(params)
    step = tt.make_train_step(cfg, mesh)
    tokens, labels = tt.demo_batch(cfg, BATCH, seed=0)

    def sync():
        if not cpu:
            torch.cuda.synchronize()

    losses, step_ms = [], []
    for i in range(WARMUP + steps):
        if i == WARMUP:
            sync()
            if not cpu:
                torch.cuda.reset_peak_memory_stats()
            fa.fwd_launches = fa.dkv_launches = fa.dq_launches = 0
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, tokens, labels, i)
        losses.append(float(loss))
        sync()
        if i >= WARMUP:
            step_ms.append((time.perf_counter() - t0) * 1e3)
    with open(out_path % rank, "w") as f:
        json.dump({"losses": losses, "step_ms": step_ms,
                   "device": str(mesh.device), "backend": mesh.backend,
                   "peak_mem_bytes": 0 if cpu
                   else torch.cuda.max_memory_allocated(),
                   "flash_launches": {"forward": fa.fwd_launches,
                                      "dkv": fa.dkv_launches,
                                      "dq": fa.dq_launches}}, f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--nprocs", type=int, default=4,
                    help="ranks of each mesh (4)")
    ap.add_argument("--timeout", type=float, default=600,
                    help="seconds each spawn's ranks may take")
    args = ap.parse_args()
    import torch

    from paddle_tpu_torch import distributed

    if args.nprocs != 4:
        print("torch_spmd_nccl: the meshes have 4 ranks", file=sys.stderr)
        return 1
    if not args.cpu and torch.cuda.device_count() < 4:
        print("torch_spmd_nccl: needs 4 cards (use --cpu to rehearse)",
              file=sys.stderr)
        return 1
    cfg_kw = CPU if args.cpu else {}
    dtype = cfg_kw.get("dtype", "bfloat16")
    backend = "gloo" if args.cpu else "nccl"
    out_dir = tempfile.mkdtemp(prefix="spmd_nccl_")

    def run(name, mesh_kw, nprocs):
        path = os.path.join(out_dir, name + ".%d.json")
        t0 = time.perf_counter()
        distributed.spawn(worker, (path, mesh_kw, cfg_kw, args.steps,
                                   args.cpu), nprocs=nprocs,
                          backend=backend, timeout=args.timeout)
        print("torch_spmd_nccl: %s done in %.1f s" % (
            name, time.perf_counter() - t0), file=sys.stderr, flush=True)
        ranks = []
        for r in range(nprocs):
            with open(path % r) as f:
                ranks.append(json.load(f))
        return ranks

    single = run("single", dict(dp=1, pp=1, tp=1), 1)[0]
    seq = cfg_kw.get("seq_len", 512)
    tokens = N_MICRO * BATCH * seq
    single_med = statistics.median(single["step_ms"])
    res = {"tool": "torch_spmd_nccl", "backend": backend, "dtype": dtype,
           "n_micro": N_MICRO, "global_batch": BATCH, "steps": args.steps,
           "tokens_per_step": tokens,
           "single": {"median_step_ms": single_med,
                      "tokens_per_sec": tokens / (single_med / 1e3),
                      "losses": single["losses"],
                      "peak_mem_bytes": single["peak_mem_bytes"],
                      "flash_launches": single["flash_launches"]},
           "meshes": {}}
    ok = all(math.isfinite(x) for x in single["losses"])
    for name, mesh_kw in MESHES.items():
        ranks = run(name, mesh_kw, 4)
        med = [statistics.median(r["step_ms"]) for r in ranks]
        err = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"],
                                                      single["losses"]))
        same = all(r["losses"] == ranks[0]["losses"] for r in ranks)
        res["meshes"][name] = dict(
            mesh_kw, median_step_ms=med,
            step_ms=[r["step_ms"] for r in ranks],
            tokens_per_sec=tokens / (max(med) / 1e3),
            scaling_vs_single=single_med / max(med),
            losses=ranks[0]["losses"], loss_rel_err_vs_single=err,
            losses_equal_across_ranks=same,
            peak_mem_bytes=[r["peak_mem_bytes"] for r in ranks],
            flash_launches=[r["flash_launches"] for r in ranks],
            devices=[r["device"] for r in ranks],
            backend=ranks[0]["backend"])
        ok = ok and same and err <= LOSS_RTOL[dtype] and all(
            math.isfinite(x) for x in ranks[0]["losses"])
    print(json.dumps(res), flush=True)
    if not args.cpu:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
