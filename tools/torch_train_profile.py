#!/usr/bin/env python3
"""Where the time of the port's training step goes, on one NVIDIA GPU.

    python3 tools/torch_train_profile.py [--steps N] [--out DIR]

Builds the trainer of chip_smoke.py (the default `SPMDConfig`: vocab
32000, d_model 768, 12 heads, d_ff 3072, seq 512, 12 layers, bf16
compute, remat; random weights from seed 0; batch 8), runs two warm-up
steps, then traces the next N steps (default 1) with `torch.profiler`
(CPU and CUDA activity). Prints one JSON object: the window's wall time,
the device time summed over kernels (the device's busy share is that over
the wall time), the device time of the three flash attention kernels and
of the matrix products (kernel names holding gemm, xmma, cutlass or
nvjet, cuBLAS's Hopper GEMMs), of the copy kernels (names holding copy),
and the twenty kernels with the most device time. With --out, the Chrome trace
of the window is written there.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the same configuration and batch)

#: name stems of the flash kernels, each matching both designs (SIMT and,
#: for bf16 forward and dQ, tensor cores: fa_fwd_tc_kernel, ...)
FLASH_KERNELS = ("fa_fwd", "fa_bwd_dkv", "fa_bwd_dq")
GEMM_MARKS = ("gemm", "xmma", "cutlass", "nvjet")


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--steps", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1

    from paddle_tpu_torch.parallel import transformer as tt

    cfg = tt.SPMDConfig()
    params = tt.init_params(cfg, seed=0)
    opt = tt.init_opt_state(params)
    step = tt.make_train_step(cfg)
    tokens, labels = tt.demo_batch(cfg, chip_smoke.TRAIN_BATCH, seed=0)
    for i in range(2):
        params, opt, _ = step(params, opt, tokens, labels, i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.steps):
            params, opt, loss = step(params, opt, tokens, labels, 2 + i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, _device_us(e), e.count)
               for e in prof.key_averages()
               if "cuda" in str(e.device_type).lower()]
    kernels = [k for k in kernels if k[1] > 0]
    busy = sum(k[1] for k in kernels)
    flash = {name: sum(k[1] for k in kernels if name in k[0])
             for name in FLASH_KERNELS}
    flash_calls = {name: sum(k[2] for k in kernels if name in k[0])
                   for name in FLASH_KERNELS}
    gemm = sum(k[1] for k in kernels
               if any(m in k[0].lower() for m in GEMM_MARKS))
    copies = [k for k in kernels if "copy" in k[0].lower()]
    kernels.sort(key=lambda k: -k[1])
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out,
                                              "train_step_trace.json"))
    print(json.dumps({
        "window_steps": args.steps, "batch": chip_smoke.TRAIN_BATCH,
        "loss": float(loss), "wall_us": wall_us, "device_busy_us": busy,
        "device_busy_share": busy / wall_us if wall_us else None,
        "flash_us": flash, "flash_calls": flash_calls,
        "flash_share_of_device": sum(flash.values()) / busy if busy
        else None,
        "gemm_us": gemm, "gemm_share_of_device": gemm / busy if busy
        else None,
        "copy_us": sum(k[1] for k in copies),
        "copy_calls": sum(k[2] for k in copies),
        "top_kernels": [{"name": k[0][:120], "device_us": k[1],
                         "calls": k[2]} for k in kernels[:20]]}))
    return 0


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


if __name__ == "__main__":
    sys.exit(main())
