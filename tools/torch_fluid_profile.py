#!/usr/bin/env python3
"""Where the time of the port's fluid static-graph step goes, on one
NVIDIA GPU.

    python3 tools/torch_fluid_profile.py [--opt sgd|adam] [--steps N]
                                         [--bert LEG | --resnet] [--out DIR]

Builds the MNIST MLP of chip_smoke.py's fluid phase (784-128-64-10,
batch 64, the optimizer given, default SGD) through `fluid.layers` ->
`minimize` -> `Executor()` on the card, runs the startup program and
three warm-up steps, then traces the next N steps (default 10) with
`torch.profiler` (CPU and CUDA activity). With ``--bert a_s128`` or
``--bert b_s4096`` it builds that leg of chip_smoke.py's fluid BERT
phase instead (BERT-base, bf16 AMP O2, fused Adam); with ``--resnet``
leg a of its fluid ResNet50 phase (batch 128, 224 x 224, bf16 AMP O2,
fused Momentum). Prints one JSON object: the window's wall time a step,
the device time a step summed over kernels (the device's busy share is
that over the wall time), the kernels launched a step, the device time a
step by kernel family (convolutions, layout transposes, batch norm,
pooling, elementwise and casts, the optimizer's foreach kernels,
reductions, GEMMs; a kernel matches the first family whose word its
name holds, the rest is "other"; each with its three largest kernels),
the twelve kernels with the most device time and the twelve host
operators with the most self time. With --out, the Chrome trace of the
window is written there.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the same model, data and batch)

#: kernel family -> words of its kernels' names (lower case), first match
FAMILIES = (
    ("layout transposes", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("convolutions", ("conv", "dgrad", "wgrad", "fprop", "xmma",
                      "implicit_gemm", "winograd")),
    ("batch norm", ("batch_norm",)),
    ("pooling", ("pool",)),
    ("optimizer foreach", ("foreach", "multi_tensor")),
    ("reductions", ("reduce",)),
    ("gemm", ("gemm", "nvjet", "cutlass")),
    ("elementwise and casts", ("elementwise", "copy", "cast", "fill")),
)


def _family(name):
    low = name.lower()
    return next((fam for fam, words in FAMILIES
                 if any(w in low for w in words)), "other")


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--opt", choices=("sgd", "adam"), default="sgd")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--bert", default=None,
                    choices=[leg["name"] for leg in
                             chip_smoke.BERT_FLUID_LEGS])
    ap.add_argument("--resnet", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1

    from paddle_tpu_torch import fluid

    if args.resnet:
        c = chip_smoke.RESNET_A
        main_prog, startup, loss = chip_smoke.build_fluid_resnet(
            fluid, c["img"], c["classes"], c["lr"], c["amp"])
        feeds, fetch, b = [chip_smoke.resnet_feed(
            c["batch"], c["img"], c["classes"])], [loss], c["batch"]
    elif args.bert:
        from paddle_tpu_torch.models import bert

        leg = {leg["name"]: leg for leg in chip_smoke.BERT_FLUID_LEGS}[
            args.bert]
        cfg = chip_smoke.bert_cfg(leg["seq"])
        main_prog, startup, loss, _ = chip_smoke.build_fluid_bert(
            fluid, cfg, leg["seq"], leg["remat"])
        feeds, fetch, b = [bert.bert_feed(cfg, leg["batch"],
                                          leg["seq"])], [loss], leg["batch"]
    else:
        main_prog, startup, loss, acc = chip_smoke.build_fluid_mlp(
            fluid, args.opt)
        x, y = chip_smoke.fluid_mnist_data()
        b = chip_smoke.FLUID_BATCH
        feeds = [{"img": x[i * b:(i + 1) * b],
                  "label": y[i * b:(i + 1) * b]}
                 for i in range(len(x) // b)]
        fetch = [loss, acc]
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)

    def step(i):
        return exe.run(main_prog, feed=feeds[i % len(feeds)],
                       fetch_list=fetch, scope=scope)

    for i in range(3):
        step(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.steps):
            out = step(3 + i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    kernels = [(e.key, _device_us(e), e.count) for e in events
               if "cuda" in str(e.device_type).lower()]
    kernels = sorted((k for k in kernels if k[1] > 0), key=lambda k: -k[1])
    host = sorted(((e.key, e.self_cpu_time_total, e.count) for e in events
                   if "cuda" not in str(e.device_type).lower()),
                  key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    n = args.steps
    families = {}
    for name, us, calls in kernels:  # most device time first
        fam = families.setdefault(_family(name), {"device_us": 0.0,
                                                  "calls": 0, "top": []})
        fam["device_us"] += us / n
        fam["calls"] += calls / n
        if len(fam["top"]) < 3:
            fam["top"].append(name[:80])
    for fam in families.values():
        fam["share"] = fam["device_us"] * n / busy if busy else None
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            args.out, "fluid_%s_trace.json" % (
                "resnet" if args.resnet else args.bert or args.opt)))
    if args.resnet:
        model, opt = "resnet50", "momentum (bf16 AMP O2, fused)"
    elif args.bert:
        model, opt = "bert " + args.bert, "adam (bf16 AMP O2, fused)"
    else:
        model, opt = "mnist mlp", args.opt
    print(json.dumps({
        "model": model, "opt": opt,
        "window_steps": n, "batch": b,
        "loss": float(out[0][0]), "wall_us_per_step": wall_us / n,
        "device_busy_us_per_step": busy / n,
        "device_busy_share": busy / wall_us if wall_us else None,
        "kernels_per_step": sum(k[2] for k in kernels) / n,
        "kernel_families_per_step": families,
        "top_kernels": [{"name": k[0][:100], "device_us": k[1],
                         "calls": k[2]} for k in kernels[:12]],
        "top_host_ops": [{"name": k[0][:100], "self_cpu_us": k[1],
                          "calls": k[2]} for k in host[:12]],
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": chip_smoke.nvidia_smi_line()}))
    return 0


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


if __name__ == "__main__":
    sys.exit(main())
