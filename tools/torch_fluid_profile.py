#!/usr/bin/env python3
"""Where the time of the port's fluid static-graph step goes, on one
NVIDIA GPU.

    python3 tools/torch_fluid_profile.py [--opt sgd|adam] [--steps N]
                                         [--bert LEG | --resnet |
                                          --transformer] [--eager]
                                         [--out DIR]

Builds the MNIST MLP of chip_smoke.py's fluid phase (784-128-64-10,
batch 64, the optimizer given, default SGD) through `fluid.layers` ->
`minimize` -> `Executor()` on the card, runs the startup program and
three warm-up steps, then traces the next N steps (default 10) with
`torch.profiler` (CPU and CUDA activity). The step is captured as a
CUDA graph in the warm-up (its second step), so the window holds
replays; ``--eager`` turns capture off (`FLAGS_cuda_graphs`) and traces
eager steps. With ``--bert a_s128`` or
``--bert b_s4096`` it builds that leg of chip_smoke.py's fluid BERT
phase instead (BERT-base, bf16 AMP O2, fused Adam); with ``--resnet``
leg a of its fluid ResNet50 phase (batch 128, 224 x 224, bf16 AMP O2,
fused Momentum); with ``--transformer`` leg a of its fluid Transformer
phase (Transformer-big, batch 32 x 128, bf16 AMP O2, fused Adam), and
then also traces a beam-search decode over the trained scope (leg b's
32 sentences at beam 4, `--decode-steps` steps, default 16, reported a
decode step). Prints one JSON object: the step's mode ("graph" or
"eager"), the window's wall time a step,
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
    # cuBLAS's xmma GEMMs, before the convolutions' xmma kernels
    ("gemm", ("xmma_gemm",)),
    ("convolutions", ("conv", "dgrad", "wgrad", "fprop", "xmma",
                      "implicit_gemm", "winograd")),
    ("batch norm", ("batch_norm",)),
    ("softmax", ("softmax",)),
    ("sort and top-k", ("sort", "radix", "topk")),
    ("gather and scatter", ("index", "gather", "scatter", "embedding")),
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


def _window(torch, fn, steps):
    """Trace `steps` calls of `fn` (after a synchronize, ending in one):
    (profiler, wall microseconds)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            out = fn(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return prof, wall_us, out


def _summary(prof, wall_us, n):
    """A traced window's numbers a step (n steps): wall, device busy,
    busy share, kernels, device time by family with each family's three
    largest kernels, the top kernels and host operators."""
    events = prof.key_averages()
    kernels = [(e.key, _device_us(e), e.count) for e in events
               if "cuda" in str(e.device_type).lower()]
    kernels = sorted((k for k in kernels if k[1] > 0), key=lambda k: -k[1])
    host = sorted(((e.key, e.self_cpu_time_total, e.count) for e in events
                   if "cuda" not in str(e.device_type).lower()),
                  key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
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
    return {
        "window_steps": n, "wall_us_per_step": wall_us / n,
        "device_busy_us_per_step": busy / n,
        "device_busy_share": busy / wall_us if wall_us else None,
        "kernels_per_step": sum(k[2] for k in kernels) / n,
        "kernel_families_per_step": families,
        "top_kernels": [{"name": k[0][:100], "device_us": k[1],
                         "calls": k[2]} for k in kernels[:12]],
        "top_host_ops": [{"name": k[0][:100], "self_cpu_us": k[1],
                          "calls": k[2]} for k in host[:12]]}


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--opt", choices=("sgd", "adam"), default="sgd")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--bert", default=None,
                    choices=[leg["name"] for leg in
                             chip_smoke.BERT_FLUID_LEGS])
    ap.add_argument("--resnet", action="store_true")
    ap.add_argument("--transformer", action="store_true")
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--eager", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1

    from paddle_tpu_torch import fluid

    fluid.set_flags({"FLAGS_cuda_graphs": not args.eager})

    if args.transformer:
        from paddle_tpu_torch.models import transformer

        c = chip_smoke.TRANSFORMER_A
        cfg = transformer.TransformerConfig.big()
        main_prog, startup, loss = chip_smoke.build_fluid_transformer(
            fluid, cfg, c["seq"], amp=True)
        feeds, fetch, b = [chip_smoke.transformer_feed(
            cfg, c["batch"], c["seq"])], [loss], c["batch"]
        model, opt = "transformer big", "noam adam (bf16 AMP O2, fused)"
    elif args.resnet:
        c = chip_smoke.RESNET_A
        main_prog, startup, loss = chip_smoke.build_fluid_resnet(
            fluid, c["img"], c["classes"], c["lr"], c["amp"])
        feeds, fetch, b = [chip_smoke.resnet_feed(
            c["batch"], c["img"], c["classes"])], [loss], c["batch"]
        model, opt = "resnet50", "momentum (bf16 AMP O2, fused)"
    elif args.bert:
        from paddle_tpu_torch.models import bert

        leg = {leg["name"]: leg for leg in chip_smoke.BERT_FLUID_LEGS}[
            args.bert]
        cfg = chip_smoke.bert_cfg(leg["seq"])
        main_prog, startup, loss, _ = chip_smoke.build_fluid_bert(
            fluid, cfg, leg["seq"], leg["remat"])
        feeds, fetch, b = [bert.bert_feed(cfg, leg["batch"],
                                          leg["seq"])], [loss], leg["batch"]
        model, opt = "bert " + args.bert, "adam (bf16 AMP O2, fused)"
    else:
        main_prog, startup, loss, acc = chip_smoke.build_fluid_mlp(
            fluid, args.opt)
        x, y = chip_smoke.fluid_mnist_data()
        b = chip_smoke.FLUID_BATCH
        feeds = [{"img": x[i * b:(i + 1) * b],
                  "label": y[i * b:(i + 1) * b]}
                 for i in range(len(x) // b)]
        fetch = [loss, acc]
        model, opt = "mnist mlp", args.opt
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)

    def step(i):
        return exe.run(main_prog, feed=feeds[i % len(feeds)],
                       fetch_list=fetch, scope=scope)

    for i in range(3):
        step(i)
    prof, wall_us, out = _window(torch, lambda i: step(3 + i), args.steps)
    res = dict({"model": model, "opt": opt, "batch": b,
                "mode": exe.last_entry.mode, "loss": float(out[0][0])},
               **_summary(prof, wall_us, args.steps))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            args.out, "fluid_%s_%s_trace.json" % (
                "transformer" if args.transformer else
                "resnet" if args.resnet else args.bert or args.opt,
                exe.last_entry.mode)))
    if args.transformer:
        res["decode"] = _decode_window(torch, transformer, cfg, scope,
                                       feeds[0], args.decode_steps)
    res.update(device=torch.cuda.get_device_name(0),
               nvidia_smi=chip_smoke.nvidia_smi_line())
    print(json.dumps(res))
    return 0


def _decode_window(torch, transformer, cfg, scope, feed, steps):
    """One beam-search decode of leg b's sentences over the trained
    scope, `steps` decode steps long, after a warm-up decode: its
    numbers a decode step."""
    c = chip_smoke.TRANSFORMER_B
    n = c["sentences"]

    def decode(_):
        return transformer.beam_search_decode(
            scope, feed["src_ids"][:n], feed["src_mask"][:n], cfg,
            beam_size=c["beam"], max_out_len=steps, bos_id=c["bos"],
            eos_id=c["eos"], alpha=c["alpha"], stats=stats)

    stats = {}
    decode(0)
    prof, wall_us, _ = _window(torch, decode, 1)
    return dict({"sentences": n, "beam": c["beam"],
                 "decode_steps": stats["steps"]},
                **_summary(prof, wall_us, stats["steps"]))


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


if __name__ == "__main__":
    sys.exit(main())
