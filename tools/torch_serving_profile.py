#!/usr/bin/env python3
"""Where the time of the port's serving step goes, on one NVIDIA GPU.

    python3 tools/torch_serving_profile.py [--eager] [--out DIR]

Builds the serving engine of chip_smoke.py (BERT-base widths, bfloat16
pages, random weights from seed 0), serves its trace up to the first
step that only decodes, then traces the next steady window of steps with
`torch.profiler` (CPU and CUDA activity). `warmup` captures every bucket
as a CUDA graph, so the window replays them; ``--eager`` turns capture
off (`FLAGS_cuda_graphs`). Prints one JSON object: the dispatch mode,
the window's wall time, the device time summed over kernels (the device's
busy share is that over the wall time), the ragged paged attention
kernel's share, and the ten kernels with the most device time. With
--out, the Chrome trace of the window is written there.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the same model, pool and trace)


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--eager", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False

    from paddle_tpu_torch import serving
    from paddle_tpu_torch.utils.flags import set_flags

    set_flags({"FLAGS_cuda_graphs": not args.eager})

    model = serving.TinyDecoderLM(serving.TinyLMConfig(
        **chip_smoke.BERT_BASE))
    engine = serving.Engine(model, config=serving.EngineConfig(
        kv_dtype="bfloat16", **chip_smoke.POOL), seed=0)
    engine.warmup()
    for tr in serving.synthetic_trace(**chip_smoke.BF16_TRACE):
        engine.submit(tr.prompt, max_new_tokens=tr.max_new_tokens)
    while True:  # prefill everything first: the window is decode only
        st = engine.step()
        if st.get("n_prefill", 0) == 0 and st.get("n_decode", 0) > 0:
            break
    running = st["n_decode"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            engine.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" or "cuda" in str(
                   e.device_type).lower()]
    kernels = [(e.key, _device_us(e), e.count) for e in kernels]
    kernels = [k for k in kernels if k[1] > 0]
    busy = sum(k[1] for k in kernels)
    # the attention kernel: rpa_kernel (one pass), or rpa_chunk_kernel and
    # rpa_merge_kernel (split over pages)
    rpa = sum(k[1] for k in kernels if "rpa_" in k[0])
    kernels.sort(key=lambda k: -k[1])
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            args.out, "serving_decode_%s_trace.json" % engine._compiler.mode))
    print(json.dumps({
        "mode": engine._compiler.mode,
        "window_steps": args.steps, "decode_batch": running,
        "wall_us": wall_us, "device_busy_us": busy,
        "device_busy_share": busy / wall_us if wall_us else None,
        "rpa_us": rpa, "rpa_share_of_device": rpa / busy if busy else None,
        "top_kernels": [{"name": k[0][:120], "device_us": k[1],
                         "calls": k[2]} for k in kernels[:10]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
