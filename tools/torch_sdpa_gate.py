#!/usr/bin/env python3
"""Where `FLAGS_flash_attention_min_seq` should sit on this card: the
`scaled_dot_product_attention` op's flash route (the three kernels)
against its composite route, on one NVIDIA GPU.

    python3 tools/torch_sdpa_gate.py [--out FILE]

At BERT-base's heads (H 12, D 64) with a padding key bias, at S 512,
1024, 2048 and 4096 with the batch held to B * S = 8192 tokens (bench.py's
long leg at S 4096 is B 2), the op runs forward and backward through
`paddle_tpu_torch.ops.registry.run_op` once with the gate at S (the
kernels) and once above it (the composite path), on q, k, v that are
views of one [B, S, 3H] projection as the scan encoder makes them. Three
settings: bf16 with attention dropout 0.1 (the AMP training path), bf16
without dropout, float32 with dropout 0.1. Times are CUDA-event medians
of 10 runs after 2 warm-up runs. Prints one JSON object: each setting's
times, and the least S at which the kernels win.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

TOKENS, H, D = 8192, 12, 64
SEQS = (512, 1024, 2048, 4096)
SETTINGS = {"bf16_dropout": ("bfloat16", 0.1), "bf16": ("bfloat16", 0.0),
            "fp32_dropout": ("float32", 0.1)}


def time_ms(torch, fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main():
    import torch

    from paddle_tpu_torch.core.rng import seed_tensor
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.utils import flags

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    results = {}
    for name, (dtype, p) in SETTINGS.items():
        rows = []
        for S in SEQS:
            B = TOKENS // S
            g = torch.Generator().manual_seed(S)
            qkv = torch.randn(B, S, 3 * H * D, generator=g).to(
                dev, getattr(torch, dtype))
            q, k, v = (qkv[:, :, i * H * D:(i + 1) * H * D]
                       .reshape(B, S, H, D).transpose(1, 2)
                       .requires_grad_(True) for i in range(3))
            keep = torch.randint(S // 2, S + 1, (B,), generator=g)
            bias = ((torch.arange(S)[None] < keep[:, None]).float() - 1.0) \
                * 1e4
            bias = bias.to(dev)
            do = torch.randn(B, H, S, D, generator=g).to(dev, q.dtype)
            attrs = {"causal": False, "sm_scale": D ** -0.5,
                     "attn_dropout_prob": p, "is_test": False,
                     "_rng_seed": seed_tensor(7 << 32, dev)}

            def fwd():
                return registry.run_op(
                    "scaled_dot_product_attention",
                    {"Q": [q], "K": [k], "V": [v], "KeyBias": [bias]},
                    dict(attrs))["Out"][0]

            def both():
                torch.autograd.grad(fwd(), (q, k, v), do)

            row = {"S": S, "B": B}
            for route, gate in (("kernels", S), ("composite", S + 1)):
                flags.set_flags({"FLAGS_flash_attention_min_seq": gate})
                with torch.no_grad():
                    row[route + "_forward_ms"] = time_ms(torch, fwd)
                row[route + "_fwd_bwd_ms"] = time_ms(torch, both)
            flags.set_flags({"FLAGS_flash_attention_min_seq": 4096})
            row["kernels_win"] = \
                row["kernels_fwd_bwd_ms"] < row["composite_fwd_bwd_ms"]
            rows.append(row)
            del qkv, q, k, v, do
            torch.cuda.empty_cache()
        wins = [r["S"] for r in rows if r["kernels_win"]]
        results[name] = {"dtype": dtype, "dropout_p": p, "rows": rows,
                         "least_winning_S": min(wins) if wins else None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"tokens": TOKENS, "heads": H, "head_dim": D,
           "settings": results, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": smi}
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
