#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card's name and power limit (nvidia-smi's own line is
   printed as is, too);
2. build — every kernel under paddle_tpu_torch/csrc/ built with nvcc for
   sm_90a (ptxas's register and spill report, kernel by kernel);
3. kernel cases — the ragged paged attention kernel against its plain
   PyTorch version on the card at the serving path's shapes (BERT-base
   heads: Hq = 12, D = 64, page 16, 32 pages per sequence; and a decode
   over contexts of 1,024 to 2,000 slots, 128 pages per sequence): max abs
   error <= 2e-5 with rtol 1e-4, and exact zeros on inactive rows. Each
   case gives the kernel's, the plain version's and one PyTorch call's time
   (`scaled_dot_product_attention` on the pre-gathered dense K/V, a
   yardstick only) beside the least time the card could take;
4. main paths — the serving engine at BERT-base widths (vocab 30522,
   embed 768, 12 layers, 12 heads, ffn 3072, max_seq 512; random weights
   from seed 0) serves a synthetic multi-tenant trace with system
   prompts, once over bfloat16 pages and once over int8 pages. The launch
   counts are set to 0 just before each path and read just after: every
   dispatch must have launched the kernel once per layer. Then one
   prefill and three decode buckets run through `forward` with the kernel
   and with the plain version on equal pages: last-row logits within
   1e-3, next tokens equal wherever the top-two margin exceeds that;
5. flash cases — the flash attention forward, dK/dV and dQ kernels
   against their plain PyTorch versions on the card, on the inputs the
   wrapper gives them: (a) the trainer's shape (B 8, H 12, S 512, D 64,
   bf16, causal), with q, k, v and the cotangent laid out as the trainer
   makes them (views of one [B, S, 3, H, D] tensor and of a [B, S, H, D]
   one, read in place: no copy inside the timed calls), (b) BERT's (S 128,
   fp32, a padding key bias), (c) S 100 (fp32, causal, the padding path),
   (d) fp32 with a key bias and dropout 0.1 at a fixed seed, (e) bf16 at
   the trainer's widths with a key bias and dropout 0.1, (f) the fluid
   BERT path's long leg (B 2, H 12, S 4096, D 64, bf16, key bias,
   dropout 0.1, q, k, v as views of one [B, S, 3H] projection). Tolerances: fp32
   forward 2e-5 and gradients 3e-4, bf16 2e-2. Each kernel's time beside
   its plain version's, the least time the card could take, its rate on
   the attending pairs (TFLOP/s), its design (bf16 on tensor cores,
   "wgmma bf16"; fp32 "simt"), and `scaled_dot_product_attention`'s
   forward and backward as a yardstick;
6. the training path — `parallel.transformer` at the default `SPMDConfig`
   (vocab 32000, d_model 768, 12 heads, d_ff 3072, seq 512, 12 layers,
   bf16 compute, remat; random weights from seed 0), batch 8: one warm-up
   step, then 5 timed steps with finite losses; the launch counts, set to
   0 just before them, must be 2L forward and L each of dK/dV and dQ per
   step, every one of them on tensor cores. Then one step with the
   kernels and one with the plain attention on the same params and batch:
   loss within 1e-2 relative and every gradient leaf within 2e-2 relative
   in norm;
7. the fluid static graph — the MNIST MLP of tests/test_mnist_mlp.py
   (784-128-64-10, batch 64; synthetic data from seed 0, the startup
   program's random_seed 1) through
   `fluid.layers` -> `optimizer.minimize` -> `Executor.run`: the startup
   program on `fluid.Executor()` with no place (every persistable must
   land on cuda:0), then 30 SGD steps on the card and the same steps on
   the CPU from the same numpy params (losses within 1e-4 relative,
   accuracies equal, the card's last loss below half its first), then 20
   Adam steps the same way; the median step time (host clock, ending in
   a synchronize) beside the card's name and power limit. This path runs
   none of the kernels: MNIST has no attention;
8. fluid BERT — BERT-base pretraining (vocab 30522, hidden 768, 12
   layers, 12 heads, FFN 3072; random weights from the startup program's
   random_seed 1, bench.py's synthetic masked-LM feed) through
   `bert_pretrain_loss` (scan encoder) -> `mixed_precision.decorate`
   (bf16, O2) over Adam -> `minimize` -> `fuse_optimizer_ops` ->
   `Executor.run`, as bench.py builds it. Leg a: S 128, batch 256, no
   remat, composite attention. Leg b: S 4096, batch 2, scan remat, the
   three flash kernels with the key bias and dropout in them. Each leg
   runs 2 warm-up and 5 timed steps: every loss finite, the first within
   0.5 of ln(30522) + ln(2); tokens/s, the median step ms, peak memory,
   MFU, the busy share of one profiled step; the flash launch counts,
   zeroed just before the timed steps, exact (leg a none; leg b 2L
   forward, L dK/dV and L dQ a step, all on tensor cores). Leg c: the
   S 4096 program at 2 layers, one step with the kernels and one with
   their plain version from the same params: loss within 1e-2 and every
   gradient within 2e-2 relative in norm;
9. fluid ResNet50 — ImageNet training as bench.py builds it
   (`build_resnet_train_program`: `models/resnet.py resnet(depth=50)`
   with `scan_stages`, 224 x 224 NCHW images, 1000 classes,
   softmax_with_cross_entropy then mean, `mixed_precision.decorate`
   (bf16, O2, no loss scaling) over Momentum(0.1, 0.9), `minimize`,
   `fuse_optimizer_ops`, random_seed 11; the feed from RandomState(0)).
   Leg a: batch 128, 2 warm-up and 10 timed steps: every loss finite;
   the median step ms, images/s, MFU on the model FLOPs counted from the
   program's conv and fc shapes, peak memory, the busy share and kernels
   of one profiled step, and the launches of the five attention kernels
   (none: the path has no attention). Leg b: the port on the card
   against the port on the CPU, fp32 (TF32 off), AMP off, 32 x 32,
   batch 4, 10 classes, Momentum(3e-3), from one startup state with each
   residual branch's last BN scale set to 0 (zero-gamma: from the plain
   random start the model is chaotic under batch statistics, PERF.md):
   3 steps and then one step of the program's for_test clone (running
   statistics, no update); losses and every running statistic within
   1e-3 relative;
10. kernels — one line listing every ported kernel with its launches on
   its main path and its times (RPA at the decode bucket, with its prefill
   case's times beside; the flash kernels also with their design and
   TFLOP/s, and their launches and times on the fluid BERT path);
11. the last line, ``{"ok": true, "device": {...}}``, printed only when
   every phase passed. Any failure exits non-zero.

It needs one card and exits non-zero without one, or without the
repository around it.
"""
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
FP32_FLOPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
ATOL, RTOL = 2e-5, 1e-4     # kernel vs plain, float32 arithmetic
LOGIT_TOL = 1e-3            # serving forward, kernel vs plain attention

BERT_BASE = dict(vocab=30522, embed=768, layers=12, heads=12, kv_heads=12,
                 head_dim=64, ffn=3072, max_seq=512)
POOL = dict(num_pages=512, page_size=16, max_seqs=8)
BF16_TRACE = dict(n_requests=8, n_tenants=2, vocab=30522,
                  prompt_range=(32, 256), output_range=(16, 32),
                  system_prompt_range=(16, 48))
INT8_TRACE = dict(n_requests=4, n_tenants=2, seed=1, vocab=30522,
                  prompt_range=(32, 256), output_range=(8, 16),
                  system_prompt_range=(16, 48))
DEV = "cuda"
RPA_SOURCE = "paddle_tpu_torch/csrc/ragged_paged_attention.cu"
RPA_TPU = "paddle_tpu/ops/pallas/ragged_paged_attention.py"
FLASH_SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
FLASH_TPU = "paddle_tpu/ops/pallas/flash_attention.py"
#: dtype -> (forward tol, gradient tol), atol = rtol
FLASH_TOL = {"float32": (2e-5, 3e-4), "bfloat16": (2e-2, 2e-2)}
FLASH_CASES = [
    dict(name="trainer_bf16_causal", B=8, H=12, S=512, D=64,
         dtype="bfloat16", causal=True, bias=False, p=0.0, qkv_views=True),
    dict(name="bert_f32_bias", B=8, H=12, S=128, D=64, dtype="float32",
         causal=False, bias=True, p=0.0),
    dict(name="unaligned_f32_causal", B=4, H=12, S=100, D=64,
         dtype="float32", causal=True, bias=False, p=0.0),
    dict(name="dropout_f32_bias", B=8, H=12, S=128, D=64, dtype="float32",
         causal=False, bias=True, p=0.1),
    dict(name="bias_dropout_bf16", B=8, H=12, S=512, D=64, dtype="bfloat16",
         causal=False, bias=True, p=0.1),
    dict(name="bert_s4096_bf16", B=2, H=12, S=4096, D=64, dtype="bfloat16",
         causal=False, bias=True, p=0.1, qkv_views=True),
]
FLASH_SEED = 1234
TRAIN_BATCH, TRAIN_STEPS = 8, 5
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-2, 2e-2
FLUID_BATCH, FLUID_SGD_STEPS, FLUID_ADAM_STEPS = 64, 30, 20
FLUID_SEED = 0               # synthetic data
FLUID_INIT_SEED = 1          # the startup program's random_seed
FLUID_LOSS_RTOL = 1e-4      # fluid MLP losses, card vs CPU (fp32, no TF32)
#: fluid BERT legs (bench.py's BATCH/SEQ_LEN and LONGCTX_BATCH/_SEQ; scan
#: remat on where bench.py turns it on)
BERT_FLUID_LEGS = [
    dict(name="a_s128", seq=128, batch=256, remat=False),
    dict(name="b_s4096", seq=4096, batch=2, remat=True),
]
BERT_WARMUP, BERT_STEPS = 2, 5
BERT_INIT_SEED = 1           # the startup and main programs' random_seed
BERT_LR = 1e-4
BERT_LOSS0_TOL = 0.5         # first loss against ln(vocab) + ln(2)
BERT_CHECK = dict(seq=4096, batch=2, layers=2)
#: kernels vs plain flash on one bf16 step: the tensor-core kernels round
#: P and dS to bf16 before their second product, so gradients differ by
#: about one bf16 step (2^-8) relative; 2e-2 in norm, as the trainer's
#: check in phase 6
BERT_CHECK_LOSS_RTOL, BERT_CHECK_GRAD_RTOL = 1e-2, 2e-2
#: fluid ResNet50 (bench.py `_resnet_feed` and
#: `build_resnet_train_program`): leg a at full size, leg b card vs CPU
RESNET_A = dict(img=224, classes=1000, batch=128, lr=0.1, amp=True)
RESNET_B = dict(img=32, classes=10, batch=4, lr=3e-3, amp=False)
RESNET_WARMUP, RESNET_STEPS, RESNET_B_STEPS = 2, 10, 3
RESNET_INIT_SEED = 11        # the startup and main programs' random_seed
RESNET_B_RTOL = 1e-3         # leg b: losses and running stats, card vs CPU


def emit(obj):
    print(json.dumps(obj), flush=True)


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


# -- phase 1 ------------------------------------------------------------------

def nvidia_smi_line():
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    check(smi.returncode == 0 and line, "nvidia-smi failed: %s"
          % smi.stderr.strip())
    return line


def phase_device(torch):
    line = nvidia_smi_line()
    print(line, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": line,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return name


# -- phase 2 ------------------------------------------------------------------

def phase_build():
    from paddle_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    built = _build.build()
    report = {name: ptxas_report(b["log"]) for name, b in built.items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "sources": sorted(built), "ptxas": report})


def kernel_label(mangled):
    """The kernel's name in a mangled symbol (each name is preceded by its
    length), with its template arguments as mangled."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):  # the length is a suffix of the run
            name = mangled[m.end():m.end() + int(m.group()[i:])]
            rest = mangled[m.end() + len(name):]
            if name.endswith("kernel") and rest.startswith("I"):
                return "%s<%s>" % (name, rest[1:rest.find("EEv")])
            if name.endswith("kernel") and rest.startswith("E"):
                return name
    return mangled


def ptxas_report(log):
    """{kernel: "N registers; spills"} from nvcc's -Xptxas -v output. A
    kernel is named by its mangled core, e.g. ``fa_fwd_tc_kernel<Li1E>``
    (template arguments as mangled: ``Li64E`` is 64, ``f`` float)."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = kernel_label(ln.split()[-1])
            out[name] = ""
        elif name is not None and ("spill" in ln or "registers" in ln):
            out[name] = (out[name] + "; " + ln.strip().replace(
                "ptxas info    : ", "")).strip("; ")
    return out


# -- phase 3 ------------------------------------------------------------------

class Timer:
    """Median device time of one call, in ms, with the L2 cache flushed
    before each launch (the serving step streams 400+ MB of weights
    between two attention calls, so the kernel finds its pages cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)

    def __call__(self, fn, reps):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for start, end in ev:
            self.flush.zero_()
            # keep the card busy while the host enqueues fn, so that the
            # timed interval holds no host gap
            torch.cuda._sleep(2_000_000)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in ev)
        return times[len(times) // 2]


def make_case(torch, name, seed, S, Q, Hq, Hkv, ctx, qlen, dtype, pps=32,
              pool=POOL["num_pages"]):
    """Seeded inputs at the serving path's page geometry: each sequence's
    live pages drawn at random from the pool (512 pages, 32 a sequence,
    as the engine's)."""
    D, page, P = 64, POOL["page_size"], pool
    gen = torch.Generator().manual_seed(seed)
    kf = torch.randn((P, page, Hkv, D), generator=gen)
    vf = torch.randn((P, page, Hkv, D), generator=gen)
    perm = torch.randperm(P, generator=gen)
    tables = torch.zeros((S, pps), dtype=torch.int32)
    n = 0
    for s in range(S):
        live = -(-int(ctx[s]) // page)
        tables[s, :live] = perm[n:n + live].int()
        n += live
    kw = {}
    if dtype == torch.int8:
        ks = kf.abs().amax(dim=(2, 3)).clamp_min(1e-9) / 127.0
        vs = vf.abs().amax(dim=(2, 3)).clamp_min(1e-9) / 127.0
        kp = torch.round(kf / ks[:, :, None, None]).clamp(-127, 127)
        vp = torch.round(vf / vs[:, :, None, None]).clamp(-127, 127)
        kw = dict(k_scale=ks.to(DEV), v_scale=vs.to(DEV))
    else:
        kp, vp = kf, vf
    args = (torch.randn((S, Q, Hq, D), generator=gen).to(DEV),
            kp.to(dtype).to(DEV), vp.to(dtype).to(DEV), tables.to(DEV),
            torch.tensor(ctx, dtype=torch.int32).to(DEV),
            torch.tensor(qlen, dtype=torch.int32).to(DEV))
    return dict(name=name, args=args, kw=kw, ctx=list(ctx), qlen=list(qlen))


def bound_of(torch, case):
    """Least time for this call: the bytes it must move (q read, output
    written, the live pages' K/V and scales read once) over the memory
    rate, and its float32 operations over the fp32 peak; the larger."""
    q, kp, _, tables, _, _ = case["args"]
    S, Q, Hq, D = q.shape
    page, Hkv = kp.shape[1], kp.shape[2]
    nbytes = 2 * q.numel() * 4 + tables.numel() * 4 + 2 * S * 4
    flops = 0
    for c, ql in zip(case["ctx"], case["qlen"]):
        if ql == 0:
            continue
        live = -(-c // page)
        nbytes += 2 * live * page * Hkv * D * kp.element_size()
        if case["kw"]:
            nbytes += 2 * live * page * 4
        keys = sum(c - ql + i + 1 for i in range(ql))
        flops += 4 * keys * Hq * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def library_call(torch, case):
    """scaled_dot_product_attention over the pre-gathered dense K/V with
    the same mask (gather excluded from the timing)."""
    import torch.nn.functional as F

    q, kp, vp, tables, ctx, qlen = case["args"]
    S, Q, Hq, D = q.shape
    Hkv = kp.shape[2]
    kvmax = tables.shape[1] * kp.shape[1]
    k = kp[tables.long()].reshape(S, kvmax, Hkv, D).float()
    v = vp[tables.long()].reshape(S, kvmax, Hkv, D).float()
    if case["kw"]:
        k = k * case["kw"]["k_scale"][tables.long()].reshape(S, kvmax)[
            :, :, None, None]
        v = v * case["kw"]["v_scale"][tables.long()].reshape(S, kvmax)[
            :, :, None, None]
    k = k.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
    v = v.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
    qd = q.transpose(1, 2).contiguous()
    kpos = torch.arange(kvmax, device=DEV)[None, None, None, :]
    rows = torch.arange(Q, device=DEV)[None, None, :, None]
    qpos = (ctx - qlen).long()[:, None, None, None] + rows
    mask = (kpos <= qpos) & (rows < qlen.long()[:, None, None, None])
    return lambda: F.scaled_dot_product_attention(qd, k, v, attn_mask=mask)


def phase_kernel_cases(torch, timer):
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    gen = torch.Generator().manual_seed(1234)

    def ragged(n, lo, hi):
        return torch.randint(lo, hi + 1, (n,), generator=gen).tolist()

    bf16, i8 = torch.bfloat16, torch.int8
    dec_ctx = ragged(8, 48, 512)
    pre_q = ragged(4, 16, 64)
    pre_ctx = [q + p for q, p in zip(pre_q, ragged(4, 0, 448))]
    inactive = [0 if s in (5, 7) else 1 for s in range(8)]
    cases = [
        make_case(torch, "decode_bf16", 1, 8, 1, 12, 12, dec_ctx, [1] * 8,
                  bf16),
        make_case(torch, "prefill_bf16", 2, 4, 64, 12, 12, pre_ctx, pre_q,
                  bf16),
        make_case(torch, "decode_gqa_bf16", 3, 8, 1, 12, 4, dec_ctx,
                  [1] * 8, bf16),
        make_case(torch, "decode_int8", 4, 8, 1, 12, 12, dec_ctx, [1] * 8,
                  i8),
        make_case(torch, "prefill_int8", 5, 4, 64, 12, 12, pre_ctx, pre_q,
                  i8),
        make_case(torch, "decode_inactive_bf16", 6, 8, 1, 12, 12,
                  [c * a for c, a in zip(dec_ctx, inactive)], inactive,
                  bf16),
        make_case(torch, "decode_f32", 7, 8, 1, 12, 12, dec_ctx, [1] * 8,
                  torch.float32),
        make_case(torch, "decode_f16", 8, 8, 1, 12, 12, dec_ctx, [1] * 8,
                  torch.float16),
        make_case(torch, "decode_long_bf16", 9, 8, 1, 12, 12,
                  ragged(8, 1024, 2000), [1] * 8, bf16, pps=128, pool=1024),
    ]
    results = {}
    for case in cases:
        args, kw = case["args"], case["kw"]
        got = rpa(*args, impl="kernel", **kw)
        torch.cuda.synchronize()
        want = rpa(*args, impl="reference", **kw)
        err = float((got - want).abs().max())
        zeros = all(not bool(got[s, ql:].any()) and
                    not bool(want[s, ql:].any())
                    for s, ql in enumerate(case["qlen"]))
        ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL)) and \
            zeros and bool(torch.isfinite(got).all())
        bound, by, nbytes, flops = bound_of(torch, case)
        res = {
            "phase": "kernel_case", "case": case["name"],
            "shape": list(args[0].shape), "pages": str(args[1].dtype),
            "kv_heads": args[1].shape[2], "ctx": case["ctx"],
            "q_lens": case["qlen"], "max_abs_err": err,
            "inactive_rows_zero": zeros, "ok": ok,
            "ms": timer(lambda: rpa(*args, impl="kernel", **kw), 50),
            "plain_ms": timer(
                lambda: rpa(*args, impl="reference", **kw), 10),
            "library_ms": timer(library_call(torch, case), 20),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "flops": flops}
        emit(res)
        check(ok, "kernel case %s disagrees with the plain version "
              "(max abs err %g)" % (case["name"], err))
        results[case["name"]] = res
    return results


# -- phase 4 ------------------------------------------------------------------

def run_main_path(torch, serving, model, kv_dtype, trace):
    """Serve `trace` through the user entry points; the launch counts are
    zeroed just before and read just after."""
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    engine = serving.Engine(model, config=serving.EngineConfig(
        kv_dtype=kv_dtype, **POOL), seed=0, device=DEV)
    warm = engine.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rpa.launches = rpa.quant_launches = 0
    summary = serving.run_trace(engine, trace, warmup=False)
    torch.cuda.synchronize()
    launches, quant = rpa.launches, rpa.quant_launches
    st = engine.stats()
    dispatches = st["prefill_dispatches"] + st["decode_dispatches"]
    want_tokens = sum(tr.max_new_tokens for tr in trace)
    res = {
        "phase": "main_path", "kv_dtype": kv_dtype,
        "requests": summary["requests"], "finished": summary["finished"],
        "tokens_generated": summary["tokens_generated"],
        "tokens_expected": want_tokens, "steps": summary["steps"],
        "wall_s": summary["wall_s"],
        "tokens_per_sec": summary["tokens_per_sec"],
        "prefill_dispatches": st["prefill_dispatches"],
        "decode_dispatches": st["decode_dispatches"],
        "mean_prefill_ms": st["prefill_ms_total"]
        / max(1, st["prefill_dispatches"]),
        "mean_decode_ms": st["decode_ms_total"]
        / max(1, st["decode_dispatches"]),
        "prefix_hit_tokens": summary["prefix_hit_tokens"],
        "cow_copies": summary["cow_copies"],
        "kernel_launches": launches, "int8_kernel_launches": quant,
        "launches_expected": model.config.layers * dispatches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "kv_pool_bytes": st["kv_pool_bytes"],
        "warmup_buckets": warm["buckets"]}
    emit(res)
    check(summary["finished"] == len(trace)
          and summary["tokens_generated"] == want_tokens,
          "%s path: not every request finished with exactly "
          "max_new_tokens tokens" % kv_dtype)
    check(launches == model.config.layers * dispatches and launches > 0,
          "%s path: %d kernel launches for %d dispatches"
          % (kv_dtype, launches, dispatches))
    check(quant == (launches if kv_dtype == "int8" else 0),
          "%s path: %d int8 launches of %d" % (kv_dtype, quant, launches))
    del engine
    torch.cuda.empty_cache()
    return res


def phase_forward_kernel_vs_plain(torch, serving, model):
    """One prefill bucket and three decode buckets through `forward`,
    with the kernel and with the plain version, each on its own fresh
    pool with equal block tables; decode feeds both the kernel run's
    tokens."""
    c = model.config
    kv = serving.PagedKVCache(model.kv_cache_spec(
        POOL["num_pages"], POOL["page_size"], c.max_seq // POOL["page_size"],
        dtype="bfloat16"))
    pages = {impl: kv.init_device_state(DEV)
             for impl in ("auto", "reference")}
    gen = torch.Generator().manual_seed(7)
    S, T = 4, 64
    qlens = torch.tensor([64, 50, 33, 17], dtype=torch.int32)
    tables = torch.zeros((S, c.max_seq // POOL["page_size"]),
                         dtype=torch.int32)
    perm = torch.randperm(POOL["num_pages"], generator=gen).int()
    for s in range(S):
        tables[s] = perm[s * tables.shape[1]:(s + 1) * tables.shape[1]]
    tokens = torch.randint(0, c.vocab, (S, T), generator=gen,
                           dtype=torch.int32)
    ctx = qlens.clone()
    worst, tok_mismatch, compared = 0.0, 0, 0
    for step in range(4):
        outs = {}
        for impl in ("auto", "reference"):
            model.attention_impl = impl
            outs[impl] = model(tokens.to(DEV), pages[impl], tables.to(DEV),
                               ctx.to(DEV), qlens.to(DEV))
        model.attention_impl = "auto"
        tk, lk, _ = outs["auto"]
        tp, lp, _ = outs["reference"]
        check(bool(torch.isfinite(lk).all() and torch.isfinite(lp).all()),
              "forward gave non-finite logits")
        worst = max(worst, float((lk - lp).abs().max()))
        top2 = lp.topk(2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > LOGIT_TOL
        tok_mismatch += int(((tk != tp) & decisive).sum())
        compared += int(decisive.sum())
        tokens = tk.cpu()[:, None]
        qlens = torch.ones((S,), dtype=torch.int32)
        ctx = ctx + 1
    res = {"phase": "forward_kernel_vs_plain", "buckets": [[S, T]]
           + [[S, 1]] * 3, "max_abs_logit_err": worst,
           "tokens_compared": compared, "token_mismatches": tok_mismatch,
           "tol": LOGIT_TOL,
           "ok": worst <= LOGIT_TOL and tok_mismatch == 0}
    emit(res)
    check(res["ok"], "forward with the kernel disagrees with the plain "
          "version (logit err %g, %d token mismatches)"
          % (worst, tok_mismatch))


# -- phase 5 ------------------------------------------------------------------

def flash_inputs(torch, case, seed):
    """Seeded [B, H, S, D] inputs, a cotangent, and a padding bias (each
    sequence keeps a random prefix of at least half its keys). With
    `qkv_views`, q, k and v are the trainer's views of one [B, S, 3, H, D]
    tensor and the cotangent a view of a [B, S, H, D] one."""
    B, H, S, D = case["B"], case["H"], case["S"], case["D"]
    dtype = getattr(torch, case["dtype"])
    gen = torch.Generator().manual_seed(seed)
    if case.get("qkv_views"):
        qkv = torch.randn((B, S, 3, H, D), generator=gen).to(DEV, dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        do = torch.randn((B, S, H, D), generator=gen).to(
            DEV, dtype).transpose(1, 2)
    else:
        q, k, v, do = (torch.randn((B, H, S, D), generator=gen).to(
            DEV, dtype) for _ in range(4))
    bias = None
    if case["bias"]:
        keep = torch.randint(S // 2, S + 1, (B,), generator=gen)
        mask = (torch.arange(S)[None, :] < keep[:, None]).float()
        bias = ((mask - 1.0) * 1e4).to(DEV)
    return q, k, v, do, bias


def flash_pairs(case):
    """(row, col) pairs that attend, per (b, h): the work of one call."""
    S = case["S"]
    return S * (S + 1) // 2 if case["causal"] else S * S


def flash_bounds(case):
    """Least time of each kernel: the bytes it must move (each input read
    once, each output written once) over the memory rate, and its
    operations on the attending pairs over the peak for the input type
    (bf16 tensor cores, or fp32); the larger of the two."""
    B, H, S, D = case["B"], case["H"], case["S"], case["D"]
    BH = B * H
    elt = 2 if case["dtype"] == "bfloat16" else 4
    tile = BH * S * D * elt           # one of q, k, v, o, do, dq, dk, dv
    rows = BH * S * 4                 # lse, delta or the bias, float32
    bias = rows if case["bias"] else 0
    peak, peak_name = ((BF16_FLOPS_PER_S, "bf16 tensor cores 989 TFLOP/s")
                       if elt == 2 else (FP32_FLOPS_PER_S,
                                         "fp32 67 TFLOP/s"))
    pairs = BH * flash_pairs(case)
    work = {"forward": (4 * tile + rows + bias, 4 * pairs * D),
            "dkv": (6 * tile + 2 * rows + bias, 8 * pairs * D),
            "dq": (5 * tile + 2 * rows + bias, 6 * pairs * D)}
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        out[name] = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "bytes": nbytes, "flops": flops,
                     "peak": peak_name}
    return out


def flash_design(kname, dtype):
    """How the wrapper runs a kernel for this dtype: every bf16 kernel
    (forward, dK/dV, dQ) on tensor cores, fp32 SIMT."""
    return "wgmma bf16" if dtype == "bfloat16" else "simt fp32"


def flash_library(torch, q, k, v, do, bias, case):
    """scaled_dot_product_attention with the same mask and dropout rate:
    (forward, backward of dq/dk/dv, forward + backward) callables."""
    import torch.nn.functional as F

    mask = None if bias is None else bias[:, None, None, :].to(q.dtype)
    qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, dropout_p=case["p"],
            is_causal=case["causal"])

    out = fwd()
    return (fwd,
            lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                        retain_graph=True),
            lambda: torch.autograd.grad(fwd(), (qs, ks, vs), do))


def phase_flash_cases(torch, timer):
    """Each flash kernel against its plain version on the same inputs:
    forward (o, lse); dK/dV and dQ from the plain forward's lse and
    delta."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    fa_mod = sys.modules[fa.__module__]
    results = {}
    for n, case in enumerate(FLASH_CASES):
        q, k, v, do, bias4 = flash_inputs(torch, case, 100 + n)
        qf, kf, vf, bias = fa_mod.pad_and_flatten(q, k, v, bias4)
        dof = fa_mod.pad_and_flatten(do, k, v)[0]
        dof[:, :, case["S"]:] = 0  # the padded rows get no gradient
        kw = dict(sm_scale=1.0 / math.sqrt(case["D"]),
                  causal=case["causal"], dropout_p=case["p"])
        args = (qf, kf, vf, bias, FLASH_SEED)
        fwd = lambda impl: fa_mod.flash_attention_fwd(*args, impl=impl, **kw)
        o, lse = fwd("kernel")
        o_r, lse_r = fwd("reference")
        delta = fa_mod.flash_attention_delta(o_r, dof)
        grad_args = args + (dof, lse_r, delta)
        dkv = lambda impl: fa_mod.flash_attention_bwd_dkv(
            *grad_args, impl=impl, **kw)
        dq = lambda impl: fa_mod.flash_attention_bwd_dq(
            *grad_args, impl=impl, **kw)
        got = dict(zip(("dk", "dv"), dkv("kernel")), dq=dq("kernel"), o=o,
                   lse=lse)
        torch.cuda.synchronize()
        want = dict(zip(("dk", "dv"), dkv("reference")), dq=dq("reference"),
                    o=o_r, lse=lse_r)
        fwd_tol, grad_tol = FLASH_TOL[case["dtype"]]
        errs, ok = {}, True
        for name in ("o", "lse", "dk", "dv", "dq"):
            g, w = got[name].float(), want[name].float()
            tol = fwd_tol if name in ("o", "lse") else grad_tol
            errs[name] = float((g - w).abs().max())
            ok = ok and bool(torch.isfinite(g).all()) and bool(
                torch.allclose(g, w, atol=tol, rtol=tol))
        bounds = flash_bounds(case)
        lib_fwd, lib_bwd, lib_both = flash_library(torch, q, k, v, do,
                                                   bias4, case)
        timed = {
            "forward": (timer(lambda: fwd("kernel"), 20),
                        timer(lambda: fwd("reference"), 5)),
            "dkv": (timer(lambda: dkv("kernel"), 20),
                    timer(lambda: dkv("reference"), 5)),
            "dq": (timer(lambda: dq("kernel"), 20),
                   timer(lambda: dq("reference"), 5))}
        library = {"forward": timer(lib_fwd, 20),
                   "backward": timer(lib_bwd, 20),
                   "forward_backward": timer(lib_both, 20)}
        res = {"phase": "flash_case", "case": case["name"],
               "shape": [case["B"], case["H"], case["S"], case["D"]],
               "dtype": case["dtype"], "causal": case["causal"],
               "key_bias": case["bias"], "dropout_p": case["p"],
               "qkv_views": bool(case.get("qkv_views")),
               "padded_s": qf.shape[2], "max_abs_err": errs,
               "tol": {"forward": fwd_tol, "grads": grad_tol}, "ok": ok,
               "library_ms": library, "kernels": {
                   name: dict(bounds[name], ms=t[0], plain_ms=t[1],
                              route=flash_design(name, case["dtype"]),
                              tflops=bounds[name]["flops"] / (t[0] * 1e9))
                   for name, t in timed.items()}}
        emit(res)
        check(ok, "flash case %s: the kernels disagree with the plain "
              "version (max abs errors %s)" % (case["name"], errs))
        results[case["name"]] = res
    return results


# -- phase 6 ------------------------------------------------------------------

def train_model_flops(cfg, batch):
    """Model FLOPs of one step (forward and backward, no recompute): the
    matmuls, the tied LM head and causal attention over the attending
    pairs."""
    D, Fd, V, S, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.seq_len, \
        cfg.n_layers
    tokens = batch * S
    matmul = tokens * (L * 2 * (4 * D * D + 2 * D * Fd) + 2 * D * V)
    attn = L * batch * cfg.n_heads * 4 * (S * (S + 1) // 2) * cfg.d_head
    return 3 * (matmul + attn)


def phase_training(torch):
    """The trainer's steps through its user entry points, with the launch
    counts zeroed just before and read just after; then kernels vs plain
    attention on one step."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel import transformer as tt

    cfg = tt.SPMDConfig()
    L = cfg.n_layers
    params = tt.init_params(cfg, seed=0, device=DEV)
    opt = tt.init_opt_state(params)
    step = tt.make_train_step(cfg, device=DEV)
    tokens, labels = tt.demo_batch(cfg, TRAIN_BATCH, seed=0)
    params, opt, loss = step(params, opt, tokens, labels, 0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.fwd_launches = fa.dkv_launches = fa.dq_launches = 0
    fa.tc_launches = dict.fromkeys(fa.tc_launches, 0)
    losses, step_ms = [], []
    for i in range(1, TRAIN_STEPS + 1):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, tokens, labels, i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = {"forward": fa.fwd_launches, "dkv": fa.dkv_launches,
                "dq": fa.dq_launches}
    tc_launches = dict(fa.tc_launches)
    want = {"forward": 2 * L * TRAIN_STEPS, "dkv": L * TRAIN_STEPS,
            "dq": L * TRAIN_STEPS}
    mean_s = sum(step_ms) / len(step_ms) / 1e3
    flops = train_model_flops(cfg, TRAIN_BATCH)

    # one step with the kernels and one with the plain attention
    with_grads = {impl: tt.make_train_step(cfg, device=DEV, with_grads=True,
                                           attn_impl=impl)
                  for impl in ("auto", "reference")}
    outs = {impl: fn(params, opt, tokens, labels, TRAIN_STEPS + 1)
            for impl, fn in with_grads.items()}
    lk, lp = float(outs["auto"][2]), float(outs["reference"][2])
    grad_err = {name: float((a - b).norm() / b.norm().clamp_min(1e-30))
                for (name, a), (_, b) in zip(leaves(outs["auto"][3]),
                                             leaves(outs["reference"][3]))}
    loss_err = abs(lk - lp) / abs(lp)
    res = {"phase": "train_path", "config": dataclasses.asdict(cfg),
           "batch": TRAIN_BATCH, "steps": TRAIN_STEPS, "losses": losses,
           "step_ms": step_ms, "mean_step_ms": mean_s * 1e3,
           "tokens_per_sec": TRAIN_BATCH * cfg.seq_len / mean_s,
           "model_flops_per_step": flops,
           "mfu_vs_bf16_peak": flops / mean_s / BF16_FLOPS_PER_S,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "launches_expected": want,
           "tensor_core_launches": tc_launches,
           "kernel_vs_plain": {"loss_kernel": lk, "loss_plain": lp,
                               "loss_rel_err": loss_err,
                               "max_grad_rel_err": max(grad_err.values()),
                               "grad_rel_err": grad_err}}
    emit(res)
    check(all(math.isfinite(x) for x in losses),
          "training: non-finite loss %s" % losses)
    check(launches == want and tc_launches == want,
          "training: launches %s (tensor cores %s), expected %s"
          % (launches, tc_launches, want))
    check(loss_err <= TRAIN_LOSS_RTOL and
          max(grad_err.values()) <= TRAIN_GRAD_RTOL,
          "training: kernels vs plain attention: loss rel err %g, max "
          "grad rel err %g" % (loss_err, max(grad_err.values())))
    del params, opt, outs
    torch.cuda.empty_cache()
    return res


# -- phase 7 ------------------------------------------------------------------

def fluid_mnist_data(n=512):
    """tests/test_mnist_mlp.py's separable synthetic MNIST, seeded."""
    import numpy as np

    rng = np.random.RandomState(FLUID_SEED)
    x = rng.rand(n, 784).astype("float32") * 0.1
    y = rng.randint(0, 10, size=(n, 1)).astype("int64")
    for i in range(n):
        x[i, y[i, 0] * 78:(y[i, 0] + 1) * 78] += 1.0
    return x, y


def build_fluid_mlp(fluid, kind):
    """The MNIST MLP of tests/test_mnist_mlp.py in fresh programs, with
    its optimizer: (main, startup, loss, accuracy)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = FLUID_INIT_SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data(name="img", shape=[784], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=img, size=128, act="relu")
        h = fluid.layers.fc(input=h, size=64, act="relu")
        logits = fluid.layers.fc(input=h, size=10, act=None)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        acc = fluid.layers.accuracy(input=fluid.layers.softmax(logits),
                                    label=label)
        opt = (fluid.optimizer.SGDOptimizer(learning_rate=0.5)
               if kind == "sgd"
               else fluid.optimizer.AdamOptimizer(learning_rate=1e-3))
        opt.minimize(loss)
    return main, startup, loss, acc


def fluid_steps(torch, fluid, exe, main, scope, fetch, steps):
    """`steps` feed/fetch runs over the synthetic batches: losses,
    accuracies and host-clock ms a step (ending in a synchronize)."""
    x, y = fluid_mnist_data()
    losses, accs, step_ms = [], [], []
    for step in range(steps):
        i = (step * FLUID_BATCH) % (len(x) - FLUID_BATCH)
        feed = {"img": x[i:i + FLUID_BATCH], "label": y[i:i + FLUID_BATCH]}
        t0 = time.perf_counter()
        loss, acc = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        if exe.device.type == "cuda":
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss[0]))
        accs.append(float(acc[0]))
    return losses, accs, step_ms


def phase_fluid(torch, name):
    """The fluid static graph: the MNIST MLP through layers -> minimize
    -> Executor.run, on the card (Executor() with no place) and on the
    CPU from the same numpy params, for SGD and for Adam."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.core.scope import dump_numpy_state, \
        load_numpy_state

    res = {"phase": "fluid_static_graph",
           "model": "MNIST MLP 784-128-64-10", "batch": FLUID_BATCH}
    for kind, steps in (("sgd", FLUID_SGD_STEPS),
                        ("adam", FLUID_ADAM_STEPS)):
        main, startup, loss, acc = build_fluid_mlp(fluid, kind)
        exe = fluid.Executor()
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        off_card = [n for n in names
                    if scope.find_var(n).device != torch.device("cuda", 0)]
        check(not off_card, "fluid %s: persistables not on cuda:0: %s"
              % (kind, off_card))
        state = dump_numpy_state(scope, names)
        card = fluid_steps(torch, fluid, exe, main, scope, [loss, acc],
                           steps)
        cpu_scope = fluid.Scope()
        load_numpy_state(cpu_scope, state, "cpu")
        cpu = fluid_steps(torch, fluid, fluid.Executor(fluid.CPUPlace()),
                          main, cpu_scope, [loss, acc], steps)
        rel = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
        res[kind] = {"steps": steps, "persistables": len(names),
                     "losses": card[0], "losses_cpu": cpu[0],
                     "max_loss_rel_err": rel, "accuracies": card[1],
                     "step_ms": card[2],
                     "median_step_ms": statistics.median(card[2]),
                     "cpu_median_step_ms": statistics.median(cpu[2])}
        check(all(math.isfinite(v) for v in card[0]),
              "fluid %s: non-finite loss %s" % (kind, card[0]))
        check(rel <= FLUID_LOSS_RTOL, "fluid %s: card vs CPU losses differ "
              "by %g relative" % (kind, rel))
        check(card[1] == cpu[1], "fluid %s: accuracies differ: %s vs %s"
              % (kind, card[1], cpu[1]))
        check(card[0][-1] < 0.5 * card[0][0], "fluid %s: loss %g -> %g did "
              "not halve" % (kind, card[0][0], card[0][-1]))
    res.update(device=name, nvidia_smi=nvidia_smi_line())
    emit(res)
    return res


# -- phase 8 ------------------------------------------------------------------

def build_fluid_bert(fluid, cfg, seq, remat, attention_impl="auto"):
    """BERT pretraining as bench.py builds it, in fresh programs:
    `bert_pretrain_loss` (scan encoder), bf16 AMP O2 over Adam(1e-4)
    without loss scaling, `minimize`, `fuse_optimizer_ops`. Returns
    (main, startup, total loss, names of the params' gradients)."""
    from paddle_tpu_torch.fluid.contrib import mixed_precision
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = BERT_INIT_SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        total, _, _, _ = bert.bert_pretrain_loss(
            cfg, seq, scan_layers=True, scan_remat=remat,
            attention_impl=attention_impl)
        opt = mixed_precision.decorate(
            fluid.optimizer.AdamOptimizer(learning_rate=BERT_LR),
            use_dynamic_loss_scaling=False)
        _, params_grads = opt.minimize(total)
        fluid.fuse_optimizer_ops(main)
    return main, startup, total, [g.name for _, g in params_grads]


def bert_cfg(seq, layers=None):
    """BERT-base (paddle_tpu/models/bert.py BertConfig.base), its
    position table stretched to `seq` where longer than 512 (as bench.py
    does for its long-context leg), its depth cut to `layers` if given."""
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base()
    cfg.max_position_embeddings = max(cfg.max_position_embeddings, seq)
    if layers is not None:
        cfg.num_hidden_layers = layers
    return cfg


def bert_model_flops(cfg, batch, seq, n_pred):
    """Model FLOPs of one pretraining step (forward and backward, no
    recompute): per layer the qkv, output and two FFN products over the
    B*S tokens and attention's two products over S*S pairs, then the
    masked-LM transform and vocab head over the B*n_pred masked tokens
    and the pooler and NSP head over the B [CLS] rows."""
    h, f, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_hidden_layers)
    tokens, masked = batch * seq, batch * n_pred
    encoder = L * (2 * tokens * (4 * h * h + 2 * h * f)
                   + 4 * batch * seq * seq * h)
    heads = 2 * masked * h * (h + V) + 2 * batch * h * (h + 2)
    return 3 * (encoder + heads)


def device_busy_share(torch, fn):
    """Run `fn` once under torch.profiler: (device busy us summed over
    kernels, wall us, kernels launched)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    busy, count = 0.0, 0
    for e in prof.key_averages():
        if "cuda" in str(e.device_type).lower():
            us = float(getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0)))
            if us > 0:
                busy += us
                count += e.count
    return busy, wall, count


def fluid_bert_leg(torch, fluid, leg):
    """One leg of the fluid BERT path at full width on the card:
    startup on `fluid.Executor()`, warm-up steps, then timed steps with
    the flash launch counts zeroed just before them and read just after,
    then one profiled step for the device's busy share."""
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    cfg = bert_cfg(leg["seq"])
    main, startup, total, _ = build_fluid_bert(fluid, cfg, leg["seq"],
                                               leg["remat"])
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = bert.bert_feed(cfg, leg["batch"], leg["seq"])
    n_pred = feed["mask_pos"].shape[1]

    def step():
        return float(exe.run(main, feed=feed, fetch_list=[total],
                             scope=scope)[0][0])

    losses = [step() for _ in range(BERT_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.fwd_launches = fa.dkv_launches = fa.dq_launches = 0
    fa.tc_launches = dict.fromkeys(fa.tc_launches, 0)
    step_ms = []
    for _ in range(BERT_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"forward": fa.fwd_launches, "dkv": fa.dkv_launches,
                "dq": fa.dq_launches}
    tc_launches = dict(fa.tc_launches)
    peak = torch.cuda.max_memory_allocated()
    busy, wall, kernels = device_busy_share(torch, step)
    L = cfg.num_hidden_layers
    flash = leg["seq"] >= fluid.get_flags(
        "FLAGS_flash_attention_min_seq")["FLAGS_flash_attention_min_seq"]
    # a step runs each layer's attention forward once, and once more in
    # the backward's recompute under remat; dK/dV and dQ once
    fwd_per_step = (2 if leg["remat"] else 1) * L if flash else 0
    want = {"forward": fwd_per_step * BERT_STEPS,
            "dkv": (L if flash else 0) * BERT_STEPS,
            "dq": (L if flash else 0) * BERT_STEPS}
    median_s = statistics.median(step_ms) / 1e3
    flops = bert_model_flops(cfg, leg["batch"], leg["seq"], n_pred)
    res = {"leg": leg["name"], "seq": leg["seq"], "batch": leg["batch"],
           "layers": L, "hidden": cfg.hidden_size, "vocab": cfg.vocab_size,
           "masked_per_seq": n_pred, "scan_remat": leg["remat"],
           "attention": "flash kernels" if flash else "composite",
           "losses": losses, "step_ms": step_ms,
           "median_step_ms": median_s * 1e3,
           "tokens_per_sec": leg["batch"] * leg["seq"] / median_s,
           "model_flops_per_step": flops,
           "mfu_vs_bf16_peak": flops / median_s / BF16_FLOPS_PER_S,
           "peak_mem_bytes": peak, "profiled_step": {
               "wall_us": wall, "device_busy_us": busy,
               "device_busy_share": busy / wall, "kernels": kernels},
           "launches": launches, "launches_expected": want,
           "tensor_core_launches": tc_launches}
    first_want = math.log(cfg.vocab_size) + math.log(2)
    check(all(math.isfinite(x) for x in losses),
          "fluid bert %s: non-finite loss %s" % (leg["name"], losses))
    check(abs(losses[0] - first_want) <= BERT_LOSS0_TOL,
          "fluid bert %s: first loss %g, expected %g +- %g" % (
              leg["name"], losses[0], first_want, BERT_LOSS0_TOL))
    check(launches == want and tc_launches == want,
          "fluid bert %s: flash launches %s (tensor cores %s), expected %s"
          % (leg["name"], launches, tc_launches, want))
    del exe, scope
    torch.cuda.empty_cache()
    return res


def fluid_bert_kernels_vs_plain(torch, fluid):
    """One step of the S 4096 program with the flash kernels and one with
    their plain version (`attention_impl="reference"`), from the same
    params and feed: the loss and every parameter's gradient."""
    from paddle_tpu_torch.models import bert

    c = BERT_CHECK
    cfg = bert_cfg(c["seq"], c["layers"])
    feed = bert.bert_feed(cfg, c["batch"], c["seq"])
    out, state = {}, None
    for impl in ("auto", "reference"):
        main, startup, total, grads = build_fluid_bert(
            fluid, cfg, c["seq"], True, attention_impl=impl)
        exe = fluid.Executor()
        scope = fluid.Scope()
        if state is None:
            exe.run(startup, scope=scope)
            state = {n: scope.find_var(n).clone()
                     for n in scope.local_var_names()}
        else:
            for n, v in state.items():
                scope.set_var(n, v.clone())
        vals = exe.run(main, feed=feed, fetch_list=[total] + grads,
                       scope=scope, return_numpy=False)
        out[impl] = (float(vals[0].reshape(-1)[0]),
                     dict(zip(grads, (v.float() for v in vals[1:]))))
    lk, gk = out["auto"]
    lp, gp = out["reference"]
    grad_err = {n: float((gk[n] - gp[n]).norm()
                         / gp[n].norm().clamp_min(1e-30)) for n in gp}
    res = {"seq": c["seq"], "batch": c["batch"], "layers": c["layers"],
           "loss_kernel": lk, "loss_plain": lp,
           "loss_rel_err": abs(lk - lp) / abs(lp),
           "max_grad_rel_err": max(grad_err.values()),
           "grad_rel_err": grad_err,
           "tol": {"loss": BERT_CHECK_LOSS_RTOL,
                   "grads": BERT_CHECK_GRAD_RTOL}}
    check(math.isfinite(lk) and res["loss_rel_err"] <= BERT_CHECK_LOSS_RTOL
          and res["max_grad_rel_err"] <= BERT_CHECK_GRAD_RTOL,
          "fluid bert: kernels vs plain: loss rel err %g, max grad rel err "
          "%g" % (res["loss_rel_err"], res["max_grad_rel_err"]))
    return res


def phase_fluid_bert(torch, name):
    """BERT-base pretraining through the fluid static graph on the card:
    leg a at S 128 (composite attention), leg b at S 4096 (the three
    flash kernels, with the key bias and dropout inside them), then leg
    c, the kernels against their plain version on one step."""
    from paddle_tpu_torch import fluid

    res = {"phase": "fluid_bert", "config": "BERT-base (BertConfig.base)",
           "optimizer": "Adam 1e-4, bf16 AMP O2, fuse_optimizer_ops",
           "legs": [fluid_bert_leg(torch, fluid, leg)
                    for leg in BERT_FLUID_LEGS]}
    res["kernels_vs_plain"] = fluid_bert_kernels_vs_plain(torch, fluid)
    res.update(device=name, nvidia_smi=nvidia_smi_line())
    emit(res)
    return res


# -- phase 9 ------------------------------------------------------------------

def build_fluid_resnet(fluid, img, classes, lr, amp):
    """ResNet50 training as bench.py's `build_resnet_train_program`
    builds it, in fresh programs: `resnet(depth=50, scan_stages=True)`,
    softmax_with_cross_entropy then mean, Momentum(lr, 0.9) (with `amp`
    decorated bf16 O2 without loss scaling), `minimize`,
    `fuse_optimizer_ops`. Returns (main, startup, loss)."""
    from paddle_tpu_torch.fluid.contrib import mixed_precision
    from paddle_tpu_torch.models import resnet

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = RESNET_INIT_SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        image = fluid.layers.data("image", shape=[3, img, img],
                                  dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        logits = resnet.resnet(image, class_dim=classes, depth=50,
                               scan_stages=True)
        loss = fluid.layers.mean(
            fluid.layers.loss.softmax_with_cross_entropy(logits, label))
        opt = fluid.optimizer.MomentumOptimizer(lr, momentum=0.9)
        if amp:
            opt = mixed_precision.decorate(opt,
                                           use_dynamic_loss_scaling=False)
        opt.minimize(loss)
        fluid.fuse_optimizer_ops(main)
    return main, startup, loss


def resnet_feed(batch, img, classes):
    """bench.py's `_resnet_feed`: images and labels from RandomState(0)."""
    import numpy as np

    r = np.random.RandomState(0)
    return {"image": r.randn(batch, 3, img, img).astype("float32"),
            "label": r.randint(0, classes, (batch, 1)).astype("int64")}


def resnet_model_flops(main, batch):
    """Model FLOPs of one training step: 2 x the multiply-adds of every
    conv2d (output elements x input channels a group x kernel area) and
    fc (`mul`) of the forward, a scan's body counted once an iteration,
    times 3 for the forward and the backward's two products."""
    def block_macs(block):
        macs = 0
        for op in block.ops:
            if op.type == "conv2d":
                out = block._find_var_recursive(op.output("Output")[0])
                w = block._find_var_recursive(op.input("Filter")[0])
                macs += math.prod(out.shape[1:]) * math.prod(w.shape[1:])
            elif op.type == "mul":
                w = block._find_var_recursive(op.input("Y")[0])
                macs += math.prod(w.shape)
            elif op.type == "scan":
                macs += op.attrs["n"] * block_macs(
                    main.block(op.attrs["sub_block"]))
        return macs

    return 3 * 2 * block_macs(main.global_block()) * batch


def attention_launches():
    """The five attention kernels' launch counters, by kernel."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    return {"ragged_paged_attention": rpa.launches - rpa.quant_launches,
            "ragged_paged_attention_int8": rpa.quant_launches,
            "flash_attention_forward": fa.fwd_launches,
            "flash_attention_dkv": fa.dkv_launches,
            "flash_attention_dq": fa.dq_launches}


def zero_attention_launches():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    rpa.launches = rpa.quant_launches = 0
    fa.fwd_launches = fa.dkv_launches = fa.dq_launches = 0
    fa.tc_launches = dict.fromkeys(fa.tc_launches, 0)


def fluid_resnet_leg_a(torch, fluid):
    """Leg a: the bench.py workload at batch 128 on the card: startup,
    warm-up steps, timed steps (the attention kernels' counts zeroed just
    before them and read just after), one profiled step."""
    c = RESNET_A
    main, startup, loss = build_fluid_resnet(fluid, c["img"], c["classes"],
                                             c["lr"], c["amp"])
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = resnet_feed(c["batch"], c["img"], c["classes"])

    def step():
        return float(exe.run(main, feed=feed, fetch_list=[loss],
                             scope=scope)[0][0])

    t0 = time.perf_counter()
    losses = [step() for _ in range(RESNET_WARMUP)]
    warmup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_attention_launches()
    step_ms = []
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = attention_launches()
    peak = torch.cuda.max_memory_allocated()
    busy, wall, kernels = device_busy_share(torch, step)
    median_s = statistics.median(step_ms) / 1e3
    flops = resnet_model_flops(main, c["batch"])
    res = dict(c, depth=50, scan_stages=True, losses=losses,
               first_loss=losses[0], last_loss=losses[-1],
               warmup_s=warmup_s, step_ms=step_ms,
               median_step_ms=median_s * 1e3,
               images_per_sec=c["batch"] / median_s,
               model_flops_per_step=flops,
               gflop_per_image=flops / c["batch"] / 1e9,
               mfu_vs_bf16_peak=flops / median_s / BF16_FLOPS_PER_S,
               peak_mem_bytes=peak,
               profiled_step={"wall_us": wall, "device_busy_us": busy,
                              "device_busy_share": busy / wall,
                              "kernels": kernels},
               attention_launches=launches,
               cudnn_benchmark=torch.backends.cudnn.benchmark)
    check(all(math.isfinite(x) for x in losses),
          "fluid resnet a: non-finite loss %s" % losses)
    check(not any(launches.values()),
          "fluid resnet a: attention kernels launched: %s" % launches)
    del exe, scope
    torch.cuda.empty_cache()
    return res


def fluid_resnet_leg_b(torch, fluid):
    """Leg b: the same program at 32 x 32, fp32, AMP off, on the card and
    on the CPU from one startup state (zero-gamma): the steps' losses, the
    for_test clone's loss and every running statistic."""
    import numpy as np

    from paddle_tpu_torch.core.scope import dump_numpy_state, \
        load_numpy_state

    c = RESNET_B
    main, startup, loss = build_fluid_resnet(fluid, c["img"], c["classes"],
                                             c["lr"], c["amp"])
    test = main.clone(for_test=True)
    feed = resnet_feed(c["batch"], c["img"], c["classes"])
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    stats = [n for n in names if n.endswith(("_bn_mean", "_bn_var"))]
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    state = dump_numpy_state(scope, names)
    state.update((n, np.zeros_like(v)) for n, v in state.items()
                 if n.endswith("2c_bn_scale"))
    out = {}
    for where, place in (("card", None), ("cpu", fluid.CPUPlace())):
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        load_numpy_state(scope, state, exe.device)
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0][0])
                  for _ in range(RESNET_B_STEPS)]
        losses.append(float(exe.run(test, feed=feed, fetch_list=[loss],
                                    scope=scope)[0][0]))
        out[where] = (losses, dump_numpy_state(scope, stats))
    card, cpu = out["card"], out["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
    stat_err = {n: float(np.linalg.norm(card[1][n] - cpu[1][n])
                         / max(np.linalg.norm(cpu[1][n]), 1e-30))
                for n in stats}
    res = dict(c, losses=card[0], losses_cpu=cpu[0],
               loss_rel_err=loss_err, stats=len(stats),
               max_stat_rel_err=max(stat_err.values()), tol=RESNET_B_RTOL)
    check(all(math.isfinite(x) for x in card[0])
          and loss_err <= RESNET_B_RTOL
          and res["max_stat_rel_err"] <= RESNET_B_RTOL,
          "fluid resnet b: card vs CPU: loss rel err %g, max running stat "
          "rel err %g" % (loss_err, res["max_stat_rel_err"]))
    return res


def phase_fluid_resnet(torch, name):
    """ResNet50 ImageNet training through the fluid static graph on the
    card: leg a at full size (batch 128), leg b the card against the
    CPU."""
    from paddle_tpu_torch import fluid

    res = {"phase": "fluid_resnet",
           "config": "ResNet50 (models/resnet.py, scan_stages)",
           "optimizer": "Momentum 0.1/0.9, bf16 AMP O2, "
                        "fuse_optimizer_ops",
           "leg_a": fluid_resnet_leg_a(torch, fluid),
           "leg_b": fluid_resnet_leg_b(torch, fluid)}
    res.update(device=name, nvidia_smi=nvidia_smi_line())
    emit(res)
    return res


def leaves(tree, prefix=""):
    """(path, tensor) for every leaf of a nested dict, in order."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from leaves(val, prefix + key + "/")
        else:
            yield prefix + key, val


def kernel_entry(name, replaces, launches, case, prefill):
    """An RPA kernel's line at the decode bucket, with its prefill case's
    times beside."""
    return {"name": name, "route": "cuda", "source": RPA_SOURCE,
            "replaces": replaces, "launches": launches,
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"],
            "library_ms": case["library_ms"], "at_case": case["case"],
            "prefill": {key: prefill[key] for key in (
                "case", "ms", "plain_ms", "library_ms", "bound_ms")}}


def flash_times(kname, case):
    """A flash kernel's numbers in one phase 5 case. library_ms is
    scaled_dot_product_attention's forward for the forward kernel and its
    backward (dq, dk and dv together) for the two backward kernels;
    `design` says how the kernel runs ("wgmma bf16" or "simt ...") and
    `tflops` is its rate on the attending pairs."""
    k = case["kernels"][kname]
    errs = case["max_abs_err"]
    err = {"forward": max(errs["o"], errs["lse"]),
           "dkv": max(errs["dk"], errs["dv"]), "dq": errs["dq"]}[kname]
    lib = case["library_ms"]["forward" if kname == "forward"
                             else "backward"]
    return {"max_abs_err": err, "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": lib, "design": k["route"], "tflops": k["tflops"],
            "at_case": case["case"]}


def flash_entry(kname, replaces, launches, case, bert_launches, bert_case):
    """A flash kernel's line: its launches on the trainer's path (phase 6)
    and its numbers at the trainer's shape (case a); beside them, its
    launches on the fluid BERT path at S 4096 (phase 8, leg b) and its
    numbers at that shape."""
    return dict({"name": "flash_attention_" + kname, "route": "cuda",
                 "source": FLASH_SOURCE, "replaces": replaces,
                 "launches": launches}, **flash_times(kname, case),
                fluid_bert=dict(launches=bert_launches,
                                **flash_times(kname, bert_case)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the "
              "card", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paddle_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(paddle_tpu_torch/ not found beside it)", file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    name = phase_device(torch)
    phase_build()
    timer = Timer(torch)
    cases = phase_kernel_cases(torch, timer)
    flash = phase_flash_cases(torch, timer)

    from paddle_tpu_torch import serving

    model = serving.TinyDecoderLM(serving.TinyLMConfig(**BERT_BASE))
    bf16 = run_main_path(torch, serving, model, "bfloat16",
                         serving.synthetic_trace(**BF16_TRACE))
    int8 = run_main_path(torch, serving, model, "int8",
                         serving.synthetic_trace(**INT8_TRACE))
    phase_forward_kernel_vs_plain(torch, serving, model)
    del model
    torch.cuda.empty_cache()
    train = phase_training(torch)
    phase_fluid(torch, name)
    fluid_bert = phase_fluid_bert(torch, name)
    phase_fluid_resnet(torch, name)

    float_err = max(cases[n]["max_abs_err"] for n in cases
                    if "int8" not in n)
    quant_err = max(cases[n]["max_abs_err"] for n in cases if "int8" in n)
    kernels = {"kernels": [
        dict(kernel_entry("ragged_paged_attention", RPA_TPU + ":172",
                          bf16["kernel_launches"], cases["decode_bf16"],
                          cases["prefill_bf16"]),
             max_abs_err=float_err),
        dict(kernel_entry("ragged_paged_attention_int8", RPA_TPU + ":235",
                          int8["int8_kernel_launches"],
                          cases["decode_int8"], cases["prefill_int8"]),
             max_abs_err=quant_err),
    ] + [flash_entry(kname, FLASH_TPU + ":" + line, train["launches"][kname],
                     flash[FLASH_CASES[0]["name"]],
                     fluid_bert["legs"][1]["launches"][kname],
                     flash["bert_s4096_bf16"])
         for kname, line in (("forward", "109"), ("dkv", "235"),
                             ("dq", "298"))]}
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start,
                                             3)})
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print("chip_smoke: FAILED: %s" % e, file=sys.stderr)
        sys.exit(1)
