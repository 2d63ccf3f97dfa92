#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card's name and power limit (nvidia-smi's own line is
   printed as is, too);
2. build — every kernel under paddle_tpu_torch/csrc/ built with nvcc for
   sm_90a (ptxas's register and spill report included);
3. kernel cases — the ragged paged attention kernel against its plain
   PyTorch version on the card at the serving path's shapes (BERT-base
   heads: Hq = 12, D = 64, page 16, 32 pages per sequence): max abs error
   <= 2e-5 with rtol 1e-4, and exact zeros on inactive rows. Each case
   gives the kernel's, the plain version's and one PyTorch call's time
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
5. kernels — one line listing every ported kernel with its launches on
   its main path and its times;
6. the last line, ``{"ok": true, "device": {...}}``, printed only when
   every phase passed. Any failure exits non-zero.

It needs one card and exits non-zero without one, or without the
repository around it.
"""
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
FP32_FLOPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
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


def emit(obj):
    print(json.dumps(obj), flush=True)


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


# -- phase 1 ------------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    check(smi.returncode == 0 and line, "nvidia-smi failed: %s"
          % smi.stderr.strip())
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
    report = {name: [ln.strip() for ln in b["log"].splitlines()
                     if "registers" in ln or "spill" in ln]
              for name, b in built.items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "sources": sorted(built), "ptxas": report})


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


def make_case(torch, name, seed, S, Q, Hq, Hkv, ctx, qlen, dtype):
    """Seeded inputs at the serving path's page geometry: each sequence's
    live pages drawn at random from the 512-page pool."""
    D, page, pps, P = 64, POOL["page_size"], 32, POOL["num_pages"]
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


def kernel_entry(name, replaces, launches, case):
    return {"name": name, "route": "cuda", "source": RPA_SOURCE,
            "replaces": replaces, "launches": launches,
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"],
            "library_ms": case["library_ms"], "at_case": case["case"]}


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
    cases = phase_kernel_cases(torch, Timer(torch))

    from paddle_tpu_torch import serving

    model = serving.TinyDecoderLM(serving.TinyLMConfig(**BERT_BASE))
    bf16 = run_main_path(torch, serving, model, "bfloat16",
                         serving.synthetic_trace(**BF16_TRACE))
    int8 = run_main_path(torch, serving, model, "int8",
                         serving.synthetic_trace(**INT8_TRACE))
    phase_forward_kernel_vs_plain(torch, serving, model)

    float_err = max(cases[n]["max_abs_err"] for n in cases
                    if "int8" not in n)
    quant_err = max(cases[n]["max_abs_err"] for n in cases if "int8" in n)
    kernels = {"kernels": [
        dict(kernel_entry("ragged_paged_attention", RPA_TPU + ":172",
                          bf16["kernel_launches"], cases["decode_bf16"]),
             max_abs_err=float_err),
        dict(kernel_entry("ragged_paged_attention_int8", RPA_TPU + ":235",
                          int8["int8_kernel_launches"],
                          cases["decode_int8"]), max_abs_err=quant_err),
    ]}
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
