"""Synthetic multi-tenant request trace: the serving workload
(counterpart: `paddle_tpu/serving/trace.py`).

`synthetic_trace` builds a deterministic (seeded) request schedule for
N tenants — per-tenant arrival cadence, prompt-length and
output-length ranges — and `run_trace` replays it against an Engine:
requests are submitted at their scheduled engine-step arrival times
(continuous batching admits them between decode steps), the engine
runs until drained, and the summary (tokens/sec, request p50/p99,
prefix-cache hits) is returned.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

__all__ = ["TraceRequest", "synthetic_trace", "run_trace"]


@dataclass(frozen=True)
class TraceRequest:
    arrival_step: int
    tenant: str
    prompt: np.ndarray
    max_new_tokens: int
    priority: int = 0


def synthetic_trace(n_requests: int = 24, n_tenants: int = 3,
                    seed: int = 0, vocab: int = 64,
                    prompt_range=(4, 24), output_range=(4, 16),
                    arrival_every=(0, 3), system_prompt_range=(0, 0),
                    tenant_priorities=None) -> List[TraceRequest]:
    """Deterministic multi-tenant trace: tenant t's requests arrive
    every ~arrival_every steps with tenant-skewed prompt/output
    lengths (tenant 0 short-prompt chatty, last tenant long-prompt
    batchy — the mix continuous batching exists for).

    `system_prompt_range` (lo, hi) prepends one fixed per-tenant
    system prompt of a seeded length in [lo, hi] to every request of
    that tenant — the repeated prefix the serving prefix cache exists
    for ((0, 0) = no system prompts, the pre-prefix-cache trace).
    `prompt_range` then sizes the unique per-request remainder.
    `tenant_priorities` (len n_tenants) assigns scheduling classes per
    tenant (default all 0)."""
    r = np.random.RandomState(seed)
    n_tenants = int(n_tenants)
    sys_lo, sys_hi = system_prompt_range
    sys_prompts = [
        r.randint(0, vocab, size=int(r.randint(sys_lo, sys_hi + 1))
                  if sys_hi > 0 else 0).astype(np.int32)
        for _ in range(n_tenants)]
    prios = list(tenant_priorities) if tenant_priorities else \
        [0] * n_tenants
    out: List[TraceRequest] = []
    step = 0
    for i in range(int(n_requests)):
        t = i % n_tenants
        skew = (t + 1) / float(n_tenants)
        lo, hi = prompt_range
        plen = int(lo + (hi - lo) * skew * r.uniform(0.5, 1.0))
        olo, ohi = output_range
        olen = int(r.randint(olo, ohi + 1))
        step += int(r.randint(arrival_every[0], arrival_every[1] + 1))
        body = r.randint(0, vocab, size=max(1, plen)).astype(np.int32)
        out.append(TraceRequest(
            arrival_step=step, tenant="tenant%d" % t,
            prompt=np.concatenate([sys_prompts[t], body]),
            max_new_tokens=max(1, olen), priority=int(prios[t])))
    return out


def run_trace(engine, trace: List[TraceRequest],
              max_steps: int = 100000,
              warmup: bool = True) -> dict:
    """Replay `trace` against `engine` (arrival_step is measured in
    engine steps) and run to drain. Returns the summary dict."""
    import time

    if warmup:
        engine.warmup()
    pending = sorted(trace, key=lambda tr: tr.arrival_step)
    requests = []
    i = 0
    step = 0
    t0 = time.perf_counter()
    while i < len(pending) or not engine.scheduler.idle:
        while i < len(pending) and pending[i].arrival_step <= step:
            tr = pending[i]
            requests.append(engine.submit(
                tr.prompt, max_new_tokens=tr.max_new_tokens,
                tenant=tr.tenant, priority=tr.priority))
            i += 1
        engine.step()
        step += 1
        if step >= max_steps:
            break
    wall_s = max(1e-9, time.perf_counter() - t0)
    tokens = sum(len(r.output_tokens) for r in requests)
    finished = sum(1 for r in requests if r.state == "finished")
    summary = {
        "requests": len(requests),
        "finished": finished,
        "steps": step,
        "tokens_generated": tokens,
        "wall_s": round(wall_s, 4),
        "tokens_per_sec": round(tokens / wall_s, 3),
        "prefix_hit_tokens": engine.kv.prefix_hit_tokens,
        "cow_copies": engine.kv.cow_copies,
        "preemptions": engine.scheduler.preemption_count,
    }
    return summary
