"""serving.Engine — the persistent inference runtime front end
(counterpart: `paddle_tpu/serving/engine.py`).

One Engine owns: a model (`TinyDecoderLM`), the paged KV cache on the
device, the continuous-batching scheduler, and the per-bucket
dispatcher. Callers interact through three thread-safe verbs:

    req = engine.submit(prompt_ids, max_new_tokens=32)   # enqueue
    for tok in req.stream(): ...                         # consume
    req.cancel()                                         # evict

and the engine advances by `step()` (or `run_until_idle()`); each step
retires/admits between decode steps and issues at most one prefill and
one decode dispatch, both at fixed bucket shapes. The one host sync per
dispatch is the harvest of the selected tokens, which EOS detection and
streaming need.

The engine runs on the card unless the caller asks for the CPU
(``device="cpu"``); with ``device=None`` and no CUDA device it raises.
The metrics-registry hooks of the JAX engine are not ported; `stats()`
is.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.place import resolve_device
from .aot import BucketCompiler
from .convert import load_jax_params
from .kv_cache import PagedKVCache
from .scheduler import BucketPlan, Request, RequestState, Scheduler

__all__ = ["EngineConfig", "Engine", "drain_manifest_entry",
           "adopt_submit_kwargs", "default_grace_s"]


def default_grace_s() -> float:
    """The drain grace window (seconds) between a preemption notice and
    reclaim: PADDLE_PREEMPT_GRACE_S env, default 30."""
    try:
        return float(os.environ.get("PADDLE_PREEMPT_GRACE_S", 30.0))
    except ValueError:
        return 30.0


@dataclass(frozen=True)
class EngineConfig:
    """Serving knobs; `from_flags` reads the FLAGS_tpu_serving_* surface."""

    num_pages: int = 512
    page_size: int = 16
    max_seqs: int = 8
    max_queue: int = 0
    max_context: Optional[int] = None  # None = the model's max_seq
    attention_impl: str = "auto"
    kv_dtype: str = "float32"  # "float32" | "bfloat16" | "float16" | "int8"
    quantize_weights: bool = False     # int8 weights: not ported yet
    prefix_cache: bool = True          # share/COW prompt-prefix pages
    aging_steps: int = 32              # priority aging (0 disables)
    cached_pages: object = None        # prefix-cache budget: pages, or
    #                                    "64mb"-style byte strings; None
    #                                    reads the flag, 0 = unbounded

    @staticmethod
    def from_flags(**overrides) -> "EngineConfig":
        from ..utils.flags import get_flag

        kw = dict(
            num_pages=int(get_flag("FLAGS_tpu_serving_num_pages", 512)),
            page_size=int(get_flag("FLAGS_tpu_serving_page_size", 16)),
            max_seqs=int(get_flag("FLAGS_tpu_serving_max_seqs", 8)),
            max_queue=int(get_flag("FLAGS_tpu_serving_max_queue", 0)),
            attention_impl=str(get_flag(
                "FLAGS_tpu_serving_attention_impl", "auto") or "auto"),
            kv_dtype=str(get_flag(
                "FLAGS_tpu_serving_kv_dtype", "float32") or "float32"),
            quantize_weights=bool(get_flag(
                "FLAGS_tpu_serving_quantize_weights", False)),
            prefix_cache=bool(get_flag(
                "FLAGS_tpu_serving_prefix_cache", True)),
            aging_steps=int(get_flag(
                "FLAGS_tpu_serving_aging_steps", 32)),
            cached_pages=get_flag("FLAGS_tpu_serving_cached_pages", 0),
        )
        kw.update(overrides)
        return EngineConfig(**kw)


def drain_manifest_entry(req) -> dict:
    """One drain() manifest entry for an unfinished request: the
    continuation prompt is the original prompt PLUS the tokens already
    generated, with the remaining budget — the survivor's re-prefill
    reproduces the stream (see Engine.drain)."""
    return {
        "prompt": [int(t) for t in req.prompt]
        + [int(t) for t in req.output_tokens],
        "max_new_tokens": int(req.max_new_tokens)
        - len(req.output_tokens),
        "eos_id": req.eos_id,
        "tenant": req.tenant,
        "already_emitted": len(req.output_tokens),
        "priority": req.priority,
        "temperature": req.temperature,
        "top_k": req.top_k,
        "top_p": req.top_p,
        "seed": req.seed,
        # the adopter's streams keep drawing per-index sampling keys
        # where this engine stopped
        "sample_step_offset": req.sample_step_offset
        + len(req.output_tokens),
    }


def adopt_submit_kwargs(entry) -> dict:
    """submit() kwargs for one manifest entry — the adopt() half of the
    same shared contract (prompt arrives as the positional arg)."""
    return dict(
        max_new_tokens=int(entry["max_new_tokens"]),
        eos_id=entry.get("eos_id"),
        tenant=entry.get("tenant", ""),
        priority=int(entry.get("priority", 0)),
        temperature=float(entry.get("temperature", 0.0)),
        top_k=int(entry.get("top_k", 0)),
        top_p=float(entry.get("top_p", 1.0)),
        seed=int(entry.get("seed", 0)),
        sample_step_offset=int(entry.get(
            "sample_step_offset", entry.get("already_emitted", 0))))


class Engine:
    """Continuous-batching serving engine over a paged KV cache.

    `params`: None fills the model from `seed` (`init_params`); a
    JAX-layout params dict of numpy arrays is loaded with
    `convert.load_jax_params`. `device`: None means ``cuda:0`` and raises
    without a CUDA device; pass ``"cpu"`` to run on the CPU. On the card
    each bucket is captured as a CUDA graph (`serving/aot.py`) unless
    `FLAGS_cuda_graphs` is off; `graph_runner` stands in for capture and
    replay on the CPU (tests only)."""

    def __init__(self, model, params=None, config: Optional[
            EngineConfig] = None, seed: int = 0, device=None,
            graph_runner=None):
        self.config = config or EngineConfig.from_flags()
        if self.config.quantize_weights:
            raise NotImplementedError(
                "int8 weight quantization (serving/quantize.py) is not "
                "ported yet")
        self.device = resolve_device(device)
        self.model = model
        model_impl = getattr(model, "attention_impl", None) or "auto"
        if self.config.attention_impl != "auto":
            if model_impl not in ("auto", self.config.attention_impl):
                raise ValueError(
                    "EngineConfig.attention_impl=%r conflicts with "
                    "model.attention_impl=%r (use one impl per model "
                    "instance)" % (self.config.attention_impl, model_impl))
            model.attention_impl = self.config.attention_impl
        model.to(self.device)
        if params is None:
            model.init_params(seed)
        else:
            load_jax_params(model, params)
        # the TRUE per-request bound is the model's max_seq; pages
        # round UP to whole pages, so the pool bound can be looser
        max_ctx = min(self.config.max_context or model.config.max_seq,
                      model.config.max_seq)
        pages_per_seq = -(-int(max_ctx) // self.config.page_size)
        self.kv = PagedKVCache(model.kv_cache_spec(
            self.config.num_pages, self.config.page_size,
            pages_per_seq, dtype=self.config.kv_dtype),
            prefix_cache=self.config.prefix_cache,
            cached_pages=self.config.cached_pages)
        self.plan = BucketPlan.from_flags(
            self.config.max_seqs, self.kv.config.max_context)
        self.scheduler = Scheduler(self.kv, self.plan,
                                   self.config.max_seqs,
                                   self.config.max_queue,
                                   max_context=max_ctx,
                                   aging_steps=self.config.aging_steps)
        self.pages = self.kv.init_device_state(self.device)
        self._lock = threading.RLock()
        self._steps = 0
        self._tokens_generated = 0
        self._dispatches = {"prefill": 0, "decode": 0}
        self._dispatch_s = {"prefill": 0.0, "decode": 0.0}
        self._t_started = time.time()
        self._closed = False
        self._draining = False
        self._compiler = BucketCompiler(model, self.kv.config.pages_per_seq,
                                        self.device,
                                        graph_runner=graph_runner)

    # -- public verbs ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16,
               eos_id: Optional[int] = None, tenant: str = "",
               priority: int = 0, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0, seed: int = 0,
               sample_step_offset: int = 0) -> Request:
        """Enqueue one generation request (thread-safe). Raises when
        the prompt exceeds max context or the bounded queue is full
        (FLAGS_tpu_serving_max_queue).

        `priority` is the scheduling class (higher preempts strictly
        lower). `temperature` > 0 samples with a per-request `seed` and
        the token index (0 = greedy argmax, the default); `top_k` /
        `top_p` filter the distribution first. `sample_step_offset`
        counts tokens the stream already emitted elsewhere (drain/adopt),
        so a migrated sampled stream keeps its per-index draws."""
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            if self._draining:
                raise RuntimeError(
                    "engine is draining (preemption notice) — "
                    "resubmit on the survivor")
            return self.scheduler.new_request(
                prompt, max_new_tokens, eos_id=eos_id, tenant=tenant,
                priority=priority, temperature=temperature,
                top_k=top_k, top_p=top_p, seed=seed,
                sample_step_offset=sample_step_offset)

    def cancel(self, request: Request) -> None:
        """Cancel a request: its stream closes and its KV pages free at
        the next step boundary (immediate when it is still queued)."""
        request.cancel()

    def warmup(self) -> dict:
        """Compile every scheduler bucket before first traffic: one eager
        run with all rows inactive (only the scratch page is written),
        then the capture. Returns the BucketCompiler report plus the
        bucket list."""
        with self._lock:
            report = self._compiler.warmup(self.plan.all_buckets(),
                                           self.pages)
        report["buckets"] = [list(b) for b in self.plan.all_buckets()]
        return report

    def step(self) -> dict:
        """One engine iteration: retire -> admit -> prefill dispatch ->
        decode dispatch. Returns step stats."""
        if self._closed:
            raise RuntimeError("engine is closed")
        t0 = time.perf_counter()
        with self._lock:
            self.scheduler.retire()
            admitted, preempted = self.scheduler.admit()
            # copy-on-write boundary pages queued at admission MUST be
            # materialized before any dispatch of this step can write
            self._apply_cow_copies()
            prefill_stats = self._run_prefill()
            decode_stats = self._run_decode()
            self.scheduler.retire()
            self._steps += 1
            hit = sum(self.kv.seq_cached_tokens(r.request_id)
                      for r in admitted)
            return {
                "step": self._steps,
                "queue_depth": self.scheduler.queue_depth,
                "running": len(self.scheduler.running),
                "kv_pages_in_use": self.kv.pages_in_use,
                "kv_pages_cached": self.kv.pages_cached,
                "prefix_hit_tokens": hit,
                "n_preempted": len(preempted),
                **prefill_stats, **decode_stats,
                "step_ms": round((time.perf_counter() - t0) * 1e3, 3),
            }

    def _apply_cow_copies(self) -> None:
        """Materialize pending copy-on-write pages in place: one row copy
        per (src, dst) pair over every per-layer tensor — int8 pools copy
        the per-slot scale tensors alongside the values."""
        for src, dst in self.kv.take_pending_copies():
            for entry in self.pages:
                for a in entry:
                    a[dst].copy_(a[src])

    def run_until_idle(self, max_steps: int = 100000) -> int:
        """Step until every submitted request finished. Returns the
        number of steps taken."""
        n = 0
        while not self.scheduler.idle and n < max_steps:
            self.step()
            n += 1
        return n

    def drain(self, grace_s: Optional[float] = None) -> dict:
        """Preemption-notice drain: stop admission, keep stepping so
        in-flight requests COMPLETE within the grace window, and export
        a migration manifest for whatever could not finish in time.

        Each manifest entry re-prefills on the survivor engine via
        `adopt()`: the new prompt is the original prompt PLUS the
        tokens already generated here, with the remaining token budget.
        Requests that could not finish retire as `cancelled` HERE;
        `already_emitted` tells the caller how many tokens the consumer
        already saw.

        Returns {"completed", "migrated": [entries...], "drain_s"}.
        submit() raises while draining or after close()."""
        grace = default_grace_s() if grace_s is None else float(grace_s)
        t0 = time.perf_counter()
        with self._lock:
            self._draining = True
            inflight = list(self.scheduler.queued) + \
                list(self.scheduler.running.values())
        deadline = t0 + grace
        while not self.scheduler.idle \
                and time.perf_counter() < deadline:
            self.step()
        manifest = []
        with self._lock:
            for req in inflight:
                if req.state == RequestState.FINISHED:
                    continue
                remaining = int(req.max_new_tokens) - \
                    len(req.output_tokens)
                if req.state == RequestState.CANCELLED \
                        or remaining <= 0:
                    continue
                manifest.append(drain_manifest_entry(req))
                req.cancel()
            self.scheduler.retire()
        completed = sum(1 for r in inflight
                        if r.state == RequestState.FINISHED)
        return {"completed": completed, "migrated": manifest,
                "drain_s": round(time.perf_counter() - t0, 6)}

    def adopt(self, manifest) -> list:
        """Survivor half of a drained migration: resubmit every
        manifest entry. Returns the new Request list, aligned with the
        manifest order."""
        return [self.submit(np.asarray(entry["prompt"], np.int32),
                            **adopt_submit_kwargs(entry))
                for entry in manifest]

    def close(self) -> None:
        """Cancel everything in flight and release the pool."""
        with self._lock:
            for req in list(self.scheduler.queued) + \
                    list(self.scheduler.running.values()):
                req.cancel()
            self.scheduler.retire()
            self._compiler.release()
            self._closed = True

    # -- dispatch ----------------------------------------------------------
    def _dispatch(self, bucket: Tuple[int, int], group, tokens, ctx,
                  qlens) -> np.ndarray:
        """Pack one bucket into one host buffer, copy it into the
        bucket's device buffer in one transfer, run (or replay) the step,
        and harvest the selected tokens (the one host sync of a
        dispatch)."""
        B, T = bucket
        npages = self.kv.config.pages_per_seq
        tables = np.zeros((B, npages), np.int32)
        for b, req in enumerate(group):
            row = self.kv.block_table(req.request_id)
            tables[b, :len(row)] = row
        packed = torch.from_numpy(np.concatenate([
            tokens.astype(np.int32).reshape(-1), tables.reshape(-1),
            ctx.astype(np.int32), qlens.astype(np.int32)]))
        sampling = None
        if any(req.temperature > 0 for req in group):
            temps = np.zeros((B,), np.float32)
            top_ks = np.zeros((B,), np.int32)
            top_ps = np.ones((B,), np.float32)
            seeds = np.zeros((B,), np.int32)
            steps = np.zeros((B,), np.int32)
            for b, req in enumerate(group):
                temps[b] = req.temperature
                top_ks[b] = req.top_k
                top_ps[b] = req.top_p
                seeds[b] = req.seed
                # the token this dispatch emits is stream index
                # len(output_tokens); the offset carries indices a
                # previous engine already emitted (drain/adopt)
                steps[b] = req.sample_step_offset + len(req.output_tokens)
            sampling = tuple(torch.from_numpy(a).to(self.device)
                             for a in (temps, top_ks, top_ps, seeds, steps))
        next_tok, _logits, self.pages = self._compiler(
            bucket, self.pages, packed, sampling=sampling)
        return next_tok.cpu().numpy()

    def _run_prefill(self) -> dict:
        group, B, T = self.scheduler.prefill_group()
        if not group:
            return {"n_prefill": 0, "prefill_tokens": 0}
        t0 = time.perf_counter()
        tokens = np.zeros((B, T), np.int32)
        ctx = np.zeros((B,), np.int32)
        qlens = np.zeros((B,), np.int32)
        chunks = []
        for b, req in enumerate(group):
            # full_prompt: the original prompt, or prompt + generated
            # tokens when re-prefilling after a preemption; prefilled
            # starts at the prefix-cache hit, so fully cached chunks
            # are never dispatched
            prompt = req.full_prompt
            chunk = min(T, req.prefill_len - req.prefilled)
            tokens[b, :chunk] = prompt[req.prefilled:
                                       req.prefilled + chunk]
            qlens[b] = chunk
            ctx[b] = req.prefilled + chunk
            chunks.append(chunk)
        toks = self._dispatch((B, T), group, tokens, ctx, qlens)
        for b, req in enumerate(group):
            req.prefilled += chunks[b]
            req.context_len = req.prefilled
            if req.prefilled >= req.prefill_len:
                # final chunk: its last-row logits ARE the first
                # generated token. Index the now-complete prompt's
                # pages for future prefix sharing.
                self.kv.register_prefix(req.request_id,
                                        req.full_prompt)
                req.state = RequestState.RUNNING
                req.last_token = int(toks[b])
                req._emit(req.last_token)
                self._tokens_generated += 1
                self.scheduler.finish_if_done(req)
        self._dispatches["prefill"] += 1
        self._dispatch_s["prefill"] += time.perf_counter() - t0
        return {"n_prefill": len(group), "prefill_tokens": int(sum(chunks))}

    def _run_decode(self) -> dict:
        group, B = self.scheduler.decode_group()
        if not group:
            return {"n_decode": 0}
        t0 = time.perf_counter()
        tokens = np.zeros((B, 1), np.int32)
        ctx = np.zeros((B,), np.int32)
        qlens = np.zeros((B,), np.int32)
        for b, req in enumerate(group):
            tokens[b, 0] = req.last_token
            ctx[b] = req.context_len + 1  # incl. the token written now
            qlens[b] = 1
        toks = self._dispatch((B, 1), group, tokens, ctx, qlens)
        for b, req in enumerate(group):
            req.context_len += 1
            req.last_token = int(toks[b])
            req._emit(req.last_token)
            self._tokens_generated += 1
            self.scheduler.finish_if_done(req)
        self._dispatches["decode"] += 1
        self._dispatch_s["decode"] += time.perf_counter() - t0
        return {"n_decode": len(group)}

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        """Engine counters. ``prefill_ms_total``/``decode_ms_total`` are
        host-clock times of the dispatches, each ending in the token
        harvest (so they include the device's work)."""
        with self._lock:
            up = max(1e-9, time.time() - self._t_started)
            return {
                "steps": self._steps,
                "queue_depth": self.scheduler.queue_depth,
                "running": len(self.scheduler.running),
                "tokens_generated": self._tokens_generated,
                "tokens_per_sec": self._tokens_generated / up,
                "prefill_dispatches": self._dispatches["prefill"],
                "decode_dispatches": self._dispatches["decode"],
                "prefill_ms_total": self._dispatch_s["prefill"] * 1e3,
                "decode_ms_total": self._dispatch_s["decode"] * 1e3,
                "kv_pages_in_use": self.kv.pages_in_use,
                "kv_pages_cached": self.kv.pages_cached,
                "kv_occupancy": round(self.kv.occupancy, 4),
                "kv_peak_pages": self.kv.peak_pages_in_use,
                "prefix_cache": self.kv.prefix_cache,
                "prefix_hit_tokens": self.kv.prefix_hit_tokens,
                "cow_copies": self.kv.cow_copies,
                "prefix_evictions": self.kv.evictions,
                "preemptions": self.scheduler.preemption_count,
                "kv_page_dtype": self.kv.config.dtype,
                "kv_page_bytes": self.kv.config.page_bytes,
                "kv_pool_bytes": self.kv.config.pool_bytes,
                "kv_resident_batch": self.kv.config.resident_batch,
                "buckets_compiled": [
                    list(b) for b in self._compiler.compiled_buckets],
            }
