"""Continuous (in-flight) batching scheduler (counterpart:
`paddle_tpu/serving/scheduler.py`, copied; it imports nothing of JAX).

Requests are admitted and retired BETWEEN decode steps — the engine
never drains its batch to refill it. Each engine step:

1. retire finished/cancelled requests (KV pages freed immediately);
2. admit queued requests in effective-priority order (class priority
   plus an aging boost — FLAGS_tpu_serving_aging_steps — so a low
   class cannot starve in the queue) while a slot (< max_seqs) and
   worst-case KV pages are available; a blocked request whose CLASS
   outranks running work preempts: the victim's pages are freed and
   it re-queues marked for prefill-recompute (prompt + tokens so far
   re-prefill through the prefix cache — bit-identical continuation,
   same invariance the drain/adopt path rides);
3. prefill admitted-but-unprefilled requests in prompt-length-bucketed
   chunks (prompts longer than the largest bucket prefill in several
   chunks through the same unified step);
4. decode every running request in one fixed-shape bucket (the
   smallest configured batch bucket >= n, inactive slots padded with
   q_len = 0).

Every dispatch shape is therefore drawn from the finite bucket set —
the set `Engine.warmup()` runs once before first traffic.
"""
from __future__ import annotations

import itertools
import queue as _queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Request", "RequestState", "BucketPlan", "Scheduler"]

_STREAM_END = object()


class RequestState:
    QUEUED = "queued"
    PREFILL = "prefill"    # admitted; pages reserved; prompt not fully in
    RUNNING = "running"    # decoding
    FINISHED = "finished"
    CANCELLED = "cancelled"


@dataclass
class Request:
    """One generation request. The engine owns all mutation; consumers
    read the stream via `next_token()` / `stream()` / `result()`."""

    request_id: int
    prompt: np.ndarray                     # [prompt_len] int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    tenant: str = ""
    priority: int = 0                      # higher = more urgent class
    # sampling: temperature 0 = greedy argmax (the default); > 0
    # samples via a per-request key folded with the token index, so a
    # stream is reproducible per seed no matter how it was batched,
    # preempted or migrated
    temperature: float = 0.0
    top_k: int = 0                         # 0 = no top-k filter
    top_p: float = 1.0                     # 1.0 = no nucleus filter
    seed: int = 0
    sample_step_offset: int = 0            # tokens emitted pre-adopt
    state: str = RequestState.QUEUED
    output_tokens: List[int] = field(default_factory=list)
    # engine-side sequence bookkeeping
    context_len: int = 0                   # tokens whose KV is cached
    prefilled: int = 0                     # prompt tokens consumed
    last_token: Optional[int] = None       # next decode input
    prefix_hit_tokens: int = 0             # prompt tokens cache covered
    preemptions: int = 0
    # set on preemption: prompt + tokens so far, the prefill-recompute
    # input (None = never preempted, prefill the original prompt)
    resume_prompt: Optional[np.ndarray] = None
    enqueued_step: int = 0                 # for the aging boost
    t_submit: float = field(default_factory=time.time)
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    _stream: "_queue.Queue" = field(default_factory=_queue.Queue,
                                    repr=False)
    _cancel: threading.Event = field(default_factory=threading.Event,
                                     repr=False)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def full_prompt(self) -> np.ndarray:
        """What prefill actually consumes: the original prompt, or —
        after a preemption — prompt + already-generated tokens."""
        return self.prompt if self.resume_prompt is None \
            else self.resume_prompt

    @property
    def prefill_len(self) -> int:
        return int(self.full_prompt.shape[0])

    @property
    def sampled(self) -> bool:
        return self.temperature > 0.0

    @property
    def done(self) -> bool:
        return self.state in (RequestState.FINISHED,
                              RequestState.CANCELLED)

    # -- consumer surface --------------------------------------------------
    def cancel(self) -> None:
        """Request cancellation; the engine retires the request (and
        frees its KV pages) at the next step boundary."""
        self._cancel.set()

    def next_token(self, timeout: Optional[float] = None):
        """Blocking stream read: the next generated token id, or None
        at end of stream."""
        item = self._stream.get(timeout=timeout)
        return None if item is _STREAM_END else item

    def stream(self, timeout: Optional[float] = None):
        """Iterate generated tokens as they land (ends on finish or
        cancel)."""
        while True:
            tok = self.next_token(timeout=timeout)
            if tok is None:
                return
            yield tok

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Drain the stream and return the full output token list."""
        for _ in self.stream(timeout=timeout):
            pass
        return list(self.output_tokens)

    # -- engine-side helpers ----------------------------------------------
    def _emit(self, token: int) -> None:
        self.output_tokens.append(int(token))
        if self.t_first_token is None:
            self.t_first_token = time.time()
        self._stream.put(int(token))

    def _close_stream(self) -> None:
        self._stream.put(_STREAM_END)


@dataclass(frozen=True)
class BucketPlan:
    """The finite dispatch-shape set: decode buckets are batch sizes at
    T=1; prefill buckets are (batch, chunk-token) pairs."""

    decode_batches: Tuple[int, ...]
    prefill_tokens: Tuple[int, ...]
    prefill_batch: int

    @staticmethod
    def from_flags(max_seqs: int,
                   max_context: Optional[int] = None) -> "BucketPlan":
        from ..utils.flags import get_flag

        def parse(name, default):
            raw = str(get_flag(name, default) or default)
            vals = sorted({int(v) for v in raw.split(",") if v.strip()})
            if not vals or min(vals) < 1:
                raise ValueError("%s must list positive ints, got %r"
                                 % (name, raw))
            return vals

        decode = [b for b in parse("FLAGS_tpu_serving_decode_buckets",
                                   "2,4,8") if b <= max_seqs]
        if not decode or max(decode) < max_seqs:
            decode.append(max_seqs)
        # min bucket >= 2: a batch-1 matmul (gemv) rounds differently
        # from the same row in a batched gemm; the bit-identical
        # batched-vs-sequential contract needs uniform per-row math
        decode = sorted({max(2, b) for b in decode})
        prefill = parse("FLAGS_tpu_serving_prefill_buckets", "16,64")
        if max_context:
            # a chunk can never exceed the engine's max context; keep
            # at least one bucket (clamped) so short-context engines
            # don't compile dead shapes
            kept = [t for t in prefill if t <= max_context]
            prefill = kept or [int(max_context)]
        return BucketPlan(decode_batches=tuple(decode),
                         prefill_tokens=tuple(prefill),
                         prefill_batch=max(2, min(4, max_seqs)))

    def decode_bucket(self, n: int) -> int:
        for b in self.decode_batches:
            if b >= n:
                return b
        return self.decode_batches[-1]

    def prefill_bucket(self, chunk_len: int) -> int:
        for t in self.prefill_tokens:
            if t >= chunk_len:
                return t
        return self.prefill_tokens[-1]

    @property
    def max_prefill_chunk(self) -> int:
        return self.prefill_tokens[-1]

    def all_buckets(self) -> List[Tuple[int, int]]:
        """Every (batch, T) dispatch shape the engine can issue — the
        warmup set."""
        out = [(b, 1) for b in self.decode_batches]
        out.extend((self.prefill_batch, t) for t in self.prefill_tokens)
        return out


class Scheduler:
    """Queue + running-set bookkeeping. All methods are called by the
    engine under its lock; the only cross-thread surface is `submit`'s
    queue append (also engine-locked)."""

    def __init__(self, kv_cache, plan: BucketPlan, max_seqs: int,
                 max_queue: int = 0, max_context: Optional[int] = None,
                 aging_steps: Optional[int] = None):
        if aging_steps is None:
            from ..utils.flags import get_flag

            aging_steps = int(get_flag(
                "FLAGS_tpu_serving_aging_steps", 32))
        self.kv = kv_cache
        self.plan = plan
        self.max_seqs = int(max_seqs)
        self.max_queue = int(max_queue)
        # starvation guard: a queued request's effective priority rises
        # one class per `aging_steps` admission rounds waited (<= 0
        # disables aging). Aging orders the QUEUE only — preemption
        # eligibility stays raw-class-strict, so an aged low class can
        # outwait higher classes but never evicts them.
        self.aging_steps = int(aging_steps)
        # the TRUE per-request context bound: the model's max_seq can
        # be tighter than the page-rounded pool bound (pages_per_seq *
        # page_size rounds UP) — admitting past it would clip
        # positions in the model and silently collide KV slots
        self.max_context = min(int(max_context), kv_cache.config.
                               max_context) if max_context else \
            kv_cache.config.max_context
        self.queued: deque = deque()
        self.running: Dict[int, Request] = {}  # admitted (prefill+decode)
        self._ids = itertools.count()
        self._step = 0           # admission rounds, the aging clock
        self.preemption_count = 0

    @property
    def queue_depth(self) -> int:
        return len(self.queued)

    def new_request(self, prompt, max_new_tokens, eos_id=None,
                    tenant="", priority=0, temperature=0.0, top_k=0,
                    top_p=1.0, seed=0,
                    sample_step_offset=0) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if not 0.0 < top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        total = prompt.size + int(max_new_tokens)
        if total > self.max_context:
            raise ValueError(
                "prompt %d + max_new %d exceeds max context %d"
                % (prompt.size, max_new_tokens, self.max_context))
        if self.max_queue and len(self.queued) >= self.max_queue:
            raise RuntimeError(
                "serving queue full (%d) — FLAGS_tpu_serving_max_queue"
                % self.max_queue)
        req = Request(request_id=next(self._ids), prompt=prompt,
                      max_new_tokens=int(max_new_tokens), eos_id=eos_id,
                      tenant=str(tenant), priority=int(priority),
                      temperature=float(temperature), top_k=int(top_k),
                      top_p=float(top_p), seed=int(seed),
                      sample_step_offset=int(sample_step_offset),
                      enqueued_step=self._step)
        self.queued.append(req)
        return req

    # -- step phases -------------------------------------------------------
    def effective_priority(self, req: Request) -> int:
        """Class priority plus the aging boost (queue ordering only)."""
        if self.aging_steps <= 0:
            return req.priority
        return req.priority + \
            (self._step - req.enqueued_step) // self.aging_steps

    def admit(self) -> Tuple[List[Request], List[Request]]:
        """Priority admission: reserve worst-case KV pages (the prefix
        cache discounts a cached prompt prefix to zero new pages) in
        effective-priority order, stopping at the first request that
        cannot be taken — no queue jumping past a blocked higher
        class. A blocked request preempts strictly-lower-CLASS running
        work: lowest class, latest admitted first; victims' pages free
        immediately and they re-queue marked for prefill-recompute.
        Returns (admitted, preempted)."""
        self._step += 1
        admitted: List[Request] = []
        preempted: List[Request] = []
        order = sorted(self.queued, key=lambda r: (
            -self.effective_priority(r), r.request_id))
        for req in order:
            if req._cancel.is_set():
                continue  # retire() publishes the cancellation
            total = req.prefill_len + req.max_new_tokens - \
                len(req.output_tokens)
            while not (len(self.running) < self.max_seqs and
                       self.kv.can_admit(total, prompt=req.full_prompt)):
                victim = self._pick_victim(req)
                if victim is None:
                    break
                self._preempt(victim)
                preempted.append(victim)
            if not (len(self.running) < self.max_seqs and
                    self.kv.alloc(req.request_id, total,
                                  prompt=req.full_prompt) is not None):
                break  # admission backpressure
            self.queued.remove(req)
            req.state = RequestState.PREFILL
            cached = self.kv.seq_cached_tokens(req.request_id)
            req.prefilled = cached
            req.context_len = cached
            req.prefix_hit_tokens += cached
            self.running[req.request_id] = req
            admitted.append(req)
        return admitted, preempted

    def _pick_victim(self, req: Request) -> Optional[Request]:
        """The running request a blocked `req` may evict: strictly
        lower RAW class (aging never licenses eviction), lowest class
        first, latest-admitted first within a class."""
        victims = [r for r in self.running.values()
                   if r.priority < req.priority and not r.done]
        if not victims:
            return None
        victims.sort(key=lambda r: (r.priority, -r.request_id))
        return victims[0]

    def _preempt(self, victim: Request) -> None:
        """Evict a running sequence: pages free now, the request
        re-queues marked for prefill-recompute — its next admission
        prefills prompt + tokens-so-far (warm through the prefix
        cache), which under the chunked-prefill invariance reproduces
        the stream bit-identically."""
        del self.running[victim.request_id]
        self.kv.free(victim.request_id)
        victim.state = RequestState.QUEUED
        victim.resume_prompt = np.concatenate(
            [victim.prompt,
             np.asarray(victim.output_tokens, np.int32)]) \
            if victim.output_tokens else victim.prompt
        victim.prefilled = 0
        victim.context_len = 0
        victim.last_token = None
        victim.preemptions += 1
        victim.enqueued_step = self._step
        self.preemption_count += 1
        self.queued.append(victim)

    def prefill_group(self) -> Tuple[List[Request], int, int]:
        """The next prefill dispatch: up to prefill_batch requests with
        prompt tokens still to consume, chunked to one (batch, T)
        bucket. Returns ([], 0, 0) when nothing needs prefill."""
        pending = [r for r in self.running.values()
                   if r.state == RequestState.PREFILL
                   and not r._cancel.is_set()]
        if not pending:
            return [], 0, 0
        pending.sort(key=lambda r: r.request_id)
        group = pending[:self.plan.prefill_batch]
        chunk = min(self.plan.max_prefill_chunk,
                    max(r.prefill_len - r.prefilled for r in group))
        return group, self.plan.prefill_batch, \
            self.plan.prefill_bucket(chunk)

    def decode_group(self) -> Tuple[List[Request], int]:
        """Every running (fully prefilled, uncancelled) request plus
        the bucket to pad to."""
        group = [r for r in self.running.values()
                 if r.state == RequestState.RUNNING
                 and not r._cancel.is_set()]
        group.sort(key=lambda r: r.request_id)
        if not group:
            return [], 0
        return group, self.plan.decode_bucket(len(group))

    def retire(self) -> List[Request]:
        """Drop finished/cancelled requests from the running set and
        free their pages (cancel eviction is immediate). Cancelled
        requests still sitting in the QUEUE drain here too — retire()
        is the one place whose return the engine publishes, so every
        cancellation produces exactly one serving_request event."""
        out = []
        for req in [r for r in self.queued if r._cancel.is_set()]:
            self.queued.remove(req)
            self._finish(req, RequestState.CANCELLED)
            out.append(req)
        for rid in list(self.running):
            req = self.running[rid]
            if req._cancel.is_set() and not req.done:
                self._finish(req, RequestState.CANCELLED)
            if req.done:
                del self.running[rid]
                self.kv.free(rid)
                out.append(req)
        return out

    def _finish(self, req: Request, state: str) -> None:
        req.state = state
        req.t_finish = time.time()
        req._close_stream()

    def finish_if_done(self, req: Request) -> bool:
        """Apply the stop conditions after a token landed."""
        if req._cancel.is_set():
            return False  # retire() handles cancellation
        hit_eos = (req.eos_id is not None and req.output_tokens
                   and req.output_tokens[-1] == req.eos_id)
        if hit_eos or len(req.output_tokens) >= req.max_new_tokens:
            self._finish(req, RequestState.FINISHED)
            return True
        return False

    @property
    def idle(self) -> bool:
        return not self.queued and not self.running
