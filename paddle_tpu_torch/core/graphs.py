"""CUDA-graph capture of a step (counterpart: the reference's `jax.jit`
of a whole block with `donate_argnums`, `paddle_tpu/fluid/lowering.py
compile_block`, and its ahead-of-time bucket compiles,
`paddle_tpu/serving/aot.py`).

The reference traces a step once and dispatches the compiled program
every step. The port runs a step's ops eagerly once (which warms cuDNN's
algorithm choice, the allocator and cached constants), records the
second run into a `torch.cuda.CUDAGraph` over static buffers, and from
then on only refreshes the static inputs and replays the graph.

- `Graph`: one captured graph. `capture(body)` records `body()` on a side
  stream into a memory pool (one per graph, or a `shared_pool()` that
  several graphs share, as the serving buckets do) and keeps what it
  returned; `replay()` relaunches it. The kernel wrappers count their
  launches in Python, so a capture counts what it recorded: `Graph`
  takes those counts back after the capture and adds them once for every
  replay, so the counters go on counting launches on the card.
- `DonatedStep`: a step function over named feeds and states run as one
  graph with the states donated: its static state buffers are the
  tensors the caller keeps (the scope's), the graph's last work copies
  each new value into the buffer it was read from, and an output that
  shares memory with a buffer about to be written is cloned first.
  Before each replay a state whose tensor is not the static buffer (the
  caller rebound it) is copied in, and a change of shape, dtype or
  device is an error.

A capture that fails raises; nothing falls back to eager execution. The
`runner` argument stands in for capture and replay where there is no
card: it receives the step's body and calls it, so the static-buffer and
write-back logic runs on the CPU. Only the tests pass one.
"""
from __future__ import annotations

import gc
import time
import weakref
from typing import Callable, Dict, List, Tuple

import torch

from .rng import StepSeed, seed_tensor

__all__ = ["Graph", "DonatedStep", "shared_pool", "launch_counts",
           "release_collective_graphs"]

#: the captured graphs that recorded collectives, until released. NCCL
#: does not destroy a communicator while a graph that captured its
#: collectives lives (the destroy waits for it), so leaving the world
#: releases them first (`distributed.shutdown_parallel_env`).
_COLLECTIVE_GRAPHS = weakref.WeakSet()


def _collective_calls() -> int:
    from ..ops import collective_ops

    return sum(s["calls"] for s in collective_ops.stats.values())


def release_collective_graphs() -> None:
    """Release every live graph that captured a collective."""
    for graph in list(_COLLECTIVE_GRAPHS):
        graph.release()


def launch_counts() -> Dict[str, int]:
    """A snapshot of every kernel wrapper's launch counter."""
    from ..ops.kernels import dropout, flash_attention, \
        ragged_paged_attention

    out = {"flash.forward": flash_attention.fwd_launches,
           "flash.dkv": flash_attention.dkv_launches,
           "flash.dq": flash_attention.dq_launches,
           "rpa": ragged_paged_attention.launches,
           "rpa.int8": ragged_paged_attention.quant_launches,
           "dropout": dropout.launches}
    for k, v in flash_attention.tc_launches.items():
        out["flash.tc." + k] = v
    for dtype, by in flash_attention.dtype_launches.items():
        for k, v in by.items():
            out["flash.%s.%s" % (dtype, k)] = v
    for dtype, v in dropout.dtype_launches.items():
        out["dropout." + dtype] = v
    return out


def _add_counts(delta: Dict[str, int], times: int) -> None:
    """Add `times` x `delta` to the kernel wrappers' counters."""
    from ..ops.kernels import dropout, flash_attention, \
        ragged_paged_attention

    fa, rpa = flash_attention, ragged_paged_attention
    fa.fwd_launches += times * delta.get("flash.forward", 0)
    fa.dkv_launches += times * delta.get("flash.dkv", 0)
    fa.dq_launches += times * delta.get("flash.dq", 0)
    rpa.launches += times * delta.get("rpa", 0)
    rpa.quant_launches += times * delta.get("rpa.int8", 0)
    dropout.launches += times * delta.get("dropout", 0)
    for k in fa.tc_launches:
        fa.tc_launches[k] += times * delta.get("flash.tc." + k, 0)
    for key, n in delta.items():
        parts = key.split(".")
        if key.startswith("flash.") and len(parts) == 3 \
                and parts[1] != "tc":
            by = fa.dtype_launches.setdefault(
                parts[1], {"forward": 0, "dkv": 0, "dq": 0})
            by[parts[2]] += times * n
        elif parts[0] == "dropout" and len(parts) == 2:
            dropout.dtype_launches[parts[1]] = \
                dropout.dtype_launches.get(parts[1], 0) + times * n


def shared_pool():
    """A memory pool handle that several graphs capture into."""
    return torch.cuda.graph_pool_handle()


class Graph:
    """One captured CUDA graph over static tensors.

    `device`: the card it runs on; `pool`: a `shared_pool()` handle, or
    None for a pool of its own; `runner`: see the module docstring.
    After `capture`, `capture_ms` is the host time of the capture,
    `pool_bytes` the device memory the caching allocator reserved during
    it, `launches` the wrapper-counted launches of one replay and
    `replays` the replays so far."""

    def __init__(self, device, pool=None, runner=None):
        self.device = torch.device(device)
        self.pool = pool
        self.runner = runner
        self.graph = None
        self.outputs = None
        self.capture_ms = None
        self.pool_bytes = 0
        self.launches: Dict[str, int] = {}
        self.replays = 0
        self._body = None

    @property
    def captured(self) -> bool:
        return self._body is not None

    def capture(self, body: Callable):
        """Record `body()` (which reads and writes only tensors that stay
        alive and in place) and keep its outputs; nothing runs yet.
        Raises, naming the cause, when the capture fails."""
        if self.runner is not None:
            self._body = body
            self.capture_ms = 0.0
            return
        if self.device.type != "cuda":
            raise RuntimeError("CUDA graphs need a CUDA device, not %s"
                               % self.device)
        before = launch_counts()
        collectives = _collective_calls()
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(self.device)
        with torch.cuda.device(self.device):
            # torch.cuda.graph empties the allocator's cache as it enters;
            # empty it first so that the growth of reserved memory is
            # what the capture took
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            t0 = time.perf_counter()
            # no garbage collection inside the capture: freeing another
            # graph there (a cycle holding one) would invalidate it
            gc_was_on = gc.isenabled()
            gc.disable()
            try:
                # thread_local: a device prefetcher's thread may copy the
                # next batch (and allocate pinned memory) meanwhile
                with torch.cuda.graph(graph, pool=self.pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    outputs = body()
            except Exception as e:
                after = launch_counts()
                _add_counts({k: after[k] - before.get(k, 0)
                             for k in after}, -1)
                raise RuntimeError(
                    "CUDA graph capture failed: %s: %s (an op read a "
                    "value on the host, or copied from pageable host "
                    "memory, inside the step)" % (type(e).__name__, e)) \
                    from e
            finally:
                if gc_was_on:
                    gc.enable()
            self.capture_ms = (time.perf_counter() - t0) * 1e3
            self.pool_bytes = torch.cuda.memory_reserved(self.device) \
                - reserved
        after = launch_counts()
        self.launches = {k: after[k] - before.get(k, 0) for k in after
                         if after[k] != before.get(k, 0)}
        # the capture recorded these launches; replays make them
        _add_counts(self.launches, -1)
        if _collective_calls() != collectives:
            _COLLECTIVE_GRAPHS.add(self)
        self.graph = graph
        self.outputs = outputs
        self._body = body

    def replay(self):
        """Launch the recorded work once more; returns the outputs the
        capture kept (the same tensors every time, rewritten)."""
        if not self.captured:
            raise RuntimeError("replay before capture")
        if self.runner is not None:
            self.outputs = self.runner(self._body)
        else:
            self.graph.replay()
            _add_counts(self.launches, 1)
        self.replays += 1
        return self.outputs

    def release(self):
        """Drop the graph, its outputs and its body's references (the
        pool's memory returns to the caching allocator)."""
        if self.graph is not None:
            self.graph.reset()
        _COLLECTIVE_GRAPHS.discard(self)
        self.graph = self.outputs = self._body = None


def _same_view(a, b) -> bool:
    return a.data_ptr() == b.data_ptr() and a.shape == b.shape \
        and a.stride() == b.stride() and a.dtype == b.dtype


def _storage(t) -> int:
    return t.untyped_storage().data_ptr()


class DonatedStep:
    """`fn(feeds, states, seed, keep=None) -> (fetches, new_states)` run
    warm, then captured, then replayed, with its states donated (see the
    module docstring). `fn` takes and returns dicts of name -> tensor
    (fetches a list); `seed` is a `core.rng.StepSeed` whose device
    tensor, under capture, is the static seed buffer written before each
    replay; `keep`, a list `fn` appends the tensors it bound to, keeps
    alive whatever the graph reads that it did not allocate (cached
    constants)."""

    def __init__(self, fn: Callable, device, pool=None, runner=None):
        self.fn = fn
        self.device = torch.device(device)
        self.graph = Graph(device, pool=pool, runner=runner)
        self.runs = 0
        self.feeds: Dict[str, torch.Tensor] = {}
        self.states: Dict[str, torch.Tensor] = {}
        self.seed = None
        self.keep: List[torch.Tensor] = []

    @property
    def phase(self) -> str:
        """"cold" (nothing run), "warm" (one eager run) or "captured"."""
        if self.graph.captured:
            return "captured"
        return "warm" if self.runs else "cold"

    def step(self, feeds: Dict[str, torch.Tensor],
             states: Dict[str, torch.Tensor],
             seed: int) -> Tuple[list, Dict[str, torch.Tensor]]:
        """One step. `states` holds the caller's current tensor of every
        state the step reads; `seed` is the step's seed. Returns
        (fetches, new_states): new_states maps every state the step wrote
        to the tensor the caller should keep (for a state it also read,
        its static buffer)."""
        if self.phase == "cold":
            self.runs += 1
            return self.fn(feeds, states,
                           StepSeed(seed, seed_tensor(seed, self.device)))
        if self.phase == "warm":
            self._make_static(feeds, states)
            self.seed.fill_(seed)
            self._capture_seed = seed
            self.graph.capture(self._body)
        else:
            self._refresh(feeds, states)
            self.seed.fill_(seed)
        self.runs += 1
        fetches, fresh = self.graph.replay()
        new_states = dict(self.states)
        new_states.update(fresh)
        return list(fetches), {n: new_states[n] for n in self.written}

    def release(self):
        self.graph.release()
        self.feeds, self.states, self.seed, self.keep = {}, {}, None, []

    # -- static buffers ------------------------------------------------
    def _make_static(self, feeds, states):
        self.feeds = {n: v.clone() for n, v in feeds.items()}
        # a clone of every state, so that no two names share memory
        self.states = {n: v.clone() for n, v in states.items()}
        self.seed = torch.zeros((), dtype=torch.int64, device=self.device)
        self.written: List[str] = []

    def _refresh(self, feeds, states):
        for n, v in feeds.items():
            self._check_like(n, v, self.feeds[n])
            self.feeds[n].copy_(v)
        for n, v in states.items():
            buf = self.states[n]
            if v is not buf:
                self._check_like(n, v, buf)
                buf.copy_(v)

    @staticmethod
    def _check_like(name, v, buf):
        if v.shape != buf.shape or v.dtype != buf.dtype \
                or v.device != buf.device:
            raise RuntimeError(
                "var %r is now %s %s on %s; the captured step holds it as "
                "%s %s on %s (close the executor to capture again)"
                % (name, tuple(v.shape), v.dtype, v.device,
                   tuple(buf.shape), buf.dtype, buf.device))

    def _body(self):
        """The captured work: the step over the static buffers, then the
        write-back of every new state into the buffer it was read from."""
        self.keep = []
        fetches, new = self.fn(self.feeds, self.states,
                               StepSeed(self._capture_seed, self.seed),
                               keep=self.keep)
        # the buffers that will be overwritten, and every output sharing
        # memory with one of them: cloned before any write
        targets = {n: self.states[n] for n, v in new.items()
                   if n in self.states and not _same_view(v, self.states[n])}
        hit = {_storage(b) for b in targets.values()}

        def safe(v):
            return v.clone() if _storage(v) in hit else v

        fetches = [safe(v) for v in fetches]
        new = {n: safe(v) for n, v in new.items()}
        for n, buf in targets.items():
            buf.copy_(new[n])
        self.written = list(new)
        return fetches, {n: v for n, v in new.items()
                         if n not in self.states}
