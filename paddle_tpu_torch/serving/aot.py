"""Per-bucket dispatch of the serving step, each bucket captured as a CUDA
graph (counterpart: `paddle_tpu/serving/aot.py`).

Every dispatch shape the scheduler can issue is a (batch, T) bucket from
`BucketPlan.all_buckets()`. The JAX package compiled one executable per
bucket ahead of traffic. Here `compile_bucket` runs a bucket once eagerly
with every row inactive (the rows go to the pool's scratch page, nothing
else is written; cuBLAS and the kernels warm up), then captures it into a
`torch.cuda.CUDAGraph` over a static input buffer and the engine's page
tensors; all buckets share one graph memory pool. A dispatch copies the
packed inputs into the bucket's buffer and replays; greedy tokens come
out of the graph, and rows with a temperature above 0 are sampled after
it by `sample_tokens`. A bucket dispatched before `warmup` compiled it
runs eagerly once and is captured on its second dispatch. On the CPU, or
with `FLAGS_cuda_graphs` off, every dispatch runs eagerly. There is no
persistent compile cache (a CUDA graph cannot be saved), so every bucket
reports ``status: None``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core import graphs
from ..utils.flags import get_flag
from .model import sample_tokens

__all__ = ["BucketCompiler"]


class _Bucket:
    """One bucket's static input buffer (its views: tokens, block tables,
    context lengths, query lengths), graph and eager runs."""

    def __init__(self, B, T, pps, device):
        self.inputs = torch.zeros((B * T + B * pps + 2 * B,),
                                  dtype=torch.int32, device=device)
        self.views = _split(self.inputs, B, T, pps)
        self.graph = None
        self.eager_runs = 0


def _split(packed, B, T, pps):
    """(tokens [B, T], tables [B, pps], ctx [B], q_lens [B]) views of one
    packed int32 buffer."""
    n_tok, n_tab = B * T, B * pps
    return (packed[:n_tok].view(B, T),
            packed[n_tok:n_tok + n_tab].view(B, pps),
            packed[n_tok + n_tab:n_tok + n_tab + B],
            packed[n_tok + n_tab + B:])


class BucketCompiler:
    """Dispatches the serving step per bucket. `step` signature:
    (tokens [B, T], pages, block_tables [B, NP], context_lens [B],
    q_lens [B], sampling=None) -> (next_tokens, last_logits, pages).
    `graph_runner` stands in for CUDA graph capture and replay on the CPU
    (tests only, `core/graphs.py`)."""

    def __init__(self, step, pages_per_seq: int, device, graph_runner=None):
        self._step = step
        self._pages_per_seq = int(pages_per_seq)
        self._device = torch.device(device)
        self._runner = graph_runner
        self._capture = graph_runner is not None or (
            self._device.type == "cuda"
            and bool(get_flag("FLAGS_cuda_graphs", True)))
        self._pool = None
        self._pages = None
        self._buckets: Dict[Tuple[int, int], _Bucket] = {}

    @property
    def mode(self) -> str:
        """"graph" (buckets captured) or "eager"."""
        return "graph" if self._capture else "eager"

    def compile_bucket(self, bucket, pages) -> dict:
        """Run bucket (B, T) once with every row inactive, then (in graph
        mode) capture it over `pages`. Returns {"bucket", "status": None,
        "capture_ms", "pool_bytes"} (the last two None when eager)."""
        B, T = int(bucket[0]), int(bucket[1])
        b = self._bucket(B, T, pages)
        b.inputs.zero_()
        self._run_eager(b, pages)
        if self._capture and b.graph is None:
            self._capture_bucket(b, pages)
        g = b.graph
        return {"bucket": [B, T], "status": None,
                "capture_ms": None if g is None else g.capture_ms,
                "pool_bytes": None if g is None else g.pool_bytes}

    def warmup(self, buckets, pages) -> dict:
        """`compile_bucket` for every bucket. Returns {"compiled":
        [...], "hits": 0, "misses": 0, "unclassified": n}."""
        report = {"compiled": [], "hits": 0, "misses": 0,
                  "unclassified": 0}
        for b in buckets:
            report["compiled"].append(self.compile_bucket(b, pages))
            report["unclassified"] += 1
        return report

    def __call__(self, bucket: Tuple[int, int], pages, packed,
                 sampling=None):
        """Dispatch one bucket. `packed`: one int32 tensor holding the
        tokens, block tables, context lengths and query lengths in turn
        (any device). Returns (next_tokens, last_logits, pages); in graph
        mode next_tokens and last_logits are the graph's outputs, which
        the bucket's next replay rewrites."""
        B, T = int(bucket[0]), int(bucket[1])
        b = self._bucket(B, T, pages)
        b.inputs.copy_(packed)
        if b.graph is None:
            if not self._capture or b.eager_runs == 0:
                next_tok, logits = self._run_eager(b, pages)
                return self._select(next_tok, logits, sampling), logits, \
                    pages
            self._capture_bucket(b, pages)
        next_tok, logits = b.graph.replay()
        return self._select(next_tok, logits, sampling), logits, pages

    @property
    def compiled_buckets(self):
        """The buckets that have run (captured or eager)."""
        return sorted(self._buckets)

    def bucket_info(self) -> dict:
        """Per bucket: mode, capture ms, pool bytes and replays."""
        out = {}
        for key, b in sorted(self._buckets.items()):
            g = b.graph
            out[key] = {"mode": "graph" if g is not None else "eager",
                        "capture_ms": None if g is None else g.capture_ms,
                        "pool_bytes": None if g is None else g.pool_bytes,
                        "replays": 0 if g is None else g.replays,
                        "eager_runs": b.eager_runs}
        return out

    def release(self):
        """Drop every bucket's graph and buffer, and the shared pool."""
        for b in self._buckets.values():
            if b.graph is not None:
                b.graph.release()
        self._buckets.clear()
        self._pool = self._pages = None

    # -- helpers -----------------------------------------------------------
    def _bucket(self, B, T, pages) -> _Bucket:
        # the graphs write the page tensors they were captured over: new
        # page tensors mean new captures
        if self._pages is not None and pages[0][0] is not self._pages:
            self.release()
        self._pages = pages[0][0]
        b = self._buckets.get((B, T))
        if b is None:
            b = self._buckets[(B, T)] = _Bucket(B, T, self._pages_per_seq,
                                                self._device)
        return b

    def _run_eager(self, b, pages):
        b.eager_runs += 1
        next_tok, logits, _ = self._step(*b.views[:1], pages, *b.views[1:])
        return next_tok, logits

    def _capture_bucket(self, b, pages):
        if self._pool is None and self._runner is None:
            self._pool = graphs.shared_pool()
        g = graphs.Graph(self._device, pool=self._pool, runner=self._runner)

        def body():
            next_tok, logits, _ = self._step(*b.views[:1], pages,
                                             *b.views[1:])
            return next_tok, logits

        g.capture(body)
        b.graph = g

    @staticmethod
    def _select(next_tok, logits, sampling):
        """Greedy tokens as the step gave them, or the sampled rows drawn
        from the step's last logits."""
        if sampling is None:
            return next_tok
        return sample_tokens(logits, *sampling)
