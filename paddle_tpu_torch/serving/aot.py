"""Per-bucket dispatch of the serving step (counterpart:
`paddle_tpu/serving/aot.py`).

Every dispatch shape the scheduler can issue is a (batch, T) bucket from
`BucketPlan.all_buckets()`. The JAX package compiled one executable per
bucket through its persistent compile cache. PyTorch runs eagerly, so
here a bucket is only a shape: `warmup` runs each bucket once before
first traffic with every ``q_len = 0`` (nothing is written to the
pages), which builds the kernels and warms the libraries' handles.
There is no persistent compile cache, so every bucket reports
``status: None``. Capturing each bucket as a CUDA graph is later work.
"""
from __future__ import annotations

from typing import Set, Tuple

import torch

__all__ = ["BucketCompiler"]


class BucketCompiler:
    """Dispatches the serving step per bucket. `step` signature:
    (tokens [B, T], pages, block_tables [B, NP], context_lens [B],
    q_lens [B], sampling=None) -> (next_tokens, last_logits, pages)."""

    def __init__(self, step, pages_per_seq: int, device):
        self._step = step
        self._pages_per_seq = int(pages_per_seq)
        self._device = device
        self._warmed: Set[Tuple[int, int]] = set()

    def warmup(self, buckets, pages) -> dict:
        """Run every bucket once with all rows inactive. Returns
        {"compiled": [{"bucket", "status": None}...], "hits": 0,
        "misses": 0, "unclassified": n}."""
        report = {"compiled": [], "hits": 0, "misses": 0,
                  "unclassified": 0}
        for b in buckets:
            B, T = int(b[0]), int(b[1])
            zeros = torch.zeros((B,), dtype=torch.int32,
                                device=self._device)
            self._step(torch.zeros((B, T), dtype=torch.int32,
                                   device=self._device), pages,
                       torch.zeros((B, self._pages_per_seq),
                                   dtype=torch.int32, device=self._device),
                       zeros, zeros)
            self._warmed.add((B, T))
            report["compiled"].append({"bucket": [B, T], "status": None})
            report["unclassified"] += 1
        return report

    def __call__(self, bucket: Tuple[int, int], pages, tokens,
                 block_tables, context_lens, q_lens, sampling=None):
        """Dispatch one bucket."""
        return self._step(tokens, pages, block_tables, context_lens,
                          q_lens, sampling=sampling)

    @property
    def compiled_buckets(self):
        """The buckets `warmup` has run."""
        return sorted(self._warmed)
