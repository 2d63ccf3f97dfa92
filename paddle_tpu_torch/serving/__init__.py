"""Inference serving runtime on PyTorch/CUDA: continuous batching over a
paged KV cache with a hand-written ragged paged attention kernel
(counterpart: `paddle_tpu/serving/`).

    from paddle_tpu_torch import serving

    engine = serving.Engine(serving.TinyDecoderLM(), config=
                            serving.EngineConfig.from_flags())  # cuda:0
    engine.warmup()                      # every bucket run once
    req = engine.submit([1, 2, 3], max_new_tokens=16)
    thread_or_loop: engine.step()        # continuous batching
    for tok in req.stream(): ...

Attention runs through
`paddle_tpu_torch.ops.kernels.ragged_paged_attention`: the CUDA kernel
for tensors on the card, the plain PyTorch version on the CPU.
"""
from .convert import load_jax_params  # noqa: F401
from .engine import Engine, EngineConfig  # noqa: F401
from .kv_cache import KVCacheConfig, PagedKVCache  # noqa: F401
from .model import (TinyDecoderLM, TinyLMConfig,  # noqa: F401
                    dense_decode_reference, sample_tokens)
from .scheduler import (BucketPlan, Request,  # noqa: F401
                        RequestState, Scheduler)
from .trace import run_trace, synthetic_trace  # noqa: F401

__all__ = [
    "Engine", "EngineConfig", "KVCacheConfig", "PagedKVCache",
    "TinyDecoderLM", "TinyLMConfig", "dense_decode_reference",
    "sample_tokens", "BucketPlan", "Request", "RequestState",
    "Scheduler", "load_jax_params",
    "run_trace", "synthetic_trace",
]
