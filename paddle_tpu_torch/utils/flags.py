"""Flags of the port (counterpart: `paddle_tpu/utils/flags.py`).

Only the flags the ported slices read: the ``FLAGS_tpu_serving_*``
surface of serving, the executor's, the attention gate, CUDA-graph
capture (``FLAGS_cuda_graphs``, the port's own), the sharded weight
update with its gradient buckets, the hybrid (dcn, ici) data-parallel
world, the device prefetcher's depth, cuDNN's determinism and the AMP
level and dtype overrides. Names and
defaults are the JAX package's, so one environment configures both.
Flags ingest ``FLAGS_*`` environment variables at import."""
from __future__ import annotations

import os
from typing import Dict

_FLAGS: Dict[str, object] = {
    # Executor.run: after each run, raise if a fetch or an updated
    # persistable holds Inf or NaN (one host copy of each)
    "FLAGS_check_nan_inf": False,
    # Paddle's meaning on the card: cuDNN runs deterministic algorithms
    # and stops timing them (cudnn.benchmark off), so two runs of a
    # program, or two ranks, pick the same convolution algorithms
    # (`core/place.py resolve_device`); off, cuDNN keeps the fastest
    "FLAGS_cudnn_deterministic": False,
    # Executor: compiled blocks kept per executor (LRU)
    "FLAGS_tpu_compile_cache_size": 128,
    # Executor and serving: capture each block and serving bucket as a
    # CUDA graph on the card (its second run) and replay it; False runs
    # every step eagerly, op by op (the counterpart of jax.disable_jit)
    "FLAGS_cuda_graphs": True,
    # data parallelism: the sharded weight update (ZeRO-1,
    # parallel/sharded_update.py): gradients reduce-scattered, each rank
    # updating its flat 1/N shard of every parameter and keeping its
    # shard of the optimizer moments and AMP masters across steps, the
    # parameters all-gathered after; off (or a program the planner
    # declines) replicates the update on every rank
    "FLAGS_tpu_sharded_weight_update": True,
    # gradient buckets of the sharded update: optimizer-bound gradients
    # grouped in backward order into buckets of at most this many MiB,
    # one reduce-scatter (and one all-gather of the updated parameters)
    # a bucket; 0 = one collective a variable
    "FLAGS_tpu_comm_bucket_mb": 25.0,
    # data parallelism over pods: > 1 factors the world into a (dcn,
    # ici) mesh of this many pods of contiguous ranks
    # (`parallel/env.py create_hybrid_mesh`): gradients are summed
    # within the pod, then across pods, and the sharded update keeps
    # its shards within the pod. 0 reads PADDLE_NUM_PODS (the launcher's
    # --num_pods), else the world is flat; a count that does not divide
    # the world warns and runs flat
    "FLAGS_tpu_dcn_replicas": 0,
    # the reference compiles this many elastic world sizes ahead after a
    # block's first step; the elastic restart is not ported (ROADMAP
    # Queue 1 #10): > 0 raises at a block's first compile
    "FLAGS_tpu_warmup_elastic_variants": 0,
    # reader.prefetch_to_device: batches in flight ahead of the consumer
    "FLAGS_tpu_prefetch_depth": 2,
    # mixed_precision.decorate()'d programs: "" follows decorate's
    # amp_level; "O0" minimizes as if undecorated, "O1" applies the
    # white/black-list cast policy only, "O2" adds 16-bit live params
    # over fp32 master weights
    "FLAGS_tpu_amp_level": "",
    # mixed_precision.decorate()'d programs: "" follows decorate's
    # amp_dtype, else "bfloat16" or "float16" ("float8_e4m3", the fp8
    # tier, raises: ROADMAP Queue 1 #10)
    "FLAGS_tpu_amp_dtype": "",
    # scaled_dot_product_attention takes the flash kernels on the card at
    # or above this key length (the reference's value; the reference
    # applies it on the TPU only)
    "FLAGS_flash_attention_min_seq": 4096,
    # tokens per KV-cache page (the allocation unit of the paged cache)
    "FLAGS_tpu_serving_page_size": 16,
    # total pages in the KV pool
    "FLAGS_tpu_serving_num_pages": 512,
    # max concurrently running requests (decode batch upper bound)
    "FLAGS_tpu_serving_max_seqs": 8,
    # decode-step batch buckets; the minimum is clamped to >= 2 because a
    # batch-1 matmul (gemv) rounds differently from the same row inside a
    # larger batch, and batched decoding must equal sequential decoding
    "FLAGS_tpu_serving_decode_buckets": "2,4,8",
    # prefill token buckets; longer prompts prefill in chunks
    "FLAGS_tpu_serving_prefill_buckets": "16,64",
    # ragged paged attention: "auto" = the CUDA kernel for tensors on the
    # card, the plain PyTorch version for tensors on the CPU;
    # "reference" forces the plain version
    "FLAGS_tpu_serving_attention_impl": "auto",
    # submit() backpressure: max queued requests; 0 = unbounded
    "FLAGS_tpu_serving_max_queue": 0,
    # KV page dtype: "float32", "bfloat16", "float16" or "int8"
    "FLAGS_tpu_serving_kv_dtype": "float32",
    # int8 weight quantization at Engine construction (not ported yet)
    "FLAGS_tpu_serving_quantize_weights": False,
    # prefix caching with copy-on-write boundary pages
    "FLAGS_tpu_serving_prefix_cache": True,
    # priority aging: one class per this many admission rounds waited
    "FLAGS_tpu_serving_aging_steps": 32,
    # parked prefix-cache tier budget: pages, or "64mb"-style bytes
    "FLAGS_tpu_serving_cached_pages": 0,
}

#: numeric flags that also accept a symbolic string value from the env
_SYMBOLIC_VALUE_FLAGS = frozenset({"FLAGS_tpu_serving_cached_pages"})


def _ingest_env():
    for k in list(_FLAGS):
        if k in os.environ:
            v = os.environ[k]
            cur = _FLAGS[k]
            if isinstance(cur, bool):
                _FLAGS[k] = v.lower() in ("1", "true", "yes")
            elif isinstance(cur, (int, float)):
                try:
                    _FLAGS[k] = (int(v) if isinstance(cur, int)
                                 else float(v))
                except ValueError:
                    if k in _SYMBOLIC_VALUE_FLAGS:
                        _FLAGS[k] = v
                    else:
                        raise
            else:
                _FLAGS[k] = v


_ingest_env()


def set_flags(flags_dict):
    _FLAGS.update(flags_dict)


def get_flags(flags):
    if isinstance(flags, str):
        flags = [flags]
    return {f: _FLAGS.get(f) for f in flags}


def get_flag(name, default=None):
    return _FLAGS.get(name, default)
