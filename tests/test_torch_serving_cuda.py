"""The port's serving engine on the card: greedy token streams of a
continuously batched trace equal each request decoded alone, and the
attention kernel carried every layer of every dispatch. Every test here
needs an NVIDIA GPU (marker ``cuda``) and skips without one. The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_serving_cuda.py
"""
import pytest
import torch

from paddle_tpu_torch import serving
from paddle_tpu_torch.ops.kernels import ragged_paged_attention

pytestmark = pytest.mark.cuda

SMALL = dict(vocab=48, embed=24, layers=2, heads=4, kv_heads=2, head_dim=8,
             ffn=48, max_seq=48)
BERT_BASE = dict(vocab=30522, embed=768, layers=12, heads=12, kv_heads=12,
                 head_dim=64, ffn=3072, max_seq=512)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _streams(model, trace, pool, kv_dtype, batched):
    def engine():
        return serving.Engine(model, config=serving.EngineConfig(
            kv_dtype=kv_dtype, **pool), seed=0)

    if batched:
        eng = engine()
        reqs = [eng.submit(tr.prompt, max_new_tokens=tr.max_new_tokens)
                for tr in trace]
        eng.run_until_idle()
        return [list(r.output_tokens) for r in reqs]
    out = []
    for tr in trace:
        eng = engine()
        r = eng.submit(tr.prompt, max_new_tokens=tr.max_new_tokens)
        eng.run_until_idle()
        out.append(list(r.output_tokens))
    return out


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_small_batched_equals_sequential_on_card(dev, kv_dtype):
    model = serving.TinyDecoderLM(serving.TinyLMConfig(**SMALL))
    trace = serving.synthetic_trace(
        n_requests=7, n_tenants=2, seed=5, vocab=48, prompt_range=(3, 14),
        output_range=(3, 8), system_prompt_range=(4, 9))
    pool = dict(num_pages=96, page_size=4, max_seqs=4)
    before = ragged_paged_attention.launches
    batched = _streams(model, trace, pool, kv_dtype, True)
    assert ragged_paged_attention.launches > before
    assert batched == _streams(model, trace, pool, kv_dtype, False)


def test_bert_base_batched_equals_sequential_on_card(dev):
    model = serving.TinyDecoderLM(serving.TinyLMConfig(**BERT_BASE))
    trace = serving.synthetic_trace(
        n_requests=8, n_tenants=2, vocab=30522, prompt_range=(32, 256),
        output_range=(16, 32), system_prompt_range=(16, 48))
    pool = dict(num_pages=512, page_size=16, max_seqs=8)
    batched = _streams(model, trace, pool, "bfloat16", True)
    assert batched == _streams(model, trace, pool, "bfloat16", False)
