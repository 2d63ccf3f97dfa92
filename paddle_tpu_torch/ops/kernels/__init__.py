"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (counterpart: `paddle_tpu/ops/pallas/`). Kernels are built from
`paddle_tpu_torch/csrc/` on first launch, never at import."""
from .dropout import dropout, dropout_reference  # noqa: F401
from .flash_attention import (  # noqa: F401
    flash_attention, flash_attention_bwd_reference,
    flash_attention_fwd_reference, reference_attention)
from .ragged_paged_attention import (  # noqa: F401
    ragged_paged_attention, ragged_paged_attention_reference)
