"""bf16 mixed precision for the static graph (counterpart:
`paddle_tpu/fluid/contrib/mixed_precision/`)."""
from .decorator import decorate, OptimizerWithMixedPrecision  # noqa: F401
from .fp16_lists import AutoMixedPrecisionLists  # noqa: F401
from .fp16_utils import master_name, rewrite_master_weights  # noqa: F401
