"""fluid.contrib.slim (counterpart: `paddle_tpu/fluid/contrib/slim/`):
model compression; only `quantization` is ported (pruning,
distillation, the searcher and NAS are not yet, ROADMAP Queue 1 #10)."""
from . import quantization  # noqa: F401
