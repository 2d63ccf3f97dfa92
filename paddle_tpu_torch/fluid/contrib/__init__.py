"""fluid.contrib (counterpart: `paddle_tpu/fluid/contrib/`): only
`mixed_precision` and `slim.quantization` are ported."""
from . import mixed_precision  # noqa: F401
from . import slim  # noqa: F401
