"""fluid.contrib (counterpart: `paddle_tpu/fluid/contrib/`): only
`mixed_precision` is ported."""
from . import mixed_precision  # noqa: F401
