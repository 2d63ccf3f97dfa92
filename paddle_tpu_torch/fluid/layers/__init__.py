"""fluid.layers — op wrapper namespace (counterpart:
`paddle_tpu/fluid/layers/`): the slice's layers only."""
from . import nn, tensor, loss, control_flow  # noqa: F401
from .nn import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
