"""fluid.layers — op wrapper namespace (counterpart:
`paddle_tpu/fluid/layers/`): the slice's layers only."""
from . import nn, tensor, loss, control_flow  # noqa: F401
from . import learning_rate_scheduler, rnn_decode  # noqa: F401
from . import collective, nn_extra, detection  # noqa: F401
from .nn import *  # noqa: F401,F403
from .nn_extra import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from .rnn_decode import *  # noqa: F401,F403
