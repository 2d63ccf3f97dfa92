"""Operators of the port (counterpart: `paddle_tpu/ops/`).

Importing this package registers every ported operator: the static
graph's op set of the fluid slice. `kernels/` holds the hand-written CUDA
kernels and their plain PyTorch versions.
"""
from .registry import (  # noqa: F401
    register_op, get_op, has_op, registered_ops, run_op, infer_outputs,
    normalize_outs,
)

from . import math_ops  # noqa: F401
from . import nn_ops  # noqa: F401
from . import tensor_ops  # noqa: F401
from . import rng_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import metric_ops  # noqa: F401
from . import fused_ops  # noqa: F401
from . import beam_search_ops  # noqa: F401
from . import collective_ops  # noqa: F401
from . import specialty_ops  # noqa: F401
from . import loss_ops  # noqa: F401
from . import linalg_ops  # noqa: F401
from . import rnn_unit_ops  # noqa: F401
from . import sequence_ops  # noqa: F401
from . import array_ops  # noqa: F401
from . import framework_ops  # noqa: F401
from . import interp_ops  # noqa: F401
from . import quant_ops  # noqa: F401
from . import detection_ops  # noqa: F401
from . import vision_extra_ops  # noqa: F401
from . import detection_extra_ops  # noqa: F401
