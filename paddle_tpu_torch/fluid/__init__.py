"""paddle_tpu_torch.fluid — the Fluid static-graph programming model on
PyTorch (counterpart: `paddle_tpu/fluid/`).

Ported so far: Program / Block / Operator / Variable, the layers of the
MNIST MLP, BERT and ResNet (`fluid.layers`, with `layers.Scan`),
`append_backward`, the eager `Executor`, the SGD, Momentum and Adam
optimizers, weight decay (`regularizer`), `fuse_optimizer_ops`, and bf16
mixed precision (`contrib.mixed_precision`). What is not ported yet is
absent.
"""
from . import framework  # noqa: F401
from .framework import (  # noqa: F401
    Program, Variable, Parameter, Operator, program_guard,
    default_main_program, default_startup_program, name_scope,
    unique_name_guard, CPUPlace, CUDAPlace,
)
from . import unique_name  # noqa: F401
from ..core.scope import Scope, global_scope, scope_guard  # noqa: F401
from .executor import Executor  # noqa: F401
from .backward import append_backward  # noqa: F401
from . import layers  # noqa: F401
from . import initializer  # noqa: F401
from . import optimizer  # noqa: F401
from . import regularizer  # noqa: F401
from . import contrib  # noqa: F401
from .fuse_optimizer import fuse_optimizer_ops  # noqa: F401
from .param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
from .initializer import (  # noqa: F401
    Constant, Uniform, Normal, TruncatedNormal, Xavier, MSRA,
)
from ..utils.flags import get_flags, set_flags  # noqa: F401


def data(name, shape, dtype="float32", lod_level=0):
    """fluid.data — the batch dim is explicit (-1 for any batch)."""
    return layers.tensor.data(name, shape, dtype=dtype,
                              append_batch_size=False)
