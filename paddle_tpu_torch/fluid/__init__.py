"""paddle_tpu_torch.fluid — the Fluid static-graph programming model on
PyTorch (counterpart: `paddle_tpu/fluid/`).

Ported so far: Program / Block / Operator / Variable (with its
operators), the layers of the MNIST MLP, BERT, ResNet, the WMT
Transformer and the Paddle book's models (`fluid.layers`, with
`layers.Scan`, the recurrent units and losses of `nn_extra`, the
control flow `While`, `while_loop`, `cond`, `switch_case` and `case`,
the learning-rate schedules and `rnn_decode`), `append_backward`, the
eager `Executor` (with `CompiledProgram.with_data_parallel`), the
optimizers of the reference's `optimizer.py:37-718` (SGD to Dpsgd),
gradient clipping (`clip`), weight decay (`regularizer`),
`fuse_optimizer_ops`, bf16 and float16 mixed precision with loss scaling
(`contrib.mixed_precision`), `nets`, `LoDTensor` and `create_lod_tensor`,
saving and loading (`io`, in the reference's formats), numbered
checkpoints (`checkpoint`) and `Executor.train_from_dataset`. What is
not ported yet is absent.
"""
from . import framework  # noqa: F401
from .framework import (  # noqa: F401
    Program, Variable, Parameter, Operator, program_guard,
    default_main_program, default_startup_program, name_scope,
    unique_name_guard, CPUPlace, CUDAPlace,
)
from . import unique_name  # noqa: F401
from ..core.scope import Scope, global_scope, scope_guard  # noqa: F401
from ..core.lod import (  # noqa: F401
    LoDTensor, create_lod_tensor, create_random_int_lodtensor,
)
from .executor import Executor, LazyFetch  # noqa: F401
from .compiler import (  # noqa: F401
    CompiledProgram, BuildStrategy, ExecutionStrategy,
)
from .backward import append_backward  # noqa: F401
from . import layers  # noqa: F401
from . import initializer  # noqa: F401
from . import optimizer  # noqa: F401
from . import regularizer  # noqa: F401
from . import clip  # noqa: F401
from .clip import (  # noqa: F401
    GradientClipByValue, GradientClipByNorm, GradientClipByGlobalNorm,
)
from . import contrib  # noqa: F401
from .fuse_optimizer import fuse_optimizer_ops  # noqa: F401
from .param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
from .initializer import (  # noqa: F401
    Constant, Uniform, Normal, TruncatedNormal, Xavier, MSRA,
)
from . import io  # noqa: F401
from .io import (  # noqa: F401
    save_persistables, load_persistables, save_params, load_params,
    save_inference_model, load_inference_model,
)
from . import checkpoint  # noqa: F401
from . import nets  # noqa: F401
from ..utils.flags import get_flags, set_flags  # noqa: F401


def data(name, shape, dtype="float32", lod_level=0):
    """fluid.data — the batch dim is explicit (-1 for any batch)."""
    return layers.tensor.data(name, shape, dtype=dtype,
                              append_batch_size=False)
