"""paddle_tpu_torch.core — device/dtype/scope primitives (counterpart:
`paddle_tpu/core/`)."""
from .place import Place, CPUPlace, CUDAPlace  # noqa: F401
from .scope import Scope, global_scope, scope_guard  # noqa: F401
from .types import VarDesc, normalize_dtype, to_numpy_dtype  # noqa: F401
