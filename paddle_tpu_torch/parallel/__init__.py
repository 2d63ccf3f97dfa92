"""Parallel training of the port (counterpart: `paddle_tpu/parallel/`).

Ported so far: the rings of data-parallel fluid programs over
`torch.distributed` process groups and the `Mesh` of groups over named
axes (`env`); the logical-axis rules (`axis_rules`); the trainer's
collectives with their transposes for autograd (`mesh_collectives`);
Ulysses sequence parallelism (`ulysses`); and the transformer trainer
over a dp x pp x tp mesh (`transformer`)."""
from . import env  # noqa: F401
from . import axis_rules  # noqa: F401
from . import mesh_collectives  # noqa: F401
from . import ulysses  # noqa: F401
from . import transformer  # noqa: F401
from .env import Mesh  # noqa: F401
