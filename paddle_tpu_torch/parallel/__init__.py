"""Parallel training of the port (counterpart: `paddle_tpu/parallel/`).

Ported so far: the transformer trainer (`transformer`) on one device, and
the rings of data-parallel fluid programs over `torch.distributed`
process groups (`env`)."""
from . import env  # noqa: F401
from . import transformer  # noqa: F401
