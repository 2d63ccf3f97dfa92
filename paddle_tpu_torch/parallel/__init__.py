"""Parallel training of the port (counterpart: `paddle_tpu/parallel/`).

Ported so far: the transformer trainer (`transformer`) on one device."""
from . import transformer  # noqa: F401
