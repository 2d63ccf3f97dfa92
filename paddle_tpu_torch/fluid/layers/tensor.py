"""Tensor layers of the slice (counterpart:
`paddle_tpu/fluid/layers/tensor.py`): `data`."""
from __future__ import annotations

from .. import framework

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True, type=None):
    """Declare an input variable (reference: layers/io.py data /
    fluid.data). With append_batch_size, -1 is prepended."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = framework.default_main_program().current_block()
    return block.create_var(
        name=name, shape=shape, dtype=dtype, is_data=True,
        stop_gradient=stop_gradient, persistable=False,
        lod_level=lod_level)
