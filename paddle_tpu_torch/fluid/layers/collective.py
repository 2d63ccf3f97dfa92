"""Collective op wrappers used by the fleet transpiler (counterpart:
`paddle_tpu/fluid/layers/collective.py`; reference:
`python/paddle/fluid/layers/collective.py:64-172`). The ops run over the
ring's process group (`paddle_tpu_torch/ops/collective_ops.py`)."""
from __future__ import annotations

from ..layer_helper import apply_op


def _c_allreduce(x, out=None, reduce_type="sum", ring_id=0,
                 use_calc_stream=False):
    op_type = "c_allreduce_" + reduce_type
    return apply_op(op_type, op_type, {"X": [x]},
                    {"ring_id": ring_id, "use_calc_stream": use_calc_stream},
                    ["Out"], out_dtype=x.dtype)[0]


def _c_broadcast(x, root=0, ring_id=0, use_calc_stream=False):
    return apply_op("c_broadcast", "c_broadcast", {"X": [x]},
                    {"root": root, "ring_id": ring_id,
                     "use_calc_stream": use_calc_stream},
                    ["Out"], out_dtype=x.dtype)[0]


def _c_allgather(x, nranks, ring_id=0, use_calc_stream=False):
    return apply_op("c_allgather", "c_allgather", {"X": [x]},
                    {"nranks": nranks, "ring_id": ring_id,
                     "use_calc_stream": use_calc_stream},
                    ["Out"], out_dtype=x.dtype)[0]


def _c_reducescatter(x, nranks, ring_id=0, use_calc_stream=False):
    return apply_op("c_reducescatter", "c_reducescatter", {"X": [x]},
                    {"nranks": nranks, "ring_id": ring_id,
                     "use_calc_stream": use_calc_stream},
                    ["Out"], out_dtype=x.dtype)[0]


def _c_sync_calc_stream(x):
    return apply_op("c_sync_calc_stream", "c_sync_calc_stream", {"X": [x]},
                    {}, ["Out"], out_dtype=x.dtype)[0]


def _c_sync_comm_stream(x, ring_id=0):
    return apply_op("c_sync_comm_stream", "c_sync_comm_stream", {"X": [x]},
                    {"ring_id": ring_id}, ["Out"], out_dtype=x.dtype)[0]
