"""Device identity ("Place") and device resolution for the port
(counterpart: `paddle_tpu/core/place.py`).

The port runs on the card unless the caller asks for the CPU: no entry
point falls back to the CPU on its own. A Place maps onto a torch device
through `resolve_device`; `CUDAPlace(i)` is `cuda:i` and raises when no
card is present. The reference's `TPUPlace` is not offered."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda:0``; a CUDA device that is not present raises.
    Pass ``"cpu"`` explicitly to run on the CPU (the tests do)."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device by default and none "
                "is available; ask for the CPU explicitly to run there "
                "(device='cpu', or fluid.CPUPlace() for an Executor)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        # fp32 matmuls run in full fp32, never TF32 (tolerances assume it)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


class Place:
    """Base device identity; `torch_device()` resolves it."""

    _kind = "undefined"

    def __init__(self, device_id: int = 0):
        self._device_id = int(device_id)

    def get_device_id(self) -> int:
        return self._device_id

    def __eq__(self, other):
        return (
            isinstance(other, Place)
            and self._kind == other._kind
            and self._device_id == other._device_id
        )

    def __hash__(self):
        return hash((self._kind, self._device_id))

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, self._device_id)

    def torch_device(self) -> torch.device:
        """The torch device this place denotes (raises for a CUDA place
        without a card)."""
        if self._kind == "cpu":
            return resolve_device("cpu")
        return resolve_device(torch.device("cuda", self._device_id))

    def is_cpu_place(self):
        return self._kind == "cpu"

    def is_gpu_place(self):
        return self._kind == "cuda"


class CPUPlace(Place):
    _kind = "cpu"

    def __init__(self):
        super().__init__(0)


class CUDAPlace(Place):
    """GPU `device_id` (`cuda:<device_id>`)."""

    _kind = "cuda"


def _current_expected_place():
    """Default place: `CUDAPlace(0)`, whether or not a card is present
    (the reference falls back to the CPU; the port does not)."""
    return CUDAPlace(0)
