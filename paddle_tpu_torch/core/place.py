"""Device identity ("Place") and device resolution for the port
(counterpart: `paddle_tpu/core/place.py`).

The port runs on the card unless the caller asks for the CPU: no entry
point falls back to the CPU on its own. A Place maps onto a torch device
through `resolve_device`; `CUDAPlace(i)` is `cuda:i` and raises when no
card is present. The reference's `TPUPlace` is not offered. Under data
parallelism (one process per rank) the default card is the rank's own
(`rank_device_index`)."""
from __future__ import annotations

import os

import torch


def rank_device_index() -> int:
    """The card of this process: ``FLAGS_selected_gpus`` when the launcher
    set it, else the trainer id modulo the card count in a world of
    several trainers, else 0."""
    sel = os.environ.get("FLAGS_selected_gpus", "")
    if sel:
        return int(sel.split(",")[0])
    if int(os.environ.get("PADDLE_TRAINERS_NUM", "1")) > 1:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0")) % max(
            torch.cuda.device_count(), 1)
    return 0


def resolve_device(device=None) -> torch.device:
    """``None`` means this process's card (``cuda:0`` outside a
    data-parallel world, see `rank_device_index`); a CUDA device that is
    not present raises. Pass ``"cpu"`` explicitly to run on the CPU (the
    tests do)."""
    dev = torch.device("cuda", rank_device_index()) if device is None \
        else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device by default and none "
                "is available; ask for the CPU explicitly to run there "
                "(device='cpu', or fluid.CPUPlace() for an Executor)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        # fp32 matmuls and convolutions run in full fp32, never TF32
        # (tolerances assume it)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # cuDNN times its algorithms for each new convolution shape and
        # keeps the fastest, as XLA autotunes the reference's convolutions;
        # a prepared fluid block runs fixed shapes step after step. The
        # timed choice can differ from run to run and from rank to rank:
        # FLAGS_cudnn_deterministic (Paddle's meaning) turns the timing
        # off and asks cuDNN for deterministic algorithms
        from ..utils.flags import get_flag

        det = bool(get_flag("FLAGS_cudnn_deterministic", False))
        torch.backends.cudnn.benchmark = not det
        if det:
            torch.backends.cudnn.deterministic = True
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
    """Default place: the `CUDAPlace` of this process's card, whether or
    not a card is present (the reference falls back to the CPU; the port
    does not)."""
    return CUDAPlace(rank_device_index())
