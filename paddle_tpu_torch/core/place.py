"""Device resolution for the port (counterpart: `paddle_tpu/core/place.py`).

The port runs on the card unless the caller asks for the CPU: no entry
point falls back to the CPU on its own."""
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
                "is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        # fp32 matmuls run in full fp32, never TF32 (tolerances assume it)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
