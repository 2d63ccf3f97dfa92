"""paddle_tpu_torch — the PyTorch/CUDA port of `paddle_tpu`, for NVIDIA
Hopper (H100).

Module paths mirror `paddle_tpu/` so each module names its counterpart.
The port imports `torch` and numpy only: never `jax`, never `paddle_tpu`.
Ported so far: the serving runtime (`paddle_tpu_torch.serving`) with its
hand-written ragged paged attention kernel (`csrc/`)."""
__version__ = "0.1.0"

__all__ = ["serving"]


def __getattr__(name):
    if name == "serving":
        import importlib

        return importlib.import_module(".serving", __name__)
    raise AttributeError(name)
