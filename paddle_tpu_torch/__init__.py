"""paddle_tpu_torch — the PyTorch/CUDA port of `paddle_tpu`, for NVIDIA
Hopper (H100).

Module paths mirror `paddle_tpu/` so each module names its counterpart.
The port imports `torch` and numpy only: never `jax`, never `paddle_tpu`.
Ported so far: the serving runtime (`paddle_tpu_torch.serving`) with its
hand-written ragged paged attention kernel, the transformer trainer
(`paddle_tpu_torch.parallel.transformer`) with its hand-written flash
attention forward and backward kernels (`csrc/`), and the core of the
fluid static graph (`paddle_tpu_torch.fluid`: Program, op registry,
backward, eager Executor, SGD and Adam, Scan, bf16 AMP) with BERT
pretraining on it (`paddle_tpu_torch.models.bert`)."""
__version__ = "0.1.0"

__all__ = ["serving", "parallel", "fluid", "models"]


def __getattr__(name):
    if name in __all__:
        import importlib

        return importlib.import_module("." + name, __name__)
    raise AttributeError(name)
