"""Carry weights from the JAX serving model into the port.

`load_jax_params(model, params)` takes the params dict that the JAX
`TinyDecoderLM.init_params` returns, each leaf given as a numpy array
(or anything `numpy.asarray` takes), and copies it into the module's
parameters of the same name. Shapes must match exactly."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_jax_params"]


def _flatten(params) -> dict:
    flat = {k: params[k] for k in params if k != "layers"}
    for i, layer in enumerate(params.get("layers", ())):
        for k, v in layer.items():
            flat["layers.%d.%s" % (i, k)] = v
    return flat


@torch.no_grad()
def load_jax_params(model, params):
    """Fill `model` (a `TinyDecoderLM`) in place from a JAX-layout params
    dict; returns the model. Raises on a missing, extra or misshapen
    leaf."""
    flat = _flatten(params)
    own = dict(model.named_parameters())
    if set(flat) != set(own):
        raise ValueError("params keys differ from the model's: missing %s, "
                         "extra %s" % (sorted(set(own) - set(flat)),
                                       sorted(set(flat) - set(own))))
    for name, p in own.items():
        arr = np.array(flat[name], dtype=np.float32)  # a writable copy
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError("%s: shape %s, the model has %s"
                             % (name, arr.shape, tuple(p.shape)))
        p.copy_(torch.from_numpy(arr))
    return model
