"""Runs the op cases of the numpy case tables (`tests/torch_nn_cases.py`,
`tests/torch_tensor_cases.py`) through the port's registry on a device,
and holds a card's results against the CPU's. Numpy and torch only, so
the card tests (`tests/test_torch_book_cuda.py`) and `chip_smoke.py`
import it on a machine without JAX.

`run_case` gives an op's outputs, then the gradient of each slot it is
asked to differentiate under one seeded cotangent; `capture_case` gives
the same from one replay of a CUDA graph captured around both, for the
types that `capturable` admits; `compare` holds one such list against
another: dtype and shape equal,
integer and bool outputs exact, float outputs within `rtol` x (1 + the
largest finite |value|), a cell equal on both sides (an infinity
included) or NaN on both sides agreeing and NaN on one side not."""
import math

import numpy as np
import torch

from paddle_tpu_torch.core.rng import seed_tensor
from paddle_tpu_torch.core.types import to_torch_dtype
from paddle_tpu_torch.ops import registry


#: op types whose cases here give them a tensor that they read on the
#: host (a length, a range or offsets), so that a block holding them
#: runs eagerly (`fluid/lowering.py _HOST_READS`)
HOST_READS = {"bincount", "crop_tensor", "linspace", "logspace"}


def capturable(op):
    """Whether a CUDA graph can capture `op`'s cases: it reads no value
    on the host and is flagged neither `no_jit` nor `dynamic_shape`."""
    od = registry.get_op(op)
    return op not in HOST_READS and not (od.no_jit or od.dynamic_shape)


def _inputs(ins, device, diff):
    """slot -> numpy arrays as tensors on `device`, the first of each
    slot in `diff` requiring its gradient."""
    return {s: [torch.tensor(np.asarray(v).copy(), dtype=to_torch_dtype(
        np.asarray(v).dtype), device=device).requires_grad_(
            s in diff and i == 0) for i, v in enumerate(vs)]
        for s, vs in ins.items()}


def _step(op, t_ins, attrs, device, diff, seed, cts=None):
    """(the outputs sorted by slot, the gradients, the cotangents)."""
    a = dict(attrs, _device=torch.device(device))
    if seed is not None:
        a["_rng_seed"] = seed_tensor(seed, device)
    out = registry.normalize_outs(registry.get_op(op).compute(t_ins, a))
    outs = [t for s in sorted(out) for t in out[s]]
    floats = [t for t in outs if t.requires_grad]
    grads = []
    if diff and floats:
        if cts is None:
            r = np.random.RandomState(99)
            cts = [torch.tensor(r.randn(*t.shape), dtype=t.dtype,
                                device=device) for t in floats]
        grads = [torch.zeros((), device=device) if g is None else g
                 for g in torch.autograd.grad(
                     floats, [t_ins[s][0] for s in diff], cts,
                     allow_unused=True)]
    return [t.detach() for t in outs] + grads, cts


def run_case(op, ins, attrs, device, diff=(), seed=None):
    """The outputs of `op` on `ins` (slot -> numpy arrays) on `device`,
    sorted by slot, then the gradient of the first tensor of each slot
    in `diff` under a cotangent drawn from RandomState(99) (a zero
    scalar where it has none); `seed` gives a random op its seed."""
    return _step(op, _inputs(ins, device, diff), attrs, device, diff,
                 seed)[0]


def capture_case(op, ins, attrs, device, diff=(), seed=None):
    """`run_case`'s list from one replay of a CUDA graph that captured
    the op and its gradients on static inputs (warmed up eagerly on a
    side stream first). It raises where the op reads a value on the
    host or synchronizes with it."""
    t_ins = _inputs(ins, device, diff)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _, cts = _step(op, t_ins, attrs, device, diff, seed)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static, _ = _step(op, t_ins, attrs, device, diff, seed, cts)
    graph.replay()
    torch.cuda.synchronize()
    return [t.clone() for t in static]


def max_err(g, w):
    """(the largest |g - w|, a cell equal on both sides or NaN on both
    counting 0 and NaN on one side counting inf; 1 + the largest finite
    |w|)."""
    if not w.numel():
        return 0.0, 1.0
    same = (g == w) | (torch.isnan(g) & torch.isnan(w))
    diff = torch.where(same, torch.zeros((), dtype=w.dtype), (g - w).abs())
    finite = w[torch.isfinite(w)]
    return (float(torch.nan_to_num(diff, nan=math.inf).max()),
            1.0 + (float(finite.abs().max()) if finite.numel() else 0.0))


def compare(got, want, rtol):
    """(the largest absolute error, the largest error over its scale,
    the faults [(index, what)]) of the tensors `got` against `want`,
    both lists in one order; `got` may lie on another device."""
    worst_abs = worst_rel = 0.0
    bad = []
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.cpu(), w.cpu()
        if g.dtype != w.dtype or g.shape != w.shape:
            bad.append((i, "dtype/shape"))
        elif w.is_floating_point():
            err, scale = max_err(g, w)
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel,
                                                            err / scale)
            if err > rtol * scale:
                bad.append((i, err))
        elif not torch.equal(g, w):
            bad.append((i, "values"))
    if len(got) != len(want):
        bad.append((min(len(got), len(want)), "count"))
    return worst_abs, worst_rel, bad
