"""Fleet distributed metrics: metric helpers summed over the trainers
(counterpart: `paddle_tpu/fleet/metrics.py`; reference:
`fluid/incubate/fleet/utils/fleet_util.py:186` get_global_auc and `:1268`
get_global_metrics).

Each helper takes a numpy array, a Variable, or a var name (resolved in
`scope`), sums it over the trainers through `util` (a
`HostCollectiveGroup`; by default the env's group, or the local value on
a single process), and returns the global value.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.types import to_numpy

__all__ = ["sum", "max", "min", "auc", "mae", "rmse", "mse", "acc"]

_builtin_sum, _builtin_max, _builtin_min = sum, max, min


def _group(util):
    if util is not None:
        return util
    from ..distributed.host_collectives import group_from_env

    return group_from_env()


def _value(input_, scope) -> np.ndarray:
    if isinstance(input_, np.ndarray):
        return input_
    name = getattr(input_, "name", input_)
    if scope is None:
        from ..core.scope import global_scope

        scope = global_scope()
    v = scope.find_var(str(name))
    if v is None:
        raise ValueError("fleet.metrics: var %r absent from the scope"
                         % name)
    return to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)


def _all_reduce(arr, util, op="sum"):
    g = _group(util)
    if g is None:
        return np.asarray(arr, np.float64)
    return np.asarray(g.all_reduce(np.asarray(arr, np.float64), op=op))


def sum(input_, scope=None, util=None):  # noqa: A001 - reference name
    """Global sum (reference: fleet.metrics.sum)."""
    return _all_reduce(_value(input_, scope), util, "sum")


def max(input_, scope=None, util=None):  # noqa: A001
    return _all_reduce(_value(input_, scope), util, "max")


def min(input_, scope=None, util=None):  # noqa: A001
    return _all_reduce(_value(input_, scope), util, "min")


def auc(stat_pos, stat_neg, scope=None, util=None):
    """Global AUC from the auc op's pos/neg threshold buckets
    (reference: fleet_util.py:186 get_global_auc — trapezoid area over
    buckets walked from the highest threshold down)."""
    pos = _all_reduce(_value(stat_pos, scope).reshape(-1), util)
    neg = _all_reduce(_value(stat_neg, scope).reshape(-1), util)
    num_bucket = pos.shape[0]
    area = 0.0
    p = n = 0.0
    total = 0.0
    for i in range(num_bucket):
        index = num_bucket - 1 - i
        new_p = p + pos[index]
        new_n = n + neg[index]
        total += pos[index] + neg[index]
        area += (new_n - n) * (p + new_p) / 2.0
        p, n = new_p, new_n
    if p * n == 0 or total == 0:
        return 0.5
    return float(area / (p * n))


def _reduced_scalar(x, scope, util):
    return float(np.asarray(_all_reduce(
        _value(x, scope).reshape(-1)[:1], util)).reshape(-1)[0])


def mae(abserr, total_ins_num, scope=None, util=None):
    """Global mean absolute error (reference: get_global_metrics mae =
    sum(abserr) / sum(total_ins_num))."""
    err = _reduced_scalar(abserr, scope, util)
    n = _reduced_scalar(total_ins_num, scope, util)
    return err / _builtin_max(n, 1.0)


def mse(sqrerr, total_ins_num, scope=None, util=None):
    err = _reduced_scalar(sqrerr, scope, util)
    n = _reduced_scalar(total_ins_num, scope, util)
    return err / _builtin_max(n, 1.0)


def rmse(sqrerr, total_ins_num, scope=None, util=None):
    return math.sqrt(mse(sqrerr, total_ins_num, scope, util))


def acc(correct, total, scope=None, util=None):
    """Global accuracy = sum(correct) / sum(total)."""
    c = _reduced_scalar(correct, scope, util)
    n = _reduced_scalar(total, scope, util)
    return c / _builtin_max(n, 1.0)
