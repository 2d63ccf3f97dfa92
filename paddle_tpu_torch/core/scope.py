"""Scope: hierarchical name -> value symbol table (counterpart:
`paddle_tpu/core/scope.py`).

Values are torch tensors on the executor's device: parameters, optimizer
state and the other persistables. `load_numpy_state` and
`dump_numpy_state` carry them across as numpy arrays, e.g. from the JAX
package's scope after its startup program.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from .place import resolve_device
from .types import to_torch_dtype


class Scope:
    _uid_counter = 0

    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, object] = {}
        self._parent = parent
        self._kids = []
        Scope._uid_counter += 1
        self._uid = Scope._uid_counter  # never-reused cache id

    def var(self, name: str):
        """Find-or-declare (reference: Scope::Var)."""
        if name not in self._vars:
            self._vars[name] = None
        return name

    def find_var(self, name: str):
        if name in self._vars:
            return self._vars[name]
        if self._parent is not None:
            return self._parent.find_var(name)
        return None

    def has_var(self, name: str) -> bool:
        if name in self._vars:
            return True
        return self._parent.has_var(name) if self._parent else False

    def set_var(self, name: str, value):
        self._vars[name] = value

    def erase(self, name: str):
        self._vars.pop(name, None)

    def local_var_names(self):
        return list(self._vars)

    def new_scope(self) -> "Scope":
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    def drop_kids(self):
        self._kids = []


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


class _ScopeGuard:
    def __init__(self, scope):
        self._scope = scope

    def __enter__(self):
        global _global_scope
        self._old = _global_scope
        _global_scope = self._scope

    def __exit__(self, *a):
        global _global_scope
        _global_scope = self._old


def scope_guard(scope: Scope):
    return _ScopeGuard(scope)


def load_numpy_state(scope: Scope, state: Dict[str, np.ndarray],
                     device=None):
    """Set each `name -> array` of `state` in `scope` as a tensor on
    `device` (``None``: ``cuda:0``), in the dtype a var of the array's
    dtype holds on the device."""
    dev = resolve_device(device)
    for name, arr in state.items():
        arr = np.array(arr)  # a copy: the scope never aliases the caller
        scope.set_var(name, torch.as_tensor(
            arr, dtype=to_torch_dtype(arr.dtype), device=dev))


def dump_numpy_state(scope: Scope, names: Iterable[str]):
    """`{name: numpy array}` of the named scope values (copied to the
    host)."""
    out = {}
    for name in names:
        v = scope.find_var(name)
        if v is None:
            raise KeyError("var %r is absent from the scope" % name)
        out[name] = v.detach().cpu().numpy()
    return out
