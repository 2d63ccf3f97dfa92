"""Executor: feed -> block function -> fetch (counterpart:
`paddle_tpu/fluid/executor.py`, its core: no profiler phases,
observability, warmup, elastic, parameter-server or report surfaces).

`run` prepares the block once per (program version, feed shapes and
dtypes, fetch names, scope) and keeps it in an LRU cache (reference
analogue: the prepared-ctx program cache, `executor.cc:184`). Feeds are
copied to the executor's device, the block's ops run there eagerly, and
fetches come back as numpy arrays. Persistable state stays in the Scope
as tensors on the device between runs.
"""
from __future__ import annotations

import collections
from typing import Dict

import numpy as np
import torch

from . import framework, lowering
from ..core.scope import global_scope
from ..core.types import from_numpy, to_numpy, to_numpy_dtype, \
    to_torch_dtype
from ..utils.flags import get_flag

_Prepared = collections.namedtuple("_Prepared", ["state_in", "fn"])


class Executor:
    def __init__(self, place=None):
        """`place`: ``None`` or ``CUDAPlace(i)`` runs on the card (and
        raises when there is none); ``CPUPlace()`` on the CPU."""
        self.place = place if place is not None else \
            framework._current_expected_place()
        self.device = self.place.torch_device()
        # LRU of prepared blocks, bounded by FLAGS_tpu_compile_cache_size
        self._cache = collections.OrderedDict()

    # -- public API --------------------------------------------------------
    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            feed_var_name="feed", fetch_var_name="fetch",
            return_numpy=True, use_program_cache=True):
        """One step: run `program`'s global block with `feed`, update the
        scope's persistables, and return the `fetch_list` values (numpy
        arrays, or detached tensors on the device with
        ``return_numpy=False``)."""
        return self._run_impl(program, feed, fetch_list, scope,
                              return_numpy, use_program_cache)

    def _run_impl(self, program, feed, fetch_list, scope, return_numpy,
                  use_program_cache):
        program = program or framework.default_main_program()
        scope = scope or global_scope()
        fetch_names = [
            f.name if isinstance(f, framework.Variable) else str(f)
            for f in (fetch_list or [])]
        block = program.global_block()
        feeds = self._prepare_feed(block, feed or {})

        key = self._cache_key(program, feeds, fetch_names, scope)
        entry = self._cache.get(key) if use_program_cache else None
        if entry is not None:
            self._cache.move_to_end(key)
        else:
            entry = self._prepare(program, block, feeds, fetch_names)
            if use_program_cache:
                self._cache[key] = entry
                limit = int(get_flag("FLAGS_tpu_compile_cache_size", 128)
                            or 128)
                while len(self._cache) > limit:
                    self._cache.popitem(last=False)

        states = self._gather_states(entry.state_in, scope)
        seed = framework._global_seed_and_bump(program)
        fetches, new_states = entry.fn(feeds, states, seed % (2**31))
        for n, v in new_states.items():
            scope.set_var(n, v)
        if get_flag("FLAGS_check_nan_inf"):
            self._check_nan_inf(fetch_names, fetches, new_states)
        if return_numpy:
            return [self._fetch_to_numpy(v) for v in fetches]
        return fetches

    def close(self):
        self._cache.clear()

    # -- helpers -----------------------------------------------------------
    def _prepare(self, program, block, feeds, fetch_names):
        state_in, state_out = lowering.analyze_block(
            block, list(feeds), fetch_names)
        fn = lowering.build_block_fn(program, block, list(feeds),
                                     fetch_names, state_in, state_out,
                                     self.device)
        return _Prepared(state_in, fn)

    def _gather_states(self, names, scope):
        """The scope's tensors for `names`; each must be present and on
        this executor's device (nothing is copied over quietly)."""
        states, missing = {}, []
        for n in names:
            v = scope.find_var(n)
            if v is None:
                missing.append(n)
                continue
            if not isinstance(v, torch.Tensor) or v.device != self.device:
                raise RuntimeError(
                    "var %r in the scope is %s, not a tensor on this "
                    "executor's device %s" % (
                        n, v.device if isinstance(v, torch.Tensor)
                        else type(v).__name__, self.device))
            states[n] = v
        if missing:
            raise RuntimeError(
                "variables %s are read by the program but absent from the "
                "scope — run the startup program (or feed them)"
                % (missing,))
        return states

    def _prepare_feed(self, block, feed) -> Dict[str, torch.Tensor]:
        """Feeds as tensors on this executor's device, in the dtype the
        declared var holds there. A tensor fed from another device
        raises."""
        out = {}
        for name, value in feed.items():
            v = block._find_var_recursive(name)
            if isinstance(value, torch.Tensor):
                if value.device != self.device:
                    raise RuntimeError(
                        "feed %r is a tensor on %s, not on this executor's "
                        "device %s" % (name, value.device, self.device))
                if v is not None:
                    value = value.to(to_torch_dtype(v.dtype))
                out[name] = value
                continue
            arr = np.asarray(value)
            if v is not None and arr.dtype != to_numpy_dtype(v.dtype):
                arr = arr.astype(to_numpy_dtype(v.dtype))
            out[name] = from_numpy(arr, self.device)
        return out

    @staticmethod
    def _fetch_to_numpy(v):
        return to_numpy(v)

    @staticmethod
    def _check_nan_inf(fetch_names, fetches, new_states):
        """FLAGS_check_nan_inf (reference: operator.cc:1020
        CheckOpHasNanOrInf): every fetch and updated state var, the
        error names the var."""
        bad = [n for n, v in list(zip(fetch_names, fetches))
               + list(new_states.items())
               if v.is_floating_point() and not bool(torch.isfinite(v).all())]
        if bad:
            raise RuntimeError(
                "Operator output contains Inf/Nan (FLAGS_check_nan_inf): "
                "%s" % bad)

    def _cache_key(self, program, feeds, fetch_names, scope):
        feed_key = tuple(sorted(
            (n, tuple(t.shape), str(t.dtype)) for n, t in feeds.items()))
        # never-reused uids (not id()) so GC'd programs/scopes cannot
        # alias a stale prepared block
        return (program._uid, program._version, feed_key,
                tuple(fetch_names), getattr(scope, "_uid", 0))
