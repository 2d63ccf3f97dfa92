"""Executor: feed -> compiled block -> fetch (counterpart:
`paddle_tpu/fluid/executor.py`, its core, `warmup`, `train_from_dataset`
and the checkpoint half of `strategy.elastic`: no profiler phases,
observability, elastic restart, parameter-server or report surfaces).

`run` compiles the block once per (program version, feed shapes and
dtypes, fetch names, scope) with `lowering.compile_block` and keeps the
entry in an LRU cache of `FLAGS_tpu_compile_cache_size` entries (the
reference's `_compile_and_cache`). On the card an entry's first run is
eager, its second is captured as a CUDA graph and every later run copies
the feeds into the entry's static buffers, writes the step's seed into a
device buffer and replays the graph; the persistable state is donated:
the scope keeps the graph's static buffers, into which each replay writes
the new values. A block the capture analysis declines (host control
flow, an initializer), every block on the CPU and every block with
`FLAGS_cuda_graphs` off run eagerly, op by op; `last_entry` and
`compiled_blocks` say which and why. Fetches come back as numpy arrays,
or as tensors on the device (clones of a graph's outputs, which the next
replay rewrites). `warmup` captures shape buckets ahead of traffic on
copies of the state, or in the background runs a discarded step of each
on copies (the build of the `csrc` kernels, cuBLAS's handles and cuDNN's
algorithm choices).

A data-parallel program (`CompiledProgram.with_data_parallel`, fleet's
`transpile_collective`) runs as this process's rank of the world
(`distributed.init_parallel_env`; without a world it runs as a single
process), with the reference's feed and fetch contract (its `_compile_dp`
under `shard_map`): `run` takes the global batch and keeps this rank's
rows of axis 0 (a batch the ranks do not divide raises); a fetch of a
non-persistable var is gathered over the ranks along axis 0, a
persistable one is this rank's own value. At the program's first run in
a scope each of its persistables that the scope holds is broadcast from
rank 0 (once a scope: an evaluation clone keeps the per-rank running
statistics), and with random_seed 0 every rank takes rank 0's step
seeds, so the replicas start equal and draw the same dropout masks. The
cache key holds the world, so an entry compiled for one world never runs
in another. With more than one pod asked for (``FLAGS_tpu_dcn_replicas``,
``PADDLE_NUM_PODS``) the world is the hybrid (dcn, ici) pair
(`parallel/env.py program_ring`): the batch splits over both axes,
dcn-major (rank order), gradient sums run within the pod and then
across pods, and the sharded state is laid out within the pod.
`overlap_report` says which gradient collectives of the last run began
while the backward was still producing gradients.

A program that fleet marked elastic (``strategy.elastic``,
``program._elastic_cfg``) loads the newest checkpoint under its
``checkpoint_dir`` before its first step and saves one in the background
every ``save_steps`` steps (`fluid/checkpoint.py`).

With the sharded weight update (ZeRO-1, `parallel/sharded_update.py`,
on by default) the scope holds this rank's flat 1/N slice (N the shard
count: the world's, or the pod's on a hybrid world) of each optimizer
moment and AMP master the entry keeps sharded: the first run
lays each out from its logical value after the broadcast, and
`read_logical` gathers one back at its logical shape (every rank calls
it alike). `feed_sharding` gives `reader.prefetch_to_device` this rank's
rows, and a feed the prefetcher already cut to them is left as it is.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Dict, Optional

import numpy as np
import torch

from . import framework, lowering
from .compiler import CompiledProgram
from ..core.rng import StepSeed, seed_tensor
from ..core.scope import global_scope
from ..ops import collective_ops
from ..parallel import env as penv
from ..parallel import sharded_update as _su
from ..reader import prefetcher
from ..core.types import from_numpy, to_numpy, to_numpy_dtype, \
    to_torch_dtype
from ..utils.flags import get_flag


class Executor:
    def __init__(self, place=None, graph_runner=None):
        """`place`: ``None`` or ``CUDAPlace(i)`` runs on the card (and
        raises when there is none); ``CPUPlace()`` on the CPU.
        `graph_runner` stands in for CUDA graph capture and replay on the
        CPU (tests only, `core/graphs.py`)."""
        self.place = place if place is not None else \
            framework._current_expected_place()
        self.device = self.place.torch_device()
        self._graph_runner = graph_runner
        # LRU of compiled blocks, bounded by FLAGS_tpu_compile_cache_size
        self._cache = collections.OrderedDict()
        #: the entry the last `run` used
        self.last_entry: Optional[lowering.CompiledBlock] = None
        # (scope, world) -> names of the persistables broadcast there;
        # and the (program, version, scope, world) runs that checked
        self._dp_synced = {}
        self._dp_checked = set()

    # -- public API --------------------------------------------------------
    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            feed_var_name="feed", fetch_var_name="fetch",
            return_numpy=True, use_program_cache=True):
        """One step: run `program`'s global block with `feed`, update the
        scope's persistables, and return the `fetch_list` values (numpy
        arrays, or detached tensors on the device with
        ``return_numpy=False``). `use_program_cache=False` compiles a
        fresh entry for this run alone (so it runs eagerly)."""
        return self._run_impl(program, feed, fetch_list, scope,
                              return_numpy, use_program_cache)

    def _run_impl(self, program, feed, fetch_list, scope, return_numpy,
                  use_program_cache):
        program = self._program(program)
        scope = scope or global_scope()
        # strategy.elastic: resume from the newest checkpoint before the
        # program's first step
        ecfg = getattr(program, "_elastic_cfg", None)
        if ecfg is not None and not ecfg.get("_resumed"):
            self._elastic_resume(program, ecfg, scope)
        fetch_names = self._fetch_names(fetch_list)
        ring = self._dp_ring(program)
        feed = feed or {}
        if ring is not None:
            feed = self._split_feed(feed, ring)
        feeds = self._prepare_feed(program.global_block(), feed)

        entry = self._entry(program, feeds, fetch_names, scope,
                            use_program_cache, ring)
        self.last_entry = entry
        if ring is not None:
            self._sync_start(program, scope, ring)
            self._layout_sharded(entry, scope)
        states = self._gather_states(entry.state_in, scope)
        seed = framework._global_seed_and_bump(program)
        fetches, new_states = entry.run(feeds, states, seed % (2**31))
        for n, v in new_states.items():
            scope.set_var(n, v)
        if ecfg is not None:
            self._elastic_tick(program, ecfg, scope)
        if get_flag("FLAGS_check_nan_inf"):
            self._check_nan_inf(fetch_names, fetches, new_states)
        if ring is not None:
            fetches = self._gather_fetches(program, fetch_names, fetches,
                                           ring)
        if return_numpy:
            return [self._fetch_to_numpy(v) for v in fetches]
        if entry.mode == "graph":
            # the next replay rewrites the graph's outputs
            return [v.clone() for v in fetches]
        return fetches

    def compiled_blocks(self) -> list:
        """`CompiledBlock.info()` of every cached entry, oldest first."""
        return [entry.info() for entry in self._cache.values()]

    def warmup(self, program=None, shapes=None, meshes=None,
               fetch_list=None, scope=None, background=False):
        """Compile `program` for each feed-shape bucket in `shapes` (a
        list of dicts: feed name -> shape tuple, or an example array)
        before traffic (counterpart: the reference's `warmup`): a graph
        entry runs its eager step and its capture on COPIES of the
        scope's state with seed 0, so the first real run of that shape
        replays; an eager entry runs one discarded step on copies. The
        scope and the program's seed counter are untouched. Returns
        {"compiled": [...], "cached": [...], "skipped": [...]}: buckets
        compiled now, found compiled, and those whose feeds could not be
        built (with the error). A data-parallel program's buckets are
        global batches, each rank warming its own rows (every rank must
        call it alike).

        ``background=True`` returns a daemon `threading.Thread` named
        "paddle-tpu-warmup" at once; its ``warmup_report`` (the same
        report) lands when it ends. There the executor's cache is never
        touched (the reference's ``use_cache=not in_background``): each
        bucket's entry is compiled apart and one discarded eager step
        runs on copies of the state, on a CUDA stream of its own, which
        warms what the port has in place of the reference's persistent
        compile tier: the `csrc` kernels' build at first use, cuBLAS's
        handles and cuDNN's algorithm choices. A data-parallel program's
        step runs there on this rank's rows without its collectives
        (issued from a second thread they would break the ranks' one
        order), its sharded state as zeros of the logical shapes.
        `meshes` (compiling ahead for other worlds, an elastic
        restart's) is not ported (ROADMAP Queue 1 #10) and raises."""
        if meshes is not None:
            raise NotImplementedError(
                "warmup(meshes=...) is not ported: it compiles ahead for "
                "the worlds of an elastic restart, which come with "
                "live_resize and the elastic launch (ROADMAP Queue 1 #10)")
        program = self._program(program)
        scope = scope or global_scope()
        fetch_names = self._fetch_names(fetch_list)
        if not background:
            return self._warmup_impl(program, shapes, fetch_names, scope)

        def run():
            thread.warmup_report = self._warmup_impl(
                program, shapes, fetch_names, scope, in_background=True)

        thread = threading.Thread(target=run, daemon=True,
                                  name="paddle-tpu-warmup")
        thread.warmup_report = None
        thread.start()
        return thread

    def _warmup_impl(self, program, shapes, fetch_names, scope,
                     in_background=False):
        ring = self._dp_ring(program)
        block = program.global_block()
        report = {"compiled": [], "cached": [], "skipped": []}
        for s in shapes or []:
            desc = {k: list(getattr(v, "shape", v)) for k, v in s.items()}
            try:
                feeds = self._warmup_feeds(block, s)
                if ring is not None:
                    feeds = self._split_feed(feeds, ring)
            except Exception as e:  # noqa: BLE001 - reported per bucket
                report["skipped"].append(
                    {"shapes": desc, "error": "%s: %s" % (
                        type(e).__name__, e)})
                continue
            if in_background:
                report["compiled"].append(self._warmup_apart(
                    program, feeds, fetch_names, scope, ring, desc))
                continue
            known = self._cache_key(program, feeds, fetch_names,
                                    scope, ring) in self._cache
            entry = self._entry(program, feeds, fetch_names, scope, True,
                                ring)
            item = {"shapes": desc, "mode": entry.mode,
                    "reason": entry.reason}
            if entry.phase == "captured" or (known and entry.mode == "eager"):
                report["cached"].append(item)
                continue
            copies = {n: v.clone() for n, v in self._gather_states(
                entry.state_in, scope).items()}
            self._layout_sharded(entry, copies)
            # an eager entry's discarded step, or a graph entry's eager
            # step and then its capture (with one replay)
            entry.run(feeds, copies, 0)
            if entry.phase == "warm":
                entry.run(feeds, copies, 0)
            report["compiled"].append(item)
        return report

    def _warmup_apart(self, program, feeds, fetch_names, scope, ring, desc):
        """The background warmup of one bucket: its report item (the mode
        and reason its cached entry would have) after one discarded eager
        step of an entry of its own, without the ring's collectives, on
        copies of the state on a side stream."""
        block = program.global_block()
        mode, reason = lowering.entry_mode(program, block, self.device,
                                           ring, self._graph_runner)
        entry = lowering.compile_block(program, block, list(feeds),
                                       fetch_names, self.device)
        plan = getattr(program, "_shard_plan", None) \
            if ring is not None else None
        stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        with torch.cuda.stream(stream) if stream is not None \
                else contextlib.nullcontext():
            if stream is not None:
                stream.wait_stream(torch.cuda.default_stream(self.device))
            copies = {}
            for n, v in self._gather_states(entry.state_in, scope).items():
                info = plan.sharded_state.get(n) if plan is not None \
                    else None
                copies[n] = v.clone() if info is None or \
                    tuple(v.shape) == info.shape else torch.zeros(
                        info.shape, dtype=v.dtype, device=v.device)
            entry.fn(feeds, copies, StepSeed(0, seed_tensor(0, self.device)))
        if stream is not None:
            stream.synchronize()
        return {"shapes": desc, "mode": mode, "reason": reason}

    def overlap_report(self, program=None, feed=None, fetch_list=None,
                       scope=None):
        """Which gradient collectives of a data-parallel step began while
        the backward was still producing gradients (counterpart: the
        reference's `overlap_report`, an audit of its scheduled HLO): the
        record of the cached entry for these feeds' and fetches' last
        eager run, or of its capture, which fixes the order every replay
        launches in (fleet's in-place `c_allreduce_sum` sums are part of
        that exchange). None for a program without a backward or a
        world, or an entry that has not run yet. Returns {"collectives": [...],
        "n_backward", "n_buckets", "overlappable_reduce_scatters",
        "launched_in_backward", "captured"}; each collective has its
        "kind" ("reduce_scatter" or "all_reduce"), "bucket" (None for
        one gradient), "grads", "bytes", "backward_after" (leaf
        gradients the backward produced after its launch) and
        "starts_before_final_backward". With buckets, bucket 0 shows
        ``backward_after > 0``; with `FLAGS_tpu_comm_bucket_mb` 0 the
        exchange follows the last gradient and every collective shows
        0."""
        program = self._program(program)
        ring = self._dp_ring(program)
        if ring is None:
            return None
        feeds = self._prepare_feed(program.global_block(),
                                   self._split_feed(feed or {}, ring))
        entry = self._cache.get(self._cache_key(
            program, feeds, self._fetch_names(fetch_list),
            scope or global_scope(), ring))
        rep = entry.overlap if entry is not None else None
        if rep is None:
            return None
        return dict(rep, collectives=[dict(c) for c in rep["collectives"]],
                    overlappable_reduce_scatters=sum(
                        1 for c in rep["collectives"]
                        if c["kind"] == "reduce_scatter"
                        and c["backward_after"] > 0))

    def read_logical(self, name, program=None, scope=None):
        """The scope's value of `name` at its logical shape, a tensor: a
        var the data-parallel `program` keeps sharded (its last compiled
        plan, ``program._shard_plan``) is gathered over the world's ring
        and unsharded, so every rank must call this alike; any other var
        is the scope's tensor as it is."""
        v = (scope or global_scope()).find_var(name)
        if v is None:
            raise KeyError("var %r is not in the scope" % name)
        return _su.logical_value(self._program(program), name, v)

    def feed_sharding(self, program=None):
        """The rows of a global batch this process's run of `program`
        keeps (counterpart: the reference's `feed_sharding`): None for a
        program that is not data-parallel or runs without a world, else
        a `reader.prefetcher.RowShard` of this rank. Hand it to
        `reader.prefetch_to_device`, which then copies only those rows
        to the card, and `run` takes the prefetched feeds as they are."""
        ring = self._dp_ring(self._program(program))
        if ring is None:
            return None
        return prefetcher.RowShard(
            ring.rank, ring.size,
            spec=(("dcn", "ici"),) if ring.dcn is not None else ("dp",))

    # -- dataset training (reference: executor.py:1454) --------------------
    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           fetch_handler=None, checkpoint_dir=None,
                           checkpoint_every_n_steps=0, checkpoint_num=3):
        """`fluid/trainer.py train_from_dataset` with this executor
        (`thread`, `debug`, `fetch_info` and `fetch_handler` are the
        reference's and unread: one prepared step runs a batch)."""
        from .trainer import train_from_dataset as _tfd

        return _tfd(self, program, dataset, scope, fetch_list, print_period,
                    checkpoint_dir=checkpoint_dir,
                    checkpoint_every_n_steps=checkpoint_every_n_steps,
                    checkpoint_num=checkpoint_num)

    def infer_from_dataset(self, *args, **kwargs):
        return self.train_from_dataset(*args, **kwargs)

    # -- strategy.elastic: the checkpoint half (reference: executor.py
    # _elastic_resume, _elastic_tick); the elastic restart itself
    # (live_resize, the elastic warmup) is ROADMAP Queue 1 #10 -------------
    def _elastic_resume(self, program, ecfg, scope):
        """Load the newest checkpoint under the config's
        ``checkpoint_dir`` (if any) and count the steps on from it; marked
        resumed only once the load succeeded or found nothing."""
        from . import checkpoint as ckpt

        root = ecfg.get("checkpoint_dir") or "elastic_checkpoints"
        status = ckpt.load_checkpoint(self, root, main_program=program,
                                      scope=scope)
        ecfg["_resumed"] = True
        if status is not None:
            ecfg["_step"] = status.step_no + 1
            ckpt._log.info("elastic: resumed at step %d from %r",
                           status.step_no, root)
        else:
            ecfg.setdefault("_step", 0)

    def live_resize(self, program, mesh=None, ndev=None, scope=None):
        """Not ported: moving a running program to another world comes
        with the elastic launch (ROADMAP Queue 1 #10)."""
        raise NotImplementedError(
            "live_resize is not ported: it comes with the elastic launch "
            "(ROADMAP Queue 1 #10)")

    def _elastic_tick(self, program, ecfg, scope):
        """After each step: every ``save_steps`` steps an asynchronous
        checkpoint of the state (its writer flushed at exit)."""
        from . import checkpoint as ckpt

        step = ecfg.get("_step", 0)
        ecfg["_step"] = step + 1
        every = int(ecfg.get("save_steps", 100) or 100)
        if (step + 1) % every:
            return
        cp = ecfg.get("_ckpt")
        if cp is None:
            import atexit

            root = ecfg.get("checkpoint_dir") or "elastic_checkpoints"
            cp = ckpt.AsyncCheckpointer(
                root, main_program=program,
                checkpoint_num=int(ecfg.get("max_checkpoints", 3) or 3),
                scope=scope)
            ecfg["_ckpt"] = cp
            atexit.register(cp.close)
        cp.save_async(ckpt.TrainStatus(epoch_no=0, step_no=step))

    def close(self):
        """Release every entry's graph and static buffers."""
        for entry in self._cache.values():
            entry.release()
        self._cache.clear()
        self.last_entry = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _program(program):
        program = program or framework.default_main_program()
        return program._unwrap() if isinstance(program, CompiledProgram) \
            else program

    @staticmethod
    def _dp_ring(program):
        """The ring a data-parallel program runs over (None: a single
        process): the world's, or its hybrid (dcn, ici) pair's
        (`parallel/env.py program_ring`)."""
        return penv.program_ring(program) if program._data_parallel \
            else None

    @staticmethod
    def _split_feed(feed, ring):
        """This rank's rows of each global feed (arrays or tensors):
        [r B/N, (r+1) B/N); a feed the prefetcher already cut to this
        rank's rows (`feed_sharding`) stays as it is."""
        out = {}
        for name, t in feed.items():
            if prefetcher.rows_of(t) == (ring.rank, ring.size):
                out[name] = t
                continue
            if not hasattr(t, "shape"):
                t = np.asarray(t)
            rows = t.shape[0] if len(t.shape) else 0
            if rows % ring.size or not rows:
                raise ValueError(
                    "feed %r: a batch of %d rows does not split over %d "
                    "ranks" % (name, rows, ring.size))
            k = rows // ring.size
            out[name] = t[ring.rank * k:(ring.rank + 1) * k]
        return out

    def _sync_start(self, program, scope, ring):
        """Before a data-parallel program's first run in `scope`: every
        persistable of it that the scope holds and that no earlier
        program broadcast there becomes rank 0's (so a for_test clone
        leaves the per-rank running statistics alone), and with
        random_seed 0 the program counts its step seeds from rank 0's
        draw. Every rank runs the same programs, so the same
        broadcasts."""
        key = (program._uid, program._version, getattr(scope, "_uid", 0),
               ring.uid)
        if key in self._dp_checked:
            return
        synced = self._dp_synced.setdefault(key[2:], set())
        names = sorted({v.name for v in program.list_vars()
                        if v.persistable and v.name not in synced
                        and isinstance(scope.find_var(v.name),
                                       torch.Tensor)})
        for n in names:
            scope.set_var(n, collective_ops.broadcast(scope.find_var(n),
                                                      ring, 0))
        synced.update(names)
        if not program.random_seed and program._shared_seed is None:
            mine = torch.tensor([np.random.randint(0, 2**31 - 1)],
                                dtype=torch.int64, device=self.device)
            program._shared_seed = int(collective_ops.broadcast(
                mine, ring, 0).item())
        self._dp_checked.add(key)

    @staticmethod
    def _layout_sharded(entry, states):
        """Lay each var the entry keeps sharded out as this rank's flat
        slice (`states`: a scope, or a dict of name -> tensor), where it
        still holds the logical value (the startup's, the broadcast's, a
        checkpoint's)."""
        plan = entry.shard_plan
        if plan is None:
            return
        is_dict = isinstance(states, dict)
        for n, info in plan.sharded_state.items():
            v = states.get(n) if is_dict else states.find_var(n)
            if not isinstance(v, torch.Tensor) or \
                    tuple(v.shape) == (info.padded // plan.ndev,):
                continue
            v = _su.to_sharded_local(v, info, plan.rank, plan.ndev)
            if is_dict:
                states[n] = v
            else:
                states.set_var(n, v)

    @staticmethod
    def _gather_fetches(program, fetch_names, fetches, ring):
        """Non-persistable fetches concatenated over the ranks along axis
        0 (a 0-d value as one row a rank)."""
        block = program.global_block()
        out = []
        for n, v in zip(fetch_names, fetches):
            var = block._find_var_recursive(n)
            if var is None or not var.persistable:
                v = torch.cat(collective_ops.all_gather(
                    v.reshape(1) if v.ndim == 0 else v, ring), 0)
            out.append(v)
        return out

    @staticmethod
    def _fetch_names(fetch_list):
        return [f.name if isinstance(f, framework.Variable) else str(f)
                for f in (fetch_list or [])]

    def _entry(self, program, feeds, fetch_names, scope, use_cache,
               ring=None):
        """The cached entry for this run, compiled and cached (evicting
        the least recently used beyond the cache's size) if new."""
        key = self._cache_key(program, feeds, fetch_names, scope, ring)
        entry = self._cache.get(key) if use_cache else None
        if entry is not None:
            self._cache.move_to_end(key)
            return entry
        if int(get_flag("FLAGS_tpu_warmup_elastic_variants", 0) or 0) > 0:
            raise NotImplementedError(
                "FLAGS_tpu_warmup_elastic_variants is not ported: it "
                "compiles ahead for the worlds of an elastic restart, which "
                "come with live_resize and the elastic launch (ROADMAP "
                "Queue 1 #10)")
        entry = lowering.compile_block(
            program, program.global_block(), list(feeds), fetch_names,
            self.device, graph_runner=self._graph_runner, ring=ring)
        if use_cache:
            self._cache[key] = entry
            limit = int(get_flag("FLAGS_tpu_compile_cache_size", 128)
                        or 128)
            while len(self._cache) > limit:
                self._cache.popitem(last=False)[1].release()
        return entry

    def _warmup_feeds(self, block, shapes):
        """Zero feeds of the bucket's shapes, in each var's dtype."""
        out = {}
        for name, spec in shapes.items():
            if hasattr(spec, "shape") and hasattr(spec, "dtype"):
                out[name] = spec
                continue
            v = block._find_var_recursive(name)
            if v is None:
                raise KeyError("feed %r is not a var of the program" % name)
            out[name] = np.zeros(tuple(int(d) for d in spec),
                                 to_numpy_dtype(v.dtype))
        return self._prepare_feed(block, out)

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

    def _cache_key(self, program, feeds, fetch_names, scope, ring=None):
        feed_key = tuple(sorted(
            (n, tuple(t.shape), str(t.dtype)) for n, t in feeds.items()))
        # never-reused uids (not id()) so GC'd programs/scopes/worlds
        # cannot alias a stale prepared block
        return (program._uid, program._version, feed_key,
                tuple(fetch_names), getattr(scope, "_uid", 0),
                ring.uid if ring is not None else 0)
