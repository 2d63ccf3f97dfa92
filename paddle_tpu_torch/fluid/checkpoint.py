"""Preemption-safe numbered checkpoints and auto-resume (counterpart:
`paddle_tpu/fluid/checkpoint.py`; reference:
`python/paddle/fluid/incubate/fleet/collective/__init__.py:155-341`).

The layout is the reference's: numbered ``__paddle_tpu_checkpoint__.N``
directories under a root, each holding every persistable in one pickle
(``persistables.pkl``, `fluid/io.py`'s format, logical shapes) and the
`TrainStatus` as ``train_status.json``. A directory is written as
``<dir>.tmp`` and published with `os.replace`, so a kill during a save
never leaves a half-written newest checkpoint; the oldest beyond
`checkpoint_num` are removed. `load_checkpoint` restores the newest one
that loads, falling back past an unreadable one, and raises at once when
the program's persistables and the checkpoint's differ (every older one
differs alike).

Where the state lives on the card and a captured block's replay writes
the new state into the very tensors the scope holds, a snapshot must not
keep references: `_snapshot` clones each value on the device, on the
stream the step ran on, and records an event after the clones before it
returns. `AsyncCheckpointer`'s writer thread waits on that event, copies
the clones to the host on a stream of its own and writes the files, so
it never reads a tensor a later replay may overwrite.

In a data-parallel world every rank calls `save_checkpoint` and
`AsyncCheckpointer.save_async` alike: the sharded weight update's slices
are gathered to their logical shapes there (a collective). Where every
rank names the same root, rank 0 writes; where each names its own
(per-rank directories), each writes its own. `load_checkpoint` with a
host-collective `group`, or under ``PADDLE_CKPT_AGREE=1`` (which
`distributed.launch` sets for its workers), makes the ranks agree on
the newest checkpoint every rank can load
(`distributed/sharded_checkpoint.py agree_newest_intact`).

The program's step seed is not saved (nor in the reference): a resumed
run repeats the uninterrupted one bit for bit only where no op draws
random numbers.
"""
from __future__ import annotations

import json
import logging
import os
import queue
import shutil
import threading

import torch

from .io import _bind, _device_of, _dp_ring, _load_dict, _main, \
    _program_vars, _save_dict, is_persistable
from ..core.scope import global_scope
from ..parallel.sharded_update import logical_value

_CHECKPOINT_PREFIX = "__paddle_tpu_checkpoint__"
_STATUS_FILE = "train_status.json"
_PARAM_FILE = "persistables.pkl"

_log = logging.getLogger("paddle_tpu_torch.checkpoint")
#: how long `AsyncCheckpointer.close` waits for the pending write
_CLOSE_TIMEOUT_S = 300.0

__all__ = [
    "TrainStatus", "save_checkpoint", "load_checkpoint",
    "get_last_checkpoint_no", "clean_redundant_checkpoints",
    "AsyncCheckpointer", "publish_checkpoint_dir", "read_status",
    "latest_checkpoint_dir",
]


class TrainStatus:
    """Progress stored with each checkpoint: the last completed epoch,
    the last completed step and a free-form dict."""

    def __init__(self, epoch_no=-1, step_no=-1, extra=None):
        self._epoch_no = int(epoch_no)
        self._step_no = int(step_no)
        self._extra = dict(extra or {})

    @property
    def epoch_no(self):
        return self._epoch_no

    @property
    def step_no(self):
        return self._step_no

    @property
    def extra(self):
        return self._extra

    def next(self):
        """The first epoch still to run."""
        return self._epoch_no + 1

    def __eq__(self, t):
        return (isinstance(t, TrainStatus)
                and self._epoch_no == t._epoch_no
                and self._step_no == t._step_no)

    def __ne__(self, t):
        return not self == t

    def _to_dict(self):
        return {"epoch_no": self._epoch_no, "step_no": self._step_no,
                "extra": self._extra}

    @staticmethod
    def _from_dict(d):
        return TrainStatus(d.get("epoch_no", -1), d.get("step_no", -1),
                           d.get("extra"))


def _ckpt_dirs(root):
    out = {}
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for nm in names:
        parts = nm.split(".")
        if len(parts) != 2 or parts[0] != _CHECKPOINT_PREFIX:
            continue
        try:
            out[int(parts[1])] = os.path.join(root, nm)
        except ValueError:
            continue
    return out


def get_last_checkpoint_no(root):
    """The largest published checkpoint number under `root`, or -1."""
    nos = _ckpt_dirs(root)
    return max(nos) if nos else -1


def clean_redundant_checkpoints(root, checkpoint_num=1):
    """Keep the newest `checkpoint_num` numbered directories."""
    checkpoint_num = max(int(checkpoint_num), 1)
    dirs = _ckpt_dirs(root)
    if not dirs:
        return
    cutoff = max(dirs) - checkpoint_num
    for n, path in dirs.items():
        if n <= cutoff:
            shutil.rmtree(path, ignore_errors=True)


class Snapshot:
    """The persistables of one moment: `values` {name: tensor}, clones
    at their logical shapes; `event` (None on the CPU) is recorded after
    the clones, on the stream the step ran on."""

    def __init__(self, values, event):
        self.values = values
        self.event = event

    def to_host(self):
        """{name: CPU tensor}: the clones copied to the host on a stream
        of this thread's own, once the event has passed."""
        if self.event is None:
            return {n: v.detach().cpu() for n, v in self.values.items()}
        dev = next(iter(self.values.values())).device
        stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            stream.wait_event(self.event)
            out = {n: v.to("cpu", non_blocking=False)
                   for n, v in self.values.items()}
        stream.synchronize()
        return out


def _snapshot(main_program, scope=None):
    """A `Snapshot` of `main_program`'s persistables in `scope`: device
    clones (sharded state gathered to its logical shape, a collective),
    made on the current stream before this returns."""
    program = _main(main_program)
    scope = scope or global_scope()
    values, cuda = {}, None
    for name in _program_vars(program, is_persistable):
        v = scope.find_var(name)
        if not isinstance(v, torch.Tensor):
            continue
        logical = logical_value(program, name, v)
        values[name] = logical.clone() if logical is v else logical
        if v.is_cuda:
            cuda = v.device
    event = None
    if cuda is not None:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(cuda))
    return Snapshot(values, event)


def _before_publish(tmp_dir):
    """Called with the payload written and the directory not yet
    published: a test kills the process here (the reference's
    `faults.on_message("ckpt", "write")`; ROADMAP Queue 1 #10 ports the
    fault injector)."""


def publish_checkpoint_dir(root, write_fn, train_status, checkpoint_num):
    """`write_fn(tmp_dir)` writes the payload into ``<dir>.tmp``, the
    TrainStatus goes beside it, and the directory is published as
    ``<root>/__paddle_tpu_checkpoint__.<N+1>`` with `os.replace`; then
    the oldest beyond `checkpoint_num` go. Returns the new directory."""
    os.makedirs(root, exist_ok=True)
    n = get_last_checkpoint_no(root) + 1
    real = os.path.join(root, "%s.%d" % (_CHECKPOINT_PREFIX, n))
    tmp = real + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    write_fn(tmp)
    with open(os.path.join(tmp, _STATUS_FILE), "w") as f:
        json.dump(train_status._to_dict(), f)
    _before_publish(tmp)
    os.replace(tmp, real)
    if checkpoint_num:
        clean_redundant_checkpoints(root, checkpoint_num)
    return real


def read_status(ckpt_dir):
    """The TrainStatus of one published checkpoint directory."""
    with open(os.path.join(ckpt_dir, _STATUS_FILE)) as f:
        return TrainStatus._from_dict(json.load(f))


def latest_checkpoint_dir(root):
    """The newest published checkpoint directory under `root`, or None."""
    n = get_last_checkpoint_no(root)
    if n < 0:
        return None
    return os.path.join(root, "%s.%d" % (_CHECKPOINT_PREFIX, n))


def _write_checkpoint(root, host_values, train_status, checkpoint_num):
    return publish_checkpoint_dir(
        root, lambda tmp: _save_dict(tmp, host_values, _PARAM_FILE),
        train_status, checkpoint_num)


def _writes_here(program, root):
    """(whether this process writes under `root`, the data-parallel ring
    or None): with every rank of the world naming one root, rank 0;
    with a root of each rank's own, every rank."""
    ring = _dp_ring(program)
    if ring is None:
        return True, None
    import torch.distributed as dist

    roots = [None] * ring.size
    dist.all_gather_object(roots, os.path.abspath(root), group=ring.group)
    if len(set(roots)) > 1:
        return True, None
    return ring.rank == 0, ring


def save_checkpoint(executor, path, train_status=None, main_program=None,
                    checkpoint_num=3, scope=None):
    """A numbered checkpoint of every persistable (parameters, optimizer
    state, batch-norm statistics) with its `train_status`, written before
    this returns (on every rank, in a world that shares `path`). Returns
    the directory (None on a rank that does not write)."""
    program = _main(main_program)
    snap = _snapshot(program, scope)
    writes, ring = _writes_here(program, path)
    real = None
    if writes:
        real = _write_checkpoint(path, snap.to_host(),
                                 train_status or TrainStatus(),
                                 checkpoint_num)
    if ring is not None:
        import torch.distributed as dist

        dist.barrier(group=ring.group)
    return real


class _SchemaMismatch(RuntimeError):
    """A readable checkpoint whose vars disagree with the program: not
    corruption, so the fallback must not try older directories."""


def _read_one_checkpoint(real, names):
    """(values, status) of one published directory; raises on any
    defect without touching a scope."""
    d = _load_dict(real, names, _PARAM_FILE)
    missing = [nm for nm in names if nm not in d]
    if missing:
        raise _SchemaMismatch("checkpoint %r is missing vars %s"
                              % (real, missing))
    with open(os.path.join(real, _STATUS_FILE)) as f:
        status = TrainStatus._from_dict(json.load(f))
    return {n: d[n] for n in names}, status


def load_checkpoint(executor, path, main_program=None, scope=None,
                    ignore_empty=True, group=None):
    """Restore the newest intact numbered checkpoint under `path` into
    the scope (on the executor's device, each var in the dtype it holds
    there); returns its TrainStatus, or None when there is none (with
    `ignore_empty`; else raises).

    An unreadable newest directory is skipped with a warning for the
    next newest; a checkpoint whose vars differ from the program's
    persistables raises at once. With a host-collective `group`
    (`distributed.host_collectives`), or under ``PADDLE_CKPT_AGREE=1``,
    the ranks agree on the newest step every rank can load (an
    all-reduce-min protocol), so one rank's corrupt newest directory
    cannot leave the replicas apart."""
    program = _main(main_program)
    scope = scope or global_scope()
    dirs = _ckpt_dirs(path)
    names = list(_program_vars(program, is_persistable))

    def restore(real):
        values, status = _read_one_checkpoint(real, names)
        _bind(program, scope, values, _device_of(executor, scope, names))
        return status

    if group is None:
        from ..distributed.sharded_checkpoint import _env_agree_group

        group = _env_agree_group()
    if group is not None:
        import numpy as np

        from ..distributed.sharded_checkpoint import agree_newest_intact

        # a rank with an empty directory still joins the protocol: all
        # empty, every rank agrees there is nothing; some empty, every
        # rank fails alike
        newest = max(dirs) if dirs else -1
        global_newest = int(group.all_reduce(
            np.asarray([newest], np.int64), op="max")[0])
        if global_newest < 0:
            if not ignore_empty:
                raise RuntimeError(
                    "no checkpoint found under %r (on any rank)" % path)
            return None
        _, status = agree_newest_intact(
            sorted(dirs, reverse=True), lambda n: restore(dirs[int(n)]),
            group, what="fluid checkpoint", fatal=(_SchemaMismatch,))
        return status
    if not dirs:
        if not ignore_empty:
            raise RuntimeError("no checkpoint found under %r" % path)
        return None
    last_err = None
    for n in sorted(dirs, reverse=True):
        try:
            return restore(dirs[n])
        except _SchemaMismatch:
            raise
        except Exception as e:  # noqa: BLE001 - corrupt or partial dir
            last_err = e
            _log.warning("checkpoint %s is unreadable (%s: %s); falling "
                         "back to the previous one", dirs[n],
                         type(e).__name__, e)
    raise RuntimeError(
        "no intact checkpoint under %r (tried %s)"
        % (path, [dirs[n] for n in sorted(dirs, reverse=True)])
    ) from last_err


class AsyncCheckpointer:
    """Checkpoints written in the background: `save_async` takes a
    `Snapshot` on the caller's thread (device clones, a few ms) and
    returns; a worker thread copies it to the host and writes it. At
    most one save waits: a newer one replaces it (a preemption wants the
    newest state, not a queue)."""

    def __init__(self, path, main_program=None, checkpoint_num=3,
                 scope=None):
        self._path = path
        self._program = _main(main_program)
        self._checkpoint_num = checkpoint_num
        self._scope = scope
        self._pending: "queue.Queue" = queue.Queue(maxsize=1)
        self._err = []
        self._done = threading.Event()
        self._writes = None
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="paddle_tpu_torch-ckpt-writer")
        self._worker.start()

    def _run(self):
        while True:
            item = self._pending.get()
            if item is None:
                self._done.set()
                return
            snap, status = item
            try:
                _write_checkpoint(self._path, snap.to_host(), status,
                                  self._checkpoint_num)
            except BaseException as e:  # noqa: BLE001 - raised by check()
                self._err.append(e)

    def check(self):
        """Raise the first background write error, if any."""
        if self._err:
            raise RuntimeError(
                "background checkpoint write failed") from self._err[0]

    def save_async(self, train_status):
        """Snapshot now (every rank of a data-parallel world alike) and
        queue the write; returns at once."""
        self.check()
        snap = _snapshot(self._program, self._scope)
        if self._writes is None:
            self._writes = _writes_here(self._program, self._path)[0]
        if not self._writes:
            return
        item = (snap, train_status)
        while True:
            try:
                self._pending.put_nowait(item)
                return
            except queue.Full:
                try:  # replace the stale pending save
                    self._pending.get_nowait()
                except queue.Empty:
                    pass

    def close(self):
        """Write what is pending and stop the worker; raises the first
        background error."""
        if self._worker.is_alive():
            self._pending.put(None)
            self._done.wait(timeout=_CLOSE_TIMEOUT_S)
        if self._err:
            raise self._err[0]
