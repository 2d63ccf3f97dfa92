"""Device-side input prefetch: the next batch's host-to-card copy rides
under the current step (counterpart: `paddle_tpu/reader/prefetcher.py`).

The reference's producer thread issues non-blocking `jax.device_put`s of
batch N+1 while step N computes. The port's counterpart of that put is a
copy from a pinned host buffer on a side CUDA stream, with an event
recorded after it: the consumer's stream waits on the event when the
batch is handed out (`next()`), so the step that reads the batch is
ordered after its copy while the host never blocks, and each tensor is
marked as used on the consumer's stream, so the caching allocator does
not reuse its memory for a later copy while the step still reads it. On
the CPU (`device="cpu"`, the tests) the put is a copy into a fresh
tensor.

The reference's contract holds:
- depth is bounded (`FLAGS_tpu_prefetch_depth`, default 2): at most
  `size` batches wait on the card ahead of the consumer;
- a producer's error surfaces at the consumer's `next()`, the original
  exception, never a silently short epoch;
- `close()` (also a context manager's exit, an early `break` that drops
  the iterator, garbage collection) stops the producer, drains the
  queued batches and joins the thread;
- every tensor handed out is one the prefetcher made for that batch
  alone (never the caller's array, never one handed out before): it is
  *donatable* (`is_donatable`).

For a data-parallel program, `Executor.feed_sharding` gives a `RowShard`
of this rank: the prefetcher then copies only this rank's rows of each
global batch, marks them (`rows_of`), and the executor takes them as
they are instead of splitting them again.
"""
from __future__ import annotations

import queue as _queue
import threading
import weakref
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

_END = object()

# Tensors the prefetcher made: single-consumer by contract. Keyed by
# id() with a weakref callback (a tensor's == is elementwise, so a
# WeakSet cannot hold them); the `ref() is x` check guards against id
# reuse after collection.
_DONATABLE = {}
# id -> (weakref, (rank, world)) of tensors cut to one rank's rows
_ROWS = {}


def _register(table, x, value):
    key = id(x)
    table[key] = (weakref.ref(x, lambda _r, _k=key: table.pop(_k, None)),
                  value)


def _lookup(table, x):
    hit = table.get(id(x))
    return hit[1] if hit is not None and hit[0]() is x else None


def mark_donatable(x):
    """Register a tensor as single-consumer: its consumer may reuse its
    memory. Returns False when `x` cannot be weakly referenced (then it
    is caller-owned)."""
    try:
        _register(_DONATABLE, x, True)
        return True
    except TypeError:
        return False


def is_donatable(x) -> bool:
    return bool(_lookup(_DONATABLE, x))


def rows_of(x):
    """(rank, world) when `x` holds only that rank's rows of a global
    batch, as the prefetcher cut them; else None."""
    return _lookup(_ROWS, x)


class RowShard:
    """Rank `rank`'s rows [rank B/N, (rank+1) B/N) of a global batch of
    B rows over a world of N (the executor's split of a data-parallel
    feed). `spec` names the mesh axes axis 0 splits over, as the
    reference's `PartitionSpec`: ("dp",), or (("dcn", "ici"),) on a
    hybrid world, dcn-major."""

    __slots__ = ("rank", "world", "spec")

    def __init__(self, rank, world, spec=("dp",)):
        self.rank, self.world = int(rank), int(world)
        self.spec = tuple(spec)

    def rows(self, n):
        """[lo, hi) of a batch of `n` rows, or None when the world does
        not divide it (the batch then goes whole, and the executor's
        split raises as for a host feed)."""
        if not n or n % self.world:
            return None
        k = n // self.world
        return self.rank * k, (self.rank + 1) * k

    def __eq__(self, other):
        return isinstance(other, RowShard) and \
            (self.rank, self.world) == (other.rank, other.world)

    def __repr__(self):
        return "RowShard(rank %d of %d)" % (self.rank, self.world)


class _ProducerError:
    def __init__(self, exc):
        self.exc = exc


def _default_depth() -> int:
    from ..utils.flags import get_flag

    return max(1, int(get_flag("FLAGS_tpu_prefetch_depth", 2) or 2))


def _resolve(device):
    from ..core.place import resolve_device

    return resolve_device(device)


_STREAMS = {}


def _side_stream(device):
    """The copy stream of `device`, one a process and card."""
    s = _STREAMS.get(device)
    if s is None:
        s = _STREAMS[device] = torch.cuda.Stream(device)
    return s


def _host_tensor(a):
    """A host tensor holding the array `a` (numpy or tensor)."""
    if isinstance(a, torch.Tensor):
        return a.detach()
    from ..core.types import from_numpy

    return from_numpy(np.ascontiguousarray(a), "cpu")


def _put(value, sharding, device):
    """Issue one batch's copies (a dict, list or tuple of arrays, or one
    array). Returns (the batch on `device`, the copy's event or None)."""
    cuda = device.type == "cuda"
    stream = _side_stream(device) if cuda else None

    def put_one(name, a):
        s = sharding.get(name) if isinstance(sharding, dict) else sharding
        rows = None
        if s is not None and getattr(a, "ndim", 0):
            lohi = s.rows(int(a.shape[0]))
            if lohi is not None:
                a, rows = a[lohi[0]:lohi[1]], (s.rank, s.world)
        if isinstance(a, torch.Tensor) and a.device == device:
            out = a  # already there: the caller's tensor (or its rows)
        else:
            host = _host_tensor(a)
            if cuda:
                pinned = torch.empty(host.shape, dtype=host.dtype,
                                     pin_memory=True)
                pinned.copy_(host)
                with torch.cuda.stream(stream):
                    out = pinned.to(device, non_blocking=True)
            else:
                out = host.to(device, copy=True)
            mark_donatable(out)
        if rows is not None:
            _register(_ROWS, out, rows)
        return out

    if isinstance(value, dict):
        out = {k: put_one(k, v) for k, v in value.items()}
    elif isinstance(value, (list, tuple)):
        out = type(value)(put_one(None, v) for v in value)
    else:
        out = put_one(None, value)
    event = None
    if cuda:
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def _tensors(batch):
    if isinstance(batch, dict):
        return list(batch.values())
    if isinstance(batch, (list, tuple)):
        return list(batch)
    return [batch]


def _hand_over(batch, event, device):
    """Order the consumer's current stream after the batch's copy, and
    mark each tensor as used there."""
    if event is None:
        return batch
    current = torch.cuda.current_stream(device)
    current.wait_event(event)
    for t in _tensors(batch):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            t.record_stream(current)
    return batch


def _offer(q, stop, item):
    """Put `item` on `q` unless `stop` is set first."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.2)
            return True
        except _queue.Full:
            continue
    return False


def _produce(it, q, stop, sharding, device):
    """The producer thread. It holds the queue and the stop event, not
    the prefetcher, so a dropped prefetcher is collected (and closes)."""
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        for item in it:
            if stop.is_set() or not _offer(q, stop,
                                           _put(item, sharding, device)):
                return
    except BaseException as e:  # noqa: BLE001 - re-raised by consumer
        _offer(q, stop, _ProducerError(e))
    finally:
        # the end marker must not be dropped on a full queue (the
        # consumer would wait forever); only close() skips it
        _offer(q, stop, _END)


class DevicePrefetcher:
    """Iterator wrapper: a producer thread pulls batches from `iterator`
    and issues their copies to `device` (None: this process's card),
    keeping at most `size` batches ahead of the consumer."""

    def __init__(self, iterator: Iterable, size: Optional[int] = None,
                 sharding=None, device=None):
        self._size = size if size and size > 0 else _default_depth()
        self._device = _resolve(device)
        self._q = _queue.Queue(maxsize=self._size)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=_produce, args=(iter(iterator), self._q, self._stop,
                                   sharding, self._device),
            daemon=True, name="paddle_tpu_torch-device-prefetch")
        self._thread.start()

    # -- consumer ----------------------------------------------------------
    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is _END:
            self._stop.set()
            self._thread.join(timeout=5.0)
            raise StopIteration
        if isinstance(item, _ProducerError):
            self.close()
            raise item.exc
        return _hand_over(*item, self._device)

    def close(self):
        """Stop the producer and drain the queued batches, so their card
        memory is released at once (an early exit, an error)."""
        self._stop.set()
        self._drain()
        self._thread.join(timeout=5.0)
        # a put in flight during the first drain can land one more item
        # before the producer sees the stop
        self._drain()

    def _drain(self):
        while True:
            try:
                self._q.get_nowait()
            except _queue.Empty:
                break

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


def prefetch_to_device(iterator: Iterable, size: Optional[int] = None,
                       sharding=None, device=None) -> DevicePrefetcher:
    """Wrap `iterator` (yielding dicts, lists or tuples of arrays, or
    arrays) so its batches arrive on `device` (None: this process's
    card; "cpu" for the CPU), `size` deep (default
    `FLAGS_tpu_prefetch_depth`). `sharding`: None, a `RowShard` for every
    array, or a dict name -> RowShard (a data-parallel program's is
    `Executor.feed_sharding`)."""
    return DevicePrefetcher(iterator, size=size, sharding=sharding,
                            device=device)


def device_put_batch(value, sharding=None, device=None):
    """One batch's copies to `device` on the side stream, the caller's
    current stream ordered after them (the prefetcher's put for a
    single batch); fresh tensors are marked donatable."""
    device = _resolve(device)
    return _hand_over(*_put(value, sharding, device), device)


def is_on_device(value) -> bool:
    """True when `value` is a tensor (the executor takes a tensor on its
    device as it is, without a copy); numpy arrays and Python values are
    False."""
    return isinstance(value, torch.Tensor)
