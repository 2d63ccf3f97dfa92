"""The port's data pipeline device side (paddle_tpu_torch.reader): the
elastic sample assignment (`resharding`) against the JAX package's
exactly, and the device prefetcher's contract on the CPU (the card's
side-stream copy is tests/test_torch_zero_cuda.py's): order, the depth
bound, a producer's error at `next()`, close and early exit, fresh
donatable buffers, a data-parallel rank's rows; an executor step fed by
the prefetcher equals one fed by hand, eager and through the graph path
(`graph_runner`), whose static feed buffers never alias a prefetched
tensor."""
import gc
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.reader import resharding as rres

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import reader
from paddle_tpu_torch.reader import prefetcher
from paddle_tpu_torch.reader import resharding as tres


# -- resharding ------------------------------------------------------------------

def test_resharding_matches_reference():
    for n in range(0, 13):
        for world in range(1, 6):
            for rank in range(world):
                assert tres.rank_slice(n, rank, world) == \
                    rres.rank_slice(n, rank, world)
    batch = {"x": np.arange(22).reshape(11, 2), "y": np.arange(11)}
    for world in (1, 2, 3, 4):
        for rank in range(world):
            got, want = (m.shard_batch(batch, rank, world)
                         for m in (tres, rres))
            assert sorted(got) == sorted(want)
            for k in got:
                np.testing.assert_array_equal(got[k], want[k])
            for seq in ([batch["x"], batch["y"]], batch["x"]):
                g, w = (m.shard_batch(seq, rank, world)
                        for m in (tres, rres))
                for a, b in zip(g if isinstance(g, list) else [g],
                                w if isinstance(w, list) else [w]):
                    np.testing.assert_array_equal(a, b)
    batches = [np.arange(i, i + 6) for i in range(5)]
    for a, b in zip(tres.shard_batches(batches, 1, 3),
                    rres.shard_batches(batches, 1, 3)):
        np.testing.assert_array_equal(a, b)
    assert [list(x) for x in tres.skip_steps(batches, 3)] == \
        [list(x) for x in rres.skip_steps(batches, 3)]
    for step, gb in ((0, 8), (7, 64), (-2, 4)):
        assert tres.resume_sample_offset(step, gb) == \
            rres.resume_sample_offset(step, gb)
    for r in range(5):
        assert tres.survivor_rank(r, [1, 3]) == rres.survivor_rank(r, [1, 3])
    for m in (tres, rres):
        with pytest.raises(ValueError):
            m.rank_slice(4, 2, 2)
        with pytest.raises(ValueError):
            m.shard_batch({"a": np.zeros(3), "b": np.zeros(4)}, 0, 2)


# -- the prefetcher ----------------------------------------------------------------

def _batches(n):
    return [{"x": np.full((4, 3), i, np.float32),
             "y": np.arange(4, dtype=np.int64) + i} for i in range(n)]


def test_order_fresh_donatable_buffers():
    src = _batches(6)
    got = list(reader.prefetch_to_device(iter(src), device="cpu"))
    assert len(got) == 6
    ids = set()
    for b, want in zip(got, src):
        for k in ("x", "y"):
            assert isinstance(b[k], torch.Tensor) and reader.is_on_device(b[k])
            np.testing.assert_array_equal(b[k].numpy(), want[k])
            # never the caller's array, never one handed out before
            assert not np.shares_memory(b[k].numpy(), want[k])
            assert reader.is_donatable(b[k])
            ids.add(b[k].data_ptr())
    assert len(ids) == 12
    assert not reader.is_on_device(src[0]["x"])
    # lists, tuples and bare arrays
    a = np.ones(3, np.float32)
    lst, tup, bare = reader.prefetch_to_device(
        iter([[a, a], (a,), a]), device="cpu")
    assert isinstance(lst, list) and isinstance(tup, tuple)
    assert isinstance(bare, torch.Tensor) and reader.is_donatable(bare)


def test_depth_bound():
    """The producer runs at most `size` batches (and the one in its
    hand) ahead of the consumer."""
    size, produced, consumed, lead = 2, [0], [0], [0]

    def gen():
        for i in range(10):
            produced[0] += 1
            lead[0] = max(lead[0], produced[0] - consumed[0])
            yield {"x": np.zeros(2, np.float32)}

    for _ in reader.prefetch_to_device(gen(), size=size, device="cpu"):
        time.sleep(0.01)
        consumed[0] += 1
    assert consumed[0] == 10
    assert lead[0] <= size + 2, lead[0]
    # the flag's default
    assert reader.DevicePrefetcher(iter([]), device="cpu")._size == 2


def test_producer_error_surfaces_at_next():
    class Boom(RuntimeError):
        pass

    def gen():
        yield {"x": np.zeros(2, np.float32)}
        raise Boom("the reader broke")

    pf = reader.prefetch_to_device(gen(), device="cpu")
    assert next(pf)["x"].shape == (2,)
    with pytest.raises(Boom, match="the reader broke"):
        next(pf)
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)


def test_close_early_break_and_gc_stop_the_thread():
    def endless():
        while True:
            yield {"x": np.zeros(8, np.float32)}

    with reader.prefetch_to_device(endless(), size=2, device="cpu") as pf:
        next(pf)
        thread = pf._thread
    assert not thread.is_alive() and pf._q.empty()
    pf = reader.prefetch_to_device(endless(), size=2, device="cpu")
    for _ in pf:
        break
    thread = pf._thread
    del pf
    gc.collect()
    thread.join(5)
    assert not thread.is_alive()
    names = [t.name for t in threading.enumerate()]
    assert "paddle_tpu_torch-device-prefetch" not in names


def test_row_shard_cuts_this_ranks_rows():
    """With a RowShard each array keeps rank r's rows (marked for the
    executor); a batch the world does not divide goes whole, unmarked."""
    shard = prefetcher.RowShard(1, 2)
    b = reader.device_put_batch({"x": np.arange(8.0).reshape(4, 2),
                                 "odd": np.arange(3.0)}, sharding=shard,
                                device="cpu")
    np.testing.assert_array_equal(b["x"].numpy(), [[4, 5], [6, 7]])
    assert reader.rows_of(b["x"]) == (1, 2)
    assert b["odd"].shape == (3,) and reader.rows_of(b["odd"]) is None
    t = torch.arange(6.0).reshape(6, 1)
    got = reader.device_put_batch(t, sharding={None: shard}, device="cpu")
    np.testing.assert_array_equal(got.numpy().ravel(), [3, 4, 5])
    assert not reader.is_donatable(got) and reader.rows_of(got) == (1, 2)


def _mlp():
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        x = fluid.layers.data("x", shape=[3], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, size=5, act="relu")
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.fc(h, size=3), y))
        fluid.optimizer.AdamOptimizer(0.01).minimize(loss)
    return main, startup, loss


def _feeds():
    r = np.random.RandomState(0)
    return [{"x": r.rand(8, 3).astype(np.float32),
             "y": r.randint(0, 3, (8, 1)).astype(np.int64)}
            for _ in range(4)]


@pytest.mark.parametrize("graphs", [False, True])
def test_executor_fed_by_prefetcher_equals_hand_fed(graphs):
    """The same steps fed by hand and by the prefetcher: equal losses and
    state. Through the graph path (captured on the second run, then
    replayed over static feed buffers) no static feed buffer shares
    memory with a prefetched tensor."""
    runner = (lambda body: body()) if graphs else None
    out = {}
    for how in ("hand", "prefetch"):
        main, startup, loss = _mlp()
        exe = fluid.Executor(fluid.CPUPlace(), graph_runner=runner)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        feeds = _feeds()
        seen = []
        if how == "prefetch":
            feeds = reader.prefetch_to_device(iter(feeds), device="cpu")
        losses = []
        for f in feeds:
            seen.extend(v for v in f.values() if isinstance(v,
                                                            torch.Tensor))
            losses.append(exe.run(main, feed=f, fetch_list=[loss],
                                  scope=scope)[0].item())
        out[how] = (losses, {v.name: scope.find_var(v.name).clone()
                             for v in main.list_vars() if v.persistable})
        if graphs:
            step = exe.last_entry._step
            assert step.phase == "captured"
            static = {b.untyped_storage().data_ptr()
                      for b in step.feeds.values()}
            assert not static & {t.untyped_storage().data_ptr()
                                 for t in seen}
    assert out["hand"][0] == out["prefetch"][0]
    for n, v in out["hand"][1].items():
        assert torch.equal(v, out["prefetch"][1][n]), n
