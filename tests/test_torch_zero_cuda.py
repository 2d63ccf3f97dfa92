"""The sharded weight update and the device prefetcher on the card. Every
test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_zero_cuda.py

- 2 gloo ranks sharing the card (`distributed.spawn`; NCCL needs a card
  a rank) run the 31-wide Adam MLP with L2 decay and fused ops of
  tests/test_torch_sharded_update.py, and the Momentum one, with the
  sharded update on (buckets), on with a cap of 0 and off, each from
  the same start state: losses and every persistable at its logical
  shape bit-equal, the moments held as 1/2 slices on the card.
- The prefetcher's copy (a pinned host buffer, a side stream, an event
  the consumer's stream waits on) equals a plain ``.to("cuda")``, batch
  by batch, with a rank's rows cut as `feed_sharding` asks; a captured
  executor step fed by the prefetcher (its producer thread copying
  while the step is captured and replayed) equals one fed by hand bit
  for bit.
"""
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch import distributed, fluid, reader

import torch_dp_runner as runner

pytestmark = pytest.mark.cuda

CASES = ("adam_reg_fused", "momentum")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def zero_card_worker(d):
    """One rank: each of `CASES` with the sharded update on, on with a
    cap of 0 and off, from the first run's start state; writes the
    losses, the logical state and the bytes of the sharded vars the scope
    holds."""
    from paddle_tpu_torch.core.types import to_numpy

    rank = distributed.get_rank()
    out = {}
    for case in CASES:
        start = None
        for variant, (flag, cap) in runner.ZERO_VARIANTS.items():
            fluid.set_flags({"FLAGS_tpu_sharded_weight_update": flag,
                             "FLAGS_tpu_comm_bucket_mb": cap})
            main, startup, loss = runner.build_zero_mlp(
                fluid, **runner.ZERO_MLPS[case])
            exe = fluid.Executor()
            scope = fluid.Scope()
            exe.run(startup, scope=scope)
            names = sorted(v.name for v in main.list_vars()
                           if v.persistable)
            if start is None:
                start = {n: scope.find_var(n).clone() for n in names}
            for n in names:
                scope.set_var(n, start[n].clone())
            prog = fluid.CompiledProgram(main).with_data_parallel()
            key = "%s.%s." % (case, variant)
            out[key + "losses"] = np.stack([exe.run(
                prog, feed=runner.zero_mlp_feed(), fetch_list=[loss],
                scope=scope)[0] for _ in range(runner.ZERO_STEPS)])
            for n in names:
                out[key + "state." + n] = to_numpy(
                    exe.read_logical(n, main, scope))
            plan = main._shard_plan if flag else None
            held = [scope.find_var(n) for n in (plan.sharded_state
                                                if plan else ())]
            out[key + "held_bytes"] = np.array(sum(
                t.numel() * t.element_size() for t in held))
            out[key + "on_card"] = np.array(all(
                t.device.type == "cuda" for t in held))
            out[key + "info"] = np.array(str(exe.last_entry.info()))
    fluid.set_flags({"FLAGS_tpu_sharded_weight_update": True,
                     "FLAGS_tpu_comm_bucket_mb": 25.0})
    np.savez(os.path.join(d, "zero_card.rank%d.npz" % rank), **out)


def test_zero_on_the_card_equals_replicated(card, tmp_path):
    distributed.spawn(zero_card_worker, (str(tmp_path),), nprocs=2,
                      backend="gloo", timeout=300)
    ranks = [dict(np.load(str(tmp_path / ("zero_card.rank%d.npz" % r))))
             for r in range(2)]
    for rank in ranks:
        for case in CASES:
            on = {k[len(case) + 4:]: v for k, v in rank.items()
                  if k.startswith(case + ".on.")
                  and not k.endswith(("held_bytes", "on_card", "info"))}
            assert len(on) > 3
            for other in ("off", "cap0"):
                for k, v in on.items():
                    np.testing.assert_array_equal(
                        rank["%s.%s.%s" % (case, other, k)], v,
                        err_msg="%s %s %s" % (case, other, k))
            assert bool(rank[case + ".on.on_card"])
            held = int(rank[case + ".on.held_bytes"])
            assert held > 0 and int(rank[case + ".off.held_bytes"]) == 0
            assert "'opt_state_per_replica_bytes': %d" % held in str(
                rank[case + ".on.info"])
    for k, v in ranks[0].items():
        if not k.endswith("info"):
            np.testing.assert_array_equal(ranks[1][k], v, err_msg=k)


def test_prefetch_copy_equals_plain_copy(card):
    r = np.random.RandomState(0)
    batches = [{"x": r.rand(8, 5).astype(np.float32),
                "y": r.randint(0, 9, (8, 1)).astype(np.int64)}
               for _ in range(5)]
    got = []
    with reader.prefetch_to_device(iter(batches), size=2,
                                   device=card) as pf:
        for b in pf:
            # consumed on the current stream, ordered after the copy
            got.append({k: (v * 1).cpu() for k, v in b.items()})
            assert all(v.device == card and reader.is_donatable(v)
                       for v in b.values())
    assert len(got) == 5
    for b, want in zip(got, batches):
        for k, v in want.items():
            assert torch.equal(b[k], torch.from_numpy(v).to(card).cpu())
    shard = reader.RowShard(1, 2)
    b = reader.device_put_batch(batches[0], sharding=shard, device=card)
    assert torch.equal(b["x"], torch.from_numpy(batches[0]["x"][4:]).to(
        card))
    assert reader.rows_of(b["x"]) == (1, 2)


def test_captured_step_fed_by_prefetcher_equals_hand_fed(card):
    """The graph path: the first step eager, the second captured (while
    the producer thread copies the next batches), then replays."""
    r = np.random.RandomState(1)
    feeds = [{"img": r.rand(16, 32).astype(np.float32),
              "label": r.randint(0, 4, (16, 1)).astype(np.int64)}
             for _ in range(6)]
    out = {}
    for how in ("hand", "prefetch"):
        fluid.set_flags({"FLAGS_cuda_graphs": True})
        main, startup, loss = runner.build_zero_mlp(fluid, "adam")
        exe = fluid.Executor()
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        src = iter(feeds) if how == "hand" else reader.prefetch_to_device(
            iter(feeds), size=2, device=card)
        out[how] = [exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0].item() for f in src]
        assert exe.last_entry.mode == "graph"
        assert exe.last_entry.phase == "captured"
        exe.close()
    assert out["hand"] == out["prefetch"]
