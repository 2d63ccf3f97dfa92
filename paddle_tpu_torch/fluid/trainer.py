"""Training from a dataset (counterpart: `paddle_tpu/fluid/trainer.py`;
reference: `Executor::RunFromDataset`, `framework/executor.cc:170`, and
the double-buffered reader, `operators/reader/buffered_reader.cc`).

One prepared step a batch, fed by the device prefetcher
(`reader/prefetcher.py`): a background thread copies the next batches
to the card (a data-parallel program's rows of this rank only,
`Executor.feed_sharding`) while the card runs the current step, and the
fetches stay on the device except every `print_period` steps and at the
end. A dataset is anything with ``_iter_batches()`` yielding feed dicts
(`fluid/dataset.py` itself is ROADMAP Queue 1 #8).
"""
from __future__ import annotations

import itertools
import sys

import numpy as np


def train_from_dataset(executor, program, dataset, scope=None,
                       fetch_list=None, print_period=100,
                       queue_size=4, checkpoint_dir=None,
                       checkpoint_every_n_steps=0, checkpoint_num=3):
    """Run `program` over every batch of `dataset`; returns the last
    step's fetches as numpy arrays (None without a step or fetches).

    With `checkpoint_dir` the newest checkpoint under it is restored
    first (auto-resume after a preemption: the batches of the steps it
    holds are skipped on the host, before the prefetcher), and every
    persistable with the `TrainStatus` is saved in the background every
    `checkpoint_every_n_steps` steps and after the last step
    (`fluid/checkpoint.py`). In a data-parallel world every rank calls
    this alike."""
    if dataset is None:
        raise ValueError("dataset is required")
    from . import checkpoint as ckpt_mod
    from . import framework
    from ..reader.prefetcher import prefetch_to_device

    program = program or framework.default_main_program()
    ckpt = None
    start_step = 0
    if checkpoint_dir:
        status = ckpt_mod.load_checkpoint(executor, checkpoint_dir,
                                          program, scope=scope)
        if status is not None:
            start_step = max(status.step_no, 0)
        ckpt = ckpt_mod.AsyncCheckpointer(
            checkpoint_dir, program, checkpoint_num=checkpoint_num,
            scope=scope)

    batches = dataset._iter_batches()
    if start_step:
        batches = itertools.islice(batches, start_step, None)
    pf = prefetch_to_device(batches, size=max(int(queue_size), 1),
                            sharding=executor.feed_sharding(program),
                            device=executor.device)
    it = start_step
    results = None
    try:
        for feed in pf:
            it += 1
            results = executor.run(program, feed=feed,
                                   fetch_list=fetch_list, scope=scope,
                                   return_numpy=False)
            if print_period and fetch_list and it % print_period == 0:
                print("step %d: %s" % (it, [
                    float(np.ravel(v.value.detach().float().cpu().numpy())[0])
                    for v in results]))
            if (ckpt is not None and checkpoint_every_n_steps
                    and it % checkpoint_every_n_steps == 0):
                ckpt.save_async(ckpt_mod.TrainStatus(epoch_no=0,
                                                     step_no=it))
    finally:
        pf.close()
        if ckpt is not None:
            # a final checkpoint only where new steps ran: a resumed run
            # over a shorter dataset must not move step_no back
            if it > start_step and (not checkpoint_every_n_steps
                                    or it % checkpoint_every_n_steps):
                ckpt.save_async(ckpt_mod.TrainStatus(epoch_no=0,
                                                     step_no=it))
            # flush and raise a write error, but never over a step's
            step_error = sys.exc_info()[0] is not None
            try:
                ckpt.close()
            except Exception:  # noqa: BLE001
                if not step_error:
                    raise
    if results is not None:
        from ..core.types import to_numpy

        return [to_numpy(v.value) for v in results]
    return None
