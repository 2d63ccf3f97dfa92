"""CompiledProgram (counterpart: `paddle_tpu/fluid/compiler.py`;
reference: `python/paddle/fluid/compiler.py:87-310`).

`with_data_parallel` marks the program data-parallel: the executor runs
it as this process's rank of the `torch.distributed` world (one process
per device, `distributed.launch`), splits each fed global batch along
axis 0, averages every gradient over the ranks (one all-reduce each,
the reference's AllReduceOpHandles, or the sharded update's
reduce-scatters) and gathers fetches. Where more than one pod is asked
for (``FLAGS_tpu_dcn_replicas``, ``PADDLE_NUM_PODS``) and a world is up,
the program's world becomes the hybrid (dcn, ici) mesh here, as the
reference's compile path makes it (`parallel/env.py program_ring`). The
build and execution strategies are accepted for the API; none of their
knobs changes what runs.
"""
from __future__ import annotations

from ..parallel import env as penv


class BuildStrategy:
    """Accepted for API compatibility."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.memory_optimize = None
        self.enable_inplace = None
        self.fuse_all_reduce_ops = None
        self.fuse_all_optimizer_ops = None
        self.fuse_elewise_add_act_ops = False
        self.fuse_bn_act_ops = False
        self.nccl_comm_num = 1
        self.num_trainers = 1
        self.trainer_id = 0
        self.use_hierarchical_allreduce = False
        self.hierarchical_allreduce_inter_nranks = 0
        self.sync_batch_norm = False
        self.enable_sequential_execution = False
        self.remove_unnecessary_lock = True


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.num_iteration_per_run = 1
        self.use_thread_barrier = False


class CompiledProgram:
    """A Program with its build strategy; `Executor.run` takes it in
    place of the program."""

    def __init__(self, program_or_graph, build_strategy=None):
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._is_data_parallel = False

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        """Mark the program data-parallel over the world. One process
        drives one device: `places`, if given, must be this process's
        place alone."""
        if places is not None and len(places) != 1:
            raise NotImplementedError(
                "with_data_parallel(places=%d places): the port runs one "
                "process per device; start one process a rank with "
                "paddle_tpu_torch.distributed.launch" % len(places))
        self._is_data_parallel = True
        if build_strategy is not None:
            self._build_strategy = build_strategy
        self._program._data_parallel = True
        penv.program_ring(self._program)
        return self

    def with_inference_optimize(self, config):
        return self

    def _unwrap(self):
        return self._program
