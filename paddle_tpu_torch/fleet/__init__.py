"""Fleet — the unified distributed training API, collective mode
(counterpart: `paddle_tpu/fleet/__init__.py`; reference:
`python/paddle/fleet/base/fleet_base.py:25-233` and
`python/paddle/fluid/incubate/fleet/collective/__init__.py:64-468`):

    fleet.init(is_collective=True)
    opt = fleet.distributed_optimizer(opt, strategy)
    opt.minimize(loss); exe.run(...)

`minimize` runs the inner optimizer's backward and update build, then
the collective transpiler (`transpile_collective`, reference:
transpiler/collective.py:178-268): the program is marked data-parallel,
the backward's loss cotangent is scaled by 1/nranks, and one in-place
`c_allreduce_sum` per gradient follows the backward. The executor runs
such a program as one rank of the `torch.distributed` world that
`fleet.init` joins (`distributed.init_parallel_env`). The
parameter-server, auto-parallel, DGC, LocalSGD, hierarchical-allreduce
and elastic paths are not ported (ROADMAP Queue 1 #10) and raise, as do
`save_persistables` and `save_inference_model` (Queue 1 #8a).
"""
from __future__ import annotations

from ..fluid.framework import Operator
from ..parallel import env as penv
from .role_maker import (  # noqa: F401
    RoleMakerBase, PaddleCloudRoleMaker, UserDefinedRoleMaker, Role,
)
from . import metrics  # noqa: F401  (fleet.metrics.* helpers)
from . import util  # noqa: F401  (fleet.util collective helpers)


class DistributedStrategy:
    """Strategy knobs (reference: `framework/distributed_strategy.proto:25`
    backing `fleet/base/distributed_strategy.py:57`), saved and loaded
    in protobuf text format. `minimize` reads `sync_batch_norm` and
    `amp`; the knobs whose path is not ported raise there (see
    `CollectiveOptimizer.minimize`), and the GPU tuning knobs
    (fuse_all_reduce_ops, nccl_comm_num, ...) are accepted and unread."""

    def __init__(self):
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.pipeline = False
        self.pipeline_configs = {"micro_batch": 1}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1}
        self.dgc = False
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.lars = False
        self.lamb = False
        self.sync_nccl_allreduce = True
        self.nccl_comm_num = 1
        self.use_hierarchical_allreduce = False
        self.hierarchical_allreduce_inter_nranks = 1
        self.sync_batch_norm = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.elastic = False
        self.elastic_configs = {"checkpoint_dir": "", "save_steps": 100,
                                "max_checkpoints": 3}
        self.auto = False
        self.auto_configs = {}
        self.a_sync = False
        self.a_sync_configs = {}

    # fluid-era aliases (incubate DistributedStrategy fields)
    @property
    def forward_recompute(self):
        return self.recompute

    @forward_recompute.setter
    def forward_recompute(self, v):
        self.recompute = v

    # -- serialization (reference: distributed_strategy.proto text
    # format via save_to_prototxt/load_from_prototxt,
    # fleet/base/distributed_strategy.py:57) ----------------------------
    def _fields(self):
        return {k: v for k, v in vars(self).items()
                if not k.startswith("_")}

    @staticmethod
    def _proto_scalar(v):
        """One scalar in protobuf TEXT format (lowercase bools,
        double-quoted strings with C escapes, plain numbers) — the
        format the reference's protobuf-backed strategy writes
        (distributed_strategy.proto:25-81)."""
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, str):
            return '"%s"' % (v.replace("\\", "\\\\").replace('"', '\\"')
                             .replace("\n", "\\n"))
        return repr(v)

    def save_to_prototxt(self, path):
        """Real protobuf text format: scalar knobs as `name: value`,
        lists as REPEATED `name: value` lines, config dicts as nested
        `name { ... }` blocks. A prototxt written here parses with
        protobuf's own text_format against the reference's
        DistributedStrategy message field set, and vice versa."""
        lines = []
        for k, v in sorted(self._fields().items()):
            if isinstance(v, dict):
                lines.append("%s {" % k)
                for ck, cv in sorted(v.items()):
                    if isinstance(cv, (list, tuple)):
                        for item in cv:
                            lines.append("  %s: %s"
                                         % (ck, self._proto_scalar(item)))
                    else:
                        lines.append("  %s: %s"
                                     % (ck, self._proto_scalar(cv)))
                lines.append("}")
            elif isinstance(v, (list, tuple)):
                for item in v:
                    lines.append("%s: %s" % (k, self._proto_scalar(item)))
            else:
                lines.append("%s: %s" % (k, self._proto_scalar(v)))
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")

    @staticmethod
    def _parse_scalar(tok):
        """Protobuf text scalar -> python; legacy round-2 files wrote
        Python reprs (True, 'str'), still accepted as a fallback."""
        import ast as _ast

        tok = tok.strip()
        if tok == "true":
            return True
        if tok == "false":
            return False
        if tok.startswith('"') and tok.endswith('"'):
            body = tok[1:-1]
            # left-to-right unescape: replace-chains corrupt strings
            # holding a literal backslash before 'n' (code-review r4)
            out, i = [], 0
            esc = {"n": "\n", '"': '"', "\\": "\\", "t": "\t"}
            while i < len(body):
                if body[i] == "\\" and i + 1 < len(body):
                    out.append(esc.get(body[i + 1],
                                       "\\" + body[i + 1]))
                    i += 2
                else:
                    out.append(body[i])
                    i += 1
            return "".join(out)
        try:
            return _ast.literal_eval(tok)
        except (ValueError, SyntaxError):
            return tok  # bare enum-style token

    def load_from_prototxt(self, path):
        with open(path) as f:
            lines = [ln.rstrip() for ln in f
                     if ln.strip() and not ln.strip().startswith("#")]
        i = 0
        seen_scalars = set()
        while i < len(lines):
            ln = lines[i].strip()
            if ln.endswith("{"):
                name = ln[:-1].strip()
                # merge into the default config dict: keys absent from
                # the file keep their defaults (proto unset-field
                # semantics), and a key whose DEFAULT is a list stays a
                # list even with one occurrence (repeated field)
                base = getattr(self, name, None)
                block = dict(base) if isinstance(base, dict) else {}
                repeated = {k for k, v in block.items()
                            if isinstance(v, list)}
                seen_block = set()
                i += 1
                while i < len(lines) and lines[i].strip() != "}":
                    ck, cv = lines[i].strip().split(":", 1)
                    ck = ck.strip()
                    val = self._parse_scalar(cv)
                    if ck in seen_block:
                        prev = block[ck]
                        block[ck] = (prev if isinstance(prev, list)
                                     else [prev]) + [val]
                    else:
                        # legacy repr files already encode lists as one
                        # token; never double-wrap them
                        block[ck] = (val if isinstance(val, list)
                                     else [val] if ck in repeated
                                     else val)
                        seen_block.add(ck)
                    i += 1
                setattr(self, name, block)
            else:
                k, v = ln.split(":", 1)
                k = k.strip()
                val = self._parse_scalar(v)
                if k in seen_scalars:
                    prev = getattr(self, k)
                    setattr(self, k, (prev if isinstance(prev, list)
                                      else [prev]) + [val])
                elif isinstance(getattr(self, k, None), list):
                    setattr(self, k,
                            val if isinstance(val, list) else [val])
                    seen_scalars.add(k)
                else:
                    setattr(self, k, val)
                    seen_scalars.add(k)
            i += 1
        return self




def _not_ported(what, item):
    raise NotImplementedError("%s is not ported yet (ROADMAP Queue 1 %s)"
                              % (what, item))


class _Fleet:
    def __init__(self):
        self._role_maker = None
        self._is_collective = False
        self._inited = False
        self._strategy = None

    # -- init / topology ---------------------------------------------------
    def init(self, role_maker=None, is_collective=True):
        """Take the topology from `role_maker` (default: the ``PADDLE_*``
        env) and, with more than one worker, join the world
        (`distributed.init_parallel_env`). Only collective mode is
        ported."""
        if not is_collective:
            _not_ported("fleet.init(is_collective=False) (parameter "
                        "servers)", "#10")
        self._role_maker = role_maker or PaddleCloudRoleMaker(
            is_collective=is_collective)
        self._is_collective = is_collective
        self._inited = True
        util._util._set_role_maker(self._role_maker)
        if self.worker_num() > 1:
            from ..distributed import init_parallel_env

            init_parallel_env()
        return self

    def is_first_worker(self):
        return self.worker_index() == 0

    def worker_index(self):
        return self._role_maker.worker_index() if self._role_maker else 0

    def worker_num(self):
        return self._role_maker.worker_num() if self._role_maker else 1

    def is_worker(self):
        if self._role_maker is not None:
            return self._role_maker.is_worker()
        return True

    def worker_endpoints(self, to_string=False):
        eps = penv.trainer_endpoints()
        return ",".join(eps) if to_string else eps

    def is_server(self):
        return False

    def server_num(self):
        return 0

    def barrier_worker(self):
        from ..distributed import barrier

        barrier()

    def stop_worker(self):
        pass

    # -- optimizer ---------------------------------------------------------
    def distributed_optimizer(self, optimizer, strategy=None):
        self._strategy = strategy or DistributedStrategy()
        util._util._set_strategy(self._strategy)
        return CollectiveOptimizer(optimizer, self._strategy)

    # -- not ported --------------------------------------------------------
    def save_inference_model(self, *a, **k):
        _not_ported("fleet.save_inference_model (fluid io)", "#8a")

    def save_persistables(self, *a, **k):
        _not_ported("fleet.save_persistables (fluid io)", "#8a")

    def init_worker(self, *a, **k):
        _not_ported("fleet.init_worker (parameter servers)", "#10")

    def init_server(self, *a, **k):
        _not_ported("fleet.init_server (parameter servers)", "#10")

    def run_server(self, *a, **k):
        _not_ported("fleet.run_server (parameter servers)", "#10")


fleet = _Fleet()

# module-level 2.0-style API
init = fleet.init
distributed_optimizer = fleet.distributed_optimizer
worker_index = fleet.worker_index
worker_num = fleet.worker_num
is_first_worker = fleet.is_first_worker

#: strategy knobs whose path is not ported, -> the ROADMAP item
_UNPORTED_KNOBS = (("a_sync", "#10"), ("auto", "#10"), ("dgc", "#10"),
                   ("localsgd", "#10"), ("use_hierarchical_allreduce", "#10"),
                   ("elastic", "#10"))


class CollectiveOptimizer:
    """Reference: CollectiveOptimizer (incubate/fleet/collective:393) +
    GradAllReduce transpiler (transpiler/collective.py:178)."""

    def __init__(self, optimizer, strategy=None):
        self._optimizer = optimizer
        self._strategy = strategy or DistributedStrategy()

    def __getattr__(self, item):
        return getattr(self._optimizer, item)

    def backward(self, *a, **k):
        return self._optimizer.backward(*a, **k)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """The inner optimizer's `minimize` (through the strategy's
        meta-optimizers), then `transpile_collective` over the world
        (nothing at one worker)."""
        from .meta_optimizers import compose

        st = self._strategy
        for knob, item in _UNPORTED_KNOBS:
            if getattr(st, knob, False):
                _not_ported("DistributedStrategy.%s" % knob, item)
        inner, self._applied_meta_list = compose(st, self._optimizer)
        optimize_ops, params_grads = inner.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        transpile_collective(loss.block.program,
                             sync_batch_norm=getattr(st, "sync_batch_norm",
                                                     False))
        return optimize_ops, params_grads


def transpile_collective(program, nranks=None, k_steps_localsgd=0,
                         dgc_cfg=None, sync_batch_norm=False):
    """The GradAllReduce rewrite (reference: transpiler/collective.py:
    178-268) for a world of `nranks` (default: the world's size). At one
    rank the program is returned unchanged. Otherwise it is marked
    data-parallel, `sync_batch_norm` turns every batch_norm into
    sync_batch_norm over the dp ring, the backward's loss cotangent is
    scaled by 1/nranks, and one in-place `c_allreduce_sum` per gradient
    follows the backward."""
    if k_steps_localsgd:
        _not_ported("LocalSGD", "#10")
    if dgc_cfg is not None:
        _not_ported("DGC", "#10")
    if nranks is None:
        nranks = penv.world_size()
    if nranks <= 1:
        return program
    program._dp_axis = "dp"
    program._data_parallel = True

    if sync_batch_norm:
        n_swapped = 0
        for bi in range(program.num_blocks):
            for op in program.block(bi).ops:
                if op.type == "batch_norm":
                    op.type = "sync_batch_norm"
                    op.attrs["axis_name"] = program._dp_axis
                    n_swapped += 1
        if n_swapped:
            program._version += 1

    block = program.global_block()
    bwd_idx = next((i for i, op in enumerate(block.ops)
                    if op.type == "backward"), None)
    if bwd_idx is None:
        return program
    bop = block.ops[bwd_idx]
    # loss-grad scaling (reference: transpiler/collective.py:190)
    bop.attrs["loss_scale"] = bop.attrs.get("loss_scale", 1.0) / nranks
    ar_ops = [Operator(block, "c_allreduce_sum", inputs={"X": [g]},
                       outputs={"Out": [g]},
                       attrs={"ring_id": 0, "use_calc_stream": True})
              for g in bop.output_names.get("Grad", [])]
    block.ops[bwd_idx + 1:bwd_idx + 1] = ar_ops
    program._version += 1
    return program
