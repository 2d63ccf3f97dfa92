"""Launcher: one process per rank on this machine (counterpart:
`paddle_tpu/distributed/launch.py`, its core).

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        [--started_port 6170] [--backend nccl|gloo] [--log_dir D] \\
        [--num_pods K] train.py [args...]

The reference starts one process per host, which drives every local chip
over the mesh. The port starts one process per rank, each with the same
``PADDLE_*`` contract (`_worker_env`: ``PADDLE_TRAINER_ID``,
``PADDLE_CURRENT_ENDPOINT``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_RESTART_NUM``) plus
``FLAGS_selected_gpus`` (the rank's card: its rank modulo the card
count, so ranks share a card when there are fewer cards than ranks) and
``PADDLE_DISTRI_BACKEND`` when `--backend` names one. NCCL needs a card
per rank; ranks that share a card run over gloo. `--num_pods K` (else the
``PADDLE_NUM_PODS`` env) cuts the ranks into K pods of contiguous ranks
and gives each worker ``PADDLE_NUM_PODS`` and its ``PADDLE_POD_ID``,
which make its data-parallel world the hybrid (dcn, ici) mesh
(`parallel/env.py dcn_replicas`); a count that does not divide the
ranks warns and runs flat (`_launch_num_pods`).

Supervision fails fast: the first worker that exits non-zero stops the
rest, and the launcher exits with its code (a signal death as 128 +
signal). SIGINT and SIGTERM stop the cohort. Tensor-parallel degrees,
elastic restarts and the hang watch are not ported (ROADMAP Queue 1
#10): their options raise.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time


def free_port_base(n):
    """A port p such that p .. p + n - 1 are free on 127.0.0.1 now."""
    for _ in range(64):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n > 65535:
            continue
        try:
            for port in range(base, base + n):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", port))
        except OSError:
            continue
        return base
    raise RuntimeError("no %d consecutive free ports found" % n)


def _parse_args(argv):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="ranks to start (default: the card count, 1 "
                        "without a card)")
    p.add_argument("--started_port", type=int, default=6170,
                   help="rank r's endpoint is 127.0.0.1:started_port + r; "
                        "the rendezvous is on rank 0's")
    p.add_argument("--backend", choices=("auto", "nccl", "gloo"),
                   default="auto",
                   help="the workers' process-group backend (auto: NCCL "
                        "where a card is, else gloo)")
    p.add_argument("--log_dir", type=str, default=None,
                   help="write rank r's output to <log_dir>/workerlog.r")
    p.add_argument("--num_pods", type=int, default=0,
                   help="cut the ranks into this many pods of contiguous "
                        "ranks (0: the PADDLE_NUM_PODS env, else flat); "
                        "a count that does not divide them runs flat")
    p.add_argument("--mp_degree", type=int, default=0)
    p.add_argument("--min_ranks", type=int, default=0)
    p.add_argument("--hang_timeout", type=float, default=None)
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    for opt, unported in (("--mp_degree", args.mp_degree > 1),
                          ("--min_ranks", args.min_ranks > 0),
                          ("--hang_timeout", args.hang_timeout)):
        if unported:
            raise NotImplementedError(
                "%s is not ported yet (ROADMAP Queue 1 #10)" % opt)
    return args


def _launch_num_pods(args, world):
    """The pods of a cohort of `world` ranks: `--num_pods`, else the
    ``PADDLE_NUM_PODS`` env, else 1 (flat). A count that does not divide
    the world cannot make pods of one size: it warns and runs flat."""
    npods = args.num_pods
    if not npods:
        try:
            npods = int(os.environ.get("PADDLE_NUM_PODS", "1") or 1)
        except ValueError:
            npods = 1
    if npods <= 1:
        return 1
    if world % npods:
        sys.stderr.write(
            "paddle_tpu_torch.launch: %d rank(s) not divisible into %d "
            "pods; running a flat (single-pod) world\n" % (world, npods))
        return 1
    return npods


def _worker_env(endpoints, tid, restart_no, base_env=None, backend=None,
                ndev=None, npods=1):
    """The ``PADDLE_*`` contract for worker `tid` of `endpoints`, over
    `base_env` (default: this process's environment); with `npods` > 1
    the pod topology (``PADDLE_NUM_PODS``, ``PADDLE_POD_ID``: contiguous
    blocks of ranks), which a flat cohort pops so an inherited one does
    not leak in."""
    env = dict(os.environ if base_env is None else base_env)
    # the workers agree on the checkpoint step to restore across ranks
    # (fluid.checkpoint.load_checkpoint, ShardedCheckpointManager.restore);
    # PADDLE_CKPT_AGREE=0 in the launcher's environment opts out
    env.setdefault("PADDLE_CKPT_AGREE", "1")
    env.update({
        "PADDLE_TRAINER_ID": str(tid),
        "PADDLE_CURRENT_ENDPOINT": endpoints[tid],
        "PADDLE_TRAINERS_NUM": str(len(endpoints)),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
        "PADDLE_RESTART_NUM": str(restart_no),
    })
    if ndev is None:
        import torch

        ndev = torch.cuda.device_count()
    env["FLAGS_selected_gpus"] = str(tid % max(int(ndev), 1))
    if backend and backend != "auto":
        env["PADDLE_DISTRI_BACKEND"] = backend
    else:
        env.pop("PADDLE_DISTRI_BACKEND", None)
    if npods > 1:
        env.update({"PADDLE_NUM_PODS": str(npods),
                    "PADDLE_POD_ID": str(tid // (len(endpoints) // npods))})
    else:
        env.pop("PADDLE_NUM_PODS", None)
        env.pop("PADDLE_POD_ID", None)
    return env


def _spawn_cohort(args, endpoints, local_ids, restart_no):
    procs, logs = [], []
    npods = _launch_num_pods(args, len(endpoints))
    for tid in local_ids:
        env = _worker_env(endpoints, tid, restart_no, backend=args.backend,
                          npods=npods)
        cmd = [sys.executable, "-u", args.training_script] \
            + args.training_script_args
        out = None
        if args.log_dir:
            out = open(os.path.join(args.log_dir, "workerlog.%d" % tid), "w")
        logs.append(out)
        procs.append(subprocess.Popen(cmd, env=env, stdout=out,
                                      stderr=subprocess.STDOUT
                                      if out else None))
    return procs, logs


def _terminate_all(procs, grace_s=10.0):
    for p in procs:
        if p.poll() is None:
            try:
                p.terminate()
            except OSError:
                pass
    deadline = time.monotonic() + grace_s
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def _supervise(procs, local_ids, stop_sig):
    """Poll until every worker exits or one fails. Returns the first
    non-zero return code (the lowest trainer id among the failures of the
    poll that saw one), 0 when all finished."""
    while True:
        if stop_sig["sig"] is not None:
            _terminate_all(procs)
            return 128 + stop_sig["sig"]
        failed = [(tid, p.returncode) for tid, p in zip(local_ids, procs)
                  if p.poll() is not None and p.returncode != 0]
        if failed:
            bad_tid, bad_rc = failed[0]
            if bad_rc < 0:
                bad_rc = 128 - bad_rc
            sys.stderr.write("paddle_tpu_torch.launch: worker %d exited "
                             "with %d; terminating cohort\n"
                             % (bad_tid, bad_rc))
            _terminate_all(procs)
            return bad_rc
        if all(p.poll() is not None for p in procs):
            return 0
        time.sleep(0.1)


def launch(argv=None):
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    n = args.nproc_per_node
    if n is None:
        import torch

        n = torch.cuda.device_count() or 1
    endpoints = ["127.0.0.1:%d" % (args.started_port + i) for i in range(n)]
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    stop_sig = {"sig": None}
    live = []

    def _sig(signum, frame):
        stop_sig["sig"] = signum
        for p in live:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    procs, logs = _spawn_cohort(args, endpoints, list(range(n)), 0)
    live[:] = procs
    try:
        rc = _supervise(procs, list(range(n)), stop_sig)
    finally:
        _terminate_all(procs)
        for f in logs:
            if f:
                f.close()
    sys.exit(rc)


if __name__ == "__main__":
    launch()
