#!/usr/bin/env python3
"""The flash kernels of two checkouts timed in turns on one NVIDIA GPU.

    python3 tools/torch_kernel_pair.py --parent DIR [--rounds N]

Runs `chip_smoke.py`'s flash phase (phase 5: the six flash cases, each
kernel's median event-timed ms) in the checkout DIR (a copy of the
parent commit, e.g. ``git archive HEAD^ | tar -x -C DIR``) and in this
one, in the order parent, change, change, parent (N rounds of it,
default 1), each in a fresh process from that checkout's root after both
built their kernels. Prints one JSON line a run ({"tree", "run", "ms":
{case: {kernel: ms}}}) and then the card's name and power limit: compare
two versions only within one such call.
"""
import argparse
import json
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RUN = ("import sys, json, torch; sys.path.insert(0, '.'); "
        "import chip_smoke as c; {body}")
_BUILD = _RUN.format(body="c.phase_build()")
_TIME = _RUN.format(body=(
    "r = c.phase_flash_cases(torch, c.Timer(torch)); "
    "print('PAIR ' + json.dumps({n: {k: v['ms'] for k, v in "
    "x['kernels'].items()} for n, x in r.items()}))"))


def _python(tree, code):
    out = subprocess.run([sys.executable, "-c", code], cwd=tree, check=True,
                         capture_output=True, text=True).stdout
    return [line[5:] for line in out.splitlines() if line.startswith("PAIR ")]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    trees = {"parent": os.path.abspath(args.parent), "change": _HERE}
    for tree in trees.values():
        _python(tree, _BUILD)
    n = 0
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            n += 1
            (ms,) = _python(trees[name], _TIME)
            print(json.dumps({"tree": name, "run": n,
                              "ms": json.loads(ms)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
