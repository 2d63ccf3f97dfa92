"""Op coverage of the port: which of the JAX package's op types
`paddle_tpu_torch.ops` registers, and which it does not yet, by the
reference file that registers them.

Both registries are read in one process (the JAX package is imported for
its registry only, on the CPU). Prints one line a reference file with
its ported and missing counts and the missing types, then the totals;
with --json, one JSON object instead. tests/test_torch_math_ops.py pins
the port's set as a subset of the reference's and its size.

Usage: python tools/port_op_coverage.py [--json]
"""
from __future__ import annotations

import json
import os
import sys
from collections import defaultdict

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def coverage():
    """{"files": {reference module file: {"ported": n, "missing":
    [types]}}, "ported": n, "reference": n, "extra": [types the port
    registers that the reference does not]}."""
    import paddle_tpu.ops  # noqa: F401  (registers every op type)
    import paddle_tpu_torch.ops  # noqa: F401
    from paddle_tpu.ops import registry as rreg
    from paddle_tpu_torch.ops import registry as treg

    ref = set(rreg.registered_ops())
    port = set(treg.registered_ops())
    files = defaultdict(lambda: {"ported": 0, "missing": []})
    for t in sorted(ref):
        mod = rreg.get_op(t).compute.__module__
        f = files[mod.replace(".", "/") + ".py"]
        if t in port:
            f["ported"] += 1
        else:
            f["missing"].append(t)
    return {"files": dict(sorted(files.items())), "ported": len(port & ref),
            "reference": len(ref), "extra": sorted(port - ref)}


def main(argv):
    cov = coverage()
    if "--json" in argv:
        print(json.dumps(cov))
        return 0
    for path, f in cov["files"].items():
        print("%-48s ported %3d  missing %3d  %s" % (
            path, f["ported"], len(f["missing"]), " ".join(f["missing"])))
    print("ported %d of %d reference op types; extra: %s"
          % (cov["ported"], cov["reference"], cov["extra"] or "none"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
