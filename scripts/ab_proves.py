#!/usr/bin/env python3
"""Warm proves of chip_smoke.py's five prove workloads from one tree, for
comparing two commits on one card.

    git archive <commit> | tar -x -C DIR     # a git-ignored directory
    python3 scripts/ab_proves.py DIR parent
    python3 scripts/ab_proves.py . change

Imports the port and chip_smoke.py from the tree at ROOT (its first
argument) and proves each of the workloads ``fib``, ``bf``, ``hello``,
``fib_rpo`` and ``hello_rpo`` (``chip_smoke.workload``) three times in a
row, the first cold (the first prove of all builds the kernels); prints
one JSON line of the seconds, host clock around each prove ending in a
synchronise, tagged with its second argument.  Run the two trees in turns in one call (parent,
change, change, parent) and compare the warm runs.
"""

from __future__ import annotations

import json
import os
import sys
import time


def main() -> int:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    import torch

    if not torch.cuda.is_available():
        print("ab_proves: needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    import chip_smoke

    out = {"tree": tag}
    for name in ("fib", "bf", "hello", "fib_rpo", "hello_rpo"):
        claim, trace, opts, _info = chip_smoke.workload(name)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            claim.prove(opts, trace)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = times
        del claim, trace
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
