#!/usr/bin/env python3
"""The benchmark's one command, run from the root of a checkout:

    python3 stark_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``harness.py``.  Exits non-zero, printing no result, without a card,
with fewer cards than the cell asks for, where the measured package is
absent, or where the process has loaded JAX or the JAX package."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
