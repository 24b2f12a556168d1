#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``: a cell's run
with the measured program proving at the configuration's ``control``
options (a guarantee broken: one bit less of proof of work), the
reference keeping the configuration's.  Every such run has to come out
not correct.

    python3 stark_bench/control.py --workload <cell> --seeds 1,2,3 --seconds 5

Runs the seeds one after another in this process and prints each run's
compared numbers and its ``correct``; exits 0 when every run came out
not correct.  Needs a card, as a run does."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    options = dict(cell.config["options"], **cell.config["control"]["options"])
    failed_all = True
    for seed in args.seeds.split(","):
        r = harness.run_cell(cell, args.seconds, False, time.perf_counter(),
                             options=options)
        r.pop("_forbidden")
        r.pop("_window")
        print(json.dumps({"seed": int(seed), "control": options,
                          "correct": r["correct"], "checks": r["checks"]}),
              flush=True)
        failed_all &= not r["correct"]
        torch.cuda.empty_cache()
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
