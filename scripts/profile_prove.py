#!/usr/bin/env python3
"""Where the device time of one warm prove goes, on one GPU.

    python3 scripts/profile_prove.py [--sharded] [fib|bf|hello|fib_rpo|hello_rpo|rescue ...]

For each workload (default: all three) it proves once cold and twice warm,
then runs one more warm prove under ``torch.profiler`` (CPU and CUDA
activities) and prints one JSON line: the wall time of the profiled prove,
the device busy time (the union of the device events' intervals) and its
share of the wall, the device time per kernel name (top 15, summed over
launches), every hand-written kernel's device time and launches, the
hand-written kernels' share of the device time, and each phase's device
ms (CUDA events, profiler running).  The
workloads are chip_smoke.py's own (``chip_smoke.workload``): fib at 2^24
values (bench.py's options), ``programs/fibonacci.bf`` cut to ten numbers
(2^20 rows) and ``programs/hello_world.bf``, both with the 96-bit options,
and the same fib and hello_world with RPO-256 trees and coin (``fib_rpo``,
``hello_rpo``), and the Rescue hash chain of 2^14 links (2^18 rows,
``rescue``); these three are not in the default set.  With
``--sharded`` each workload is proved by ``parallel.prover.prove_sharded``
at NCCL world size 1 in this process (every sharded phase and its
collectives, each an identity).  Needs a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# symbols of the hand-written kernels (csrc/*.cu and the generated evaluator)
OWN_KERNELS = ("inv_fp_kernel", "inv_ext3_kernel", "col_ntt_kernel",
               "col_ntt_pass_kernel", "transpose_kernel", "hash_rows_kernel",
               "merge_kernel", "ms_eval_", "deep_kernel", "ood_kernel",
               "ood_reduce_kernel", "grind_kernel", "tree_tops_kernel",
               "coin_sha_kernel", "coin_rpo_kernel")


def busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in ms (from us)."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def profile(torch, name, mesh=None) -> dict:
    from torch.profiler import ProfilerActivity, profile as tprofile

    from chip_smoke import workload
    from ministark_tpu_torch.parallel.prover import prove_sharded

    claim, trace, opts, _info = workload(name)

    def prove(phases=None):
        if mesh is None:
            return claim.prove(opts, trace, phases)
        return prove_sharded(claim, opts, trace, mesh, phase_log=phases)

    for _ in range(3):
        prove()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        phases: list = []
        t0 = time.perf_counter()
        prove(phases)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type.name == "CUDA"]
    intervals = [(e.time_range.start, e.time_range.end) for e in dev]
    per_kernel: dict = {}
    for e in dev:
        k = per_kernel.setdefault(e.name, [0.0, 0])
        k[0] += (e.time_range.end - e.time_range.start) / 1e3
        k[1] += 1
    device_ms = sum(v[0] for v in per_kernel.values())
    own_ms = sum(v[0] for k, v in per_kernel.items()
                 if any(s in k for s in OWN_KERNELS))
    busy = busy_ms(intervals)
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    return {"workload": name, "sharded": mesh is not None,
            "wall_ms": wall_ms, "device_busy_ms": busy,
            "busy_share": busy / wall_ms, "device_events": len(dev),
            "device_ms_summed": device_ms,
            "own_kernels_share": own_ms / device_ms if device_ms else None,
            "phase_device_ms": {p["phase"]: p["device_ms"] for p in phases},
            "top": [{"name": k[:90], "ms": v[0], "launches": v[1]}
                    for k, v in ranked[:15]],
            "own": [{"name": k[:90], "ms": v[0], "launches": v[1]}
                    for k, v in ranked if any(s in k for s in OWN_KERNELS)]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_prove: needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    args = sys.argv[1:]
    mesh = None
    if "--sharded" in args:
        import tempfile

        from ministark_tpu_torch.parallel.sharded import make_mesh

        args.remove("--sharded")
        store = tempfile.mkdtemp(prefix="profile_prove_")
        mesh = make_mesh("nccl", init_method=f"file://{store}/nccl", rank=0,
                         world_size=1)
    for name in args or ["fib", "bf", "hello"]:
        print(json.dumps({"card": card, **profile(torch, name, mesh)}),
              flush=True)
        torch.cuda.empty_cache()
    if mesh is not None:
        import shutil

        import torch.distributed as dist

        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
