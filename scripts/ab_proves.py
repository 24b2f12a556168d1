#!/usr/bin/env python3
"""Warm proves of chip_smoke.py's five prove workloads, and its 2^29-point
LDE, from one tree, for comparing two commits on one card.

    git archive <commit> | tar -x -C DIR     # a git-ignored directory
    python3 scripts/ab_proves.py DIR parent [WORKLOAD ...]
    python3 scripts/ab_proves.py . change [WORKLOAD ...]
    python3 scripts/ab_proves.py --host-coin . host_coin [WORKLOAD ...]
    python3 scripts/ab_proves.py --proves 6 . change fib

Imports the port and chip_smoke.py from the tree at ROOT (its first
argument) and proves each of the workloads (default: ``fib``, ``bf``,
``hello``, ``fib_rpo`` and ``hello_rpo``, ``chip_smoke.workload``) three
times in a row (``--proves``: that many), the first cold (the first
prove of all builds the kernels); prints one JSON line of the seconds,
each prove's device ms of every phase (``<workload>_phases``), host clock around each
prove ending in a synchronise, each prove's "Proof of work" phase (host
ms, under ``<workload>_pow_ms``), its "DEEP composition" phase (device ms
by CUDA events, ``<workload>_deep_ms``), its "FRI" phase (device ms by
CUDA events and host ms, ``<workload>_fri_ms`` and
``<workload>_fri_host_ms``) and its peak device memory (GiB,
``<workload>_peak_gib``; ``<workload>_phase_peak_gib`` gives, for the
last prove, the peak so far at the end of each phase, so the phase that
raised it shows), tagged with its second argument.  The
workload ``rescue`` is chip_smoke.py's Rescue chain (its host chain runs
once, before the proves).  The
workload ``lde`` is chip_smoke.py's 2^29-point coset LDE of a 2^27-row
column (``Matrix.interpolate`` then ``evaluate``), timed in device ms by
CUDA events.  Run the two trees in turns in one call (parent, change,
change, parent) and compare the warm runs.  ``--host-coin`` makes the
tree's FRI commit phase keep the host coin between its layers (each root
copied to the host before the next fold, the path an RPO-256 coin over
SHA-256 trees takes) by turning ``fri.device_coin_step`` off, for trees
that have it.
"""

from __future__ import annotations

import json
import os
import sys
import time


def lde_ms(torch):
    """Device ms of three interpolate + evaluate runs of the 2^29-point
    LDE (blowup 4 over 2^27 rows, coset offset 7)."""
    from ministark_tpu_torch import ntt as tntt
    from ministark_tpu_torch.fields import device as fd
    from ministark_tpu_torch.matrix import Matrix

    n = 1 << 27
    trace_dom, lde_dom = tntt.Domain(n), tntt.Domain(4 * n, 7)
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    col = Matrix(fd.canonicalize(torch.randint(
        -(1 << 63), (1 << 63) - 1, (1, n), generator=g, device="cuda",
        dtype=torch.int64)))
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        col.interpolate(trace_dom).evaluate(lde_dom)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del col
    tntt._TABLE_CACHE.clear()
    torch.cuda.empty_cache()
    return times


def main() -> int:
    args = sys.argv[1:]
    host_coin = "--host-coin" in args
    if host_coin:
        args.remove("--host-coin")
    proves = 3
    if "--proves" in args:
        at = args.index("--proves")
        proves = int(args[at + 1])
        del args[at:at + 2]
    root, tag = os.path.abspath(args[0]), args[1]
    import torch

    if not torch.cuda.is_available():
        print("ab_proves: needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    import chip_smoke

    if host_coin:
        from ministark_tpu_torch import fri

        fri.device_coin_step = lambda coin_hash, tree_hash: None
    from ministark_tpu_torch.utils import timer

    phase_exit = timer.Timer.__exit__

    def exit_with_peak(self, *exc):
        done = phase_exit(self, *exc)
        if self.log:
            self.log[-1]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        return done

    timer.Timer.__exit__ = exit_with_peak
    out = {"tree": tag}
    names = args[2:] or ("fib", "bf", "hello", "fib_rpo", "hello_rpo")
    for name in names:
        if name == "lde":
            out["lde_ms"] = lde_ms(torch)
            continue
        claim, trace, opts, _info = chip_smoke.workload(name)
        times, pow_ms, deep_ms, peak = [], [], [], []
        fri_ms, fri_host_ms, all_phases = [], [], []
        for _ in range(proves):
            phases: list = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            claim.prove(opts, trace, phases)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            peak.append(torch.cuda.max_memory_allocated() / 2**30)
            pow_ms += [p["host_ms"] for p in phases
                       if p["phase"] == "Proof of work"]
            deep_ms += [p["device_ms"] for p in phases
                        if p["phase"] == "DEEP composition"]
            fri = [p for p in phases if p["phase"] == "FRI"]
            fri_ms += [p["device_ms"] for p in fri]
            fri_host_ms += [p["host_ms"] for p in fri]
            all_phases.append({p["phase"]: p["device_ms"] for p in phases})
        out[name] = times
        out[f"{name}_pow_ms"] = pow_ms
        out[f"{name}_deep_ms"] = deep_ms
        out[f"{name}_fri_ms"] = fri_ms
        out[f"{name}_fri_host_ms"] = fri_host_ms
        out[f"{name}_peak_gib"] = peak
        out[f"{name}_phases"] = all_phases
        out[f"{name}_phase_peak_gib"] = {p["phase"]: p["peak_gib"]
                                         for p in phases}
        del claim, trace
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
