#!/usr/bin/env python3
"""The multi-card prover over NCCL, against the one-process prove.

    python3 scripts/prove_sharded.py [workload ...]

Builds every kernel (``chip_smoke.build_kernels``), proves each workload
(chip_smoke.py's own, ``chip_smoke.workload``: fib, bf, hello, fib_big,
and over RPO-256 trees and coin fib_rpo, hello_rpo, fib_big_rpo; default
fib and hello) once cold and once warm in this process on cuda:0,
then spawns one rank a card over NCCL, rank r on cuda:r, and runs
``chip_smoke.sharded_prove`` on them: ``prove_sharded`` cold, then warm.
Every rank's bytes must equal the one-process proof's; any difference or
failure exits non-zero, and so does a prove that makes no collective.
``fib_big`` and ``fib_big_rpo`` (fib at 2^29 values, 2^26 rows x 8
columns) are more than one card holds in one process: they have no
one-process proof, so their ranks' bytes must equal one another's, verify
(30 bits) and fail with a byte flipped.  Prints, per workload, a line and
one JSON object: the one-process warm seconds, the sharded warm seconds of
every rank, rank 0's per-phase device ms, collectives, bytes and the
largest collective a prove, and every rank's peak device memory.  Ranks
sharing one card run over gloo in chip_smoke.py's phase 13, not here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKEND = "nccl"
TIMEOUT = 300  # seconds the ranks' start and each run may take
ALONE = ("fib_big", "fib_big_rpo")  # workloads with no one-process prove
VERIFY_BITS = 30


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("workloads", nargs="*", default=["fib", "hello"])
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from ministark_tpu_torch.parallel.spawn import RankPool

    if not torch.cuda.is_available():
        cs.fail("needs a GPU")
    ranks = torch.cuda.device_count()
    card = cs.card_line()
    print(f"cards: {ranks} x {card}; {ranks} ranks over {BACKEND}",
          flush=True)
    cs.build_kernels()
    one = {}
    for name in args.workloads:
        if name in ALONE:
            continue
        claim, trace, opts, _info = cs.workload(name)
        claim.prove(opts, trace)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proof = claim.prove(opts, trace)
        torch.cuda.synchronize()
        one[name] = (proof.to_bytes(claim.fq), time.perf_counter() - t0)
        del claim, trace, proof
        torch.cuda.empty_cache()
    ok = True
    with RankPool(ranks, BACKEND, "cuda", timeout=TIMEOUT) as pool:
        for name in args.workloads:
            alone = name in ALONE
            # rank 0 verifies the proof of a workload with no one-process
            # proof, and rejects it with a byte flipped
            runs = pool.run(cs.sharded_prove, name,
                            VERIFY_BITS if alone else None)
            want, one_s = (runs[0]["proof"], None) if alone else one[name]
            same = [r["proof"] == want for r in runs]
            ok &= (all(same) and not any(r["loaded"] for r in runs)
                   and runs[0]["collectives"] > 0)
            r0 = runs[0]
            phases = {p["phase"]: round(p["device_ms"], 3)
                      for p in r0["phases"]}
            print(f"{name}: {ranks} ranks over {BACKEND}: bytes equal "
                  f"{'rank 0' if alone else 'the one-process'} proof on "
                  f"ranks {same}{'; verified on rank 0' if alone else ''}; "
                  f"warm {[round(r['warm_prove_s'], 4) for r in runs]} s "
                  f"(one process {'none' if alone else f'{one_s:.4f}'} s); "
                  f"collectives {r0['collectives']}, "
                  f"{r0['collective_bytes']} bytes sent a rank, the largest "
                  f"{r0['max_collective_bytes']}; peak "
                  f"{[round(r['peak_device_gib'], 3) for r in runs]} GiB; "
                  f"rank 0's phases, device ms: {phases}", flush=True)
            print(json.dumps({name: {
                "card": card, "cards": ranks, "ranks": ranks,
                "backend": BACKEND, "same_bytes": same,
                "one_process_warm_s": one_s,
                "warm_prove_s": [r["warm_prove_s"] for r in runs],
                "cold_prove_s": [r["cold_prove_s"] for r in runs],
                "peak_device_gib": [r["peak_device_gib"] for r in runs],
                "collectives": r0["collectives"],
                "collective_bytes": r0["collective_bytes"],
                "max_collective_bytes": r0["max_collective_bytes"],
                "verify_s": r0.get("verify_s"),
                "phases": r0["phases"], "launches": r0["launches"]}}),
                flush=True)
    if not ok:
        cs.fail("a rank's proof differs from the one-process proof, or a "
                "prove made no collective")
    return 0


if __name__ == "__main__":
    sys.exit(main())
