#!/usr/bin/env python3
"""Write the JAX package's fully algebraic fib proof as a golden file.

    python3 scripts/make_golden_rpo.py [out_path]

Proves fib at 2^7 values (``gen_trace(128)``) with ``ministark_tpu``, RPO-256
Merkle trees and an RPO-256 public coin (the ``FibClaimRpoFull``
configuration of tests/test_rpo_merkle_e2e.py), options (8, 4, 3, 4, 4),
verifies it, and writes its bytes to ``tests/golden/fib_2e7_rpo_full.proof``
(or `out_path`).  The port's proof of the same claim must equal these bytes
(tests/test_torch_rpo.py, chip_smoke.py).

It runs JAX on the CPU with the XLA flags the test suite uses
(tests/conftest.py); the first run compiles for a long time.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "golden", "fib_2e7_rpo_full.proof")


def main() -> int:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_disable_hlo_passes" not in flags:
        # XLA:CPU's fusion recomputes shared subexpressions of the field-op
        # DAGs per output element (tests/conftest.py)
        flags = (flags + " --xla_disable_hlo_passes=fusion,cpu-fusion").strip()
    os.environ["XLA_FLAGS"] = flags
    sys.path.insert(0, ROOT)

    from ministark_tpu import hash_rpo
    from ministark_tpu.air import ProofOptions
    from ministark_tpu.fields.scalar import Fp
    from ministark_tpu.models.fib import FibClaim, gen_trace
    from ministark_tpu.proof import Proof

    class FibClaimRpoFull(FibClaim):
        merkle_hash = hash_rpo
        coin_hash = hash_rpo

    out = sys.argv[1] if len(sys.argv) > 1 else OUT
    opts = ProofOptions(num_queries=8, lde_blowup_factor=4,
                        grinding_factor=3, fri_folding_factor=4,
                        fri_max_remainder_coeffs=4)
    trace = gen_trace(128)
    claim = FibClaimRpoFull(trace.last_value())
    t0 = time.perf_counter()
    data = claim.prove(opts, trace).to_bytes(Fp)
    print(f"proved in {time.perf_counter() - t0:.1f} s, {len(data)} bytes",
          flush=True)
    claim.verify(Proof.from_bytes(data, Fp, Fp), 8)
    with open(out, "wb") as f:
        f.write(data)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
