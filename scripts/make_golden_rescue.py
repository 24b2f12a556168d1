#!/usr/bin/env python3
"""Write the JAX package's Rescue hash-chain proof as a golden file.

    python3 scripts/make_golden_rescue.py [out_path]

Proves the Rescue-Prime hash chain of 4 links (``gen_trace((7, 8), 4)``,
64 rows) with ``ministark_tpu``, SHA-256 Merkle trees and coin, options
(8, 8, 4, 4, 16), verifies it, and writes its bytes to
``tests/golden/rescue_4links.proof`` (or `out_path`).  The port's proof of
the same claim must equal these bytes (tests/test_torch_rescue.py,
chip_smoke.py).

It runs JAX on the CPU with the XLA flags the test suite uses
(tests/conftest.py); the first run compiles for a long time.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "golden", "rescue_4links.proof")


def main() -> int:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_disable_hlo_passes" not in flags:
        # XLA:CPU's fusion recomputes shared subexpressions of the field-op
        # DAGs per output element (tests/conftest.py)
        flags = (flags + " --xla_disable_hlo_passes=fusion,cpu-fusion").strip()
    os.environ["XLA_FLAGS"] = flags
    sys.path.insert(0, ROOT)

    from ministark_tpu.air import ProofOptions
    from ministark_tpu.fields.scalar import Fp
    from ministark_tpu.models.rescue import RescueClaim, gen_trace
    from ministark_tpu.proof import Proof

    out = sys.argv[1] if len(sys.argv) > 1 else OUT
    opts = ProofOptions(num_queries=8, lde_blowup_factor=8,
                        grinding_factor=4, fri_folding_factor=4,
                        fri_max_remainder_coeffs=16)
    trace, digest = gen_trace((7, 8), 4)
    claim = RescueClaim(7, 8, digest[0].v, digest[1].v)
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
