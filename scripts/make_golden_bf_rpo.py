#!/usr/bin/env python3
"""Write the JAX package's brainfuck proof over RPO-256 as a golden file.

    python3 scripts/make_golden_bf_rpo.py [out_path]

Proves the golden brainfuck program ``"++>+++[<+>-]<."`` (no input, output
0x05) with ``ministark_tpu``, RPO-256 Merkle trees and an RPO-256 public
coin, options (9, 16, 0, 4, 16) (the golden brainfuck options), verifies
it, and writes its bytes to ``tests/golden/brainfuck_2plus3_rpo.proof``
(or `out_path`).  The port's proof of the same claim must equal these
bytes, in one process (tests/test_torch_brainfuck.py) and sharded
(tests/test_torch_sharded_phases.py).

It runs JAX on the CPU with the XLA flags the test suite uses
(tests/conftest.py); the first run compiles for a long time.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "golden", "brainfuck_2plus3_rpo.proof")
PROGRAM = "++>+++[<+>-]<."


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
    from ministark_tpu.fields.scalar import Fp, Fq3
    from ministark_tpu.models.brainfuck import (BrainfuckClaim,
                                                BrainfuckTrace, simulate)
    from ministark_tpu.proof import Proof

    class BrainfuckClaimRpo(BrainfuckClaim):
        merkle_hash = hash_rpo
        coin_hash = hash_rpo

    out = sys.argv[1] if len(sys.argv) > 1 else OUT
    opts = ProofOptions(num_queries=9, lde_blowup_factor=16,
                        grinding_factor=0, fri_folding_factor=4,
                        fri_max_remainder_coeffs=16)
    tables, output = simulate(PROGRAM)
    claim = BrainfuckClaimRpo(PROGRAM, b"", output)
    t0 = time.perf_counter()
    data = claim.prove(opts, BrainfuckTrace(tables)).to_bytes(Fq3)
    print(f"proved in {time.perf_counter() - t0:.1f} s, {len(data)} bytes",
          flush=True)
    claim.verify(Proof.from_bytes(data, Fp, Fq3), 16)
    with open(out, "wb") as f:
        f.write(data)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
