"""BrainSTARK command-line interface (reference: examples/brainfuck/main.rs;
mirrors ``ministark_tpu.models.brainfuck.cli``).

Usage:
    python -m ministark_tpu_torch.models.brainfuck.cli prove  SRC --dst PROOF [--input STR] [--device DEV]
    python -m ministark_tpu_torch.models.brainfuck.cli verify SRC --proof PROOF [--input STR] --output STR

`prove` runs on the card unless ``--device cpu`` (or another torch device)
is given; `verify` is host work.  The proof file holds ark-layout bytes of
(claim, proof), like the reference's `(claim, proof).serialize_compressed`
(main.rs:149-157): the same program, input and options give the same bytes
as the JAX package's CLI, and a file from either verifies in the other."""

from __future__ import annotations

import argparse
import time

from ... import serde
from ...air import ProofOptions
from ...fields.scalar import Fp, Fq3
from ...proof import Proof
from .air import BrainfuckClaim
from .trace import BrainfuckTrace
from .vm import simulate

SECURITY_LEVEL = 96
# reference hello_world options for 96-bit security (main.rs:92-105)
OPTIONS = ProofOptions(num_queries=19, lde_blowup_factor=16, grinding_factor=20,
                       fri_folding_factor=16, fri_max_remainder_coeffs=16)


def serialize_claim(w: serde.Writer, claim: BrainfuckClaim):
    claim.serialize_public_inputs(w)


def deserialize_claim(r: serde.Reader) -> BrainfuckClaim:
    src = r.raw(r.u64()).decode()
    inp = r.raw(r.u64())
    out = r.raw(r.u64())
    return BrainfuckClaim(src, inp, out)


def cmd_prove(args):
    source = open(args.src).read()
    t0 = time.time()
    tables, output = simulate(source, args.input.encode())
    trace = BrainfuckTrace(tables, device=args.device)
    print(f"Generated execution trace (cols=17, rows={tables['processor'].shape[0]}) "
          f"in {time.time() - t0:.2f}s")
    print(f'Program output: "{output.decode(errors="replace")}"')

    claim = BrainfuckClaim(source, args.input.encode(), output)
    t0 = time.time()
    proof = claim.prove(OPTIONS, trace)
    print(f"Proof generated in: {time.time() - t0:.1f}s")
    print(f"Proof security (conjectured): {proof.security_level_bits(Fq3)}bit")

    w = serde.Writer()
    serialize_claim(w, claim)
    proof.serialize(w, Fq3)
    data = w.bytes()
    print(f"Proof size: {len(data) // 1024}KB")
    with open(args.dst, "wb") as f:
        f.write(data)
    print(f"Proof written to {args.dst}")


def cmd_verify(args):
    data = open(args.proof, "rb").read()
    r = serde.Reader(data)
    claim = deserialize_claim(r)
    proof = Proof.deserialize(r, Fp, Fq3)
    source = open(args.src).read()
    assert args.input.encode() == claim.input, "input mismatch"
    assert args.output.encode() == claim.output, "output mismatch"
    assert source == claim.source_code, "source mismatch"

    t0 = time.time()
    claim.verify(proof, SECURITY_LEVEL)
    print(f"Proof verified in: {time.time() - t0:.2f}s")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="brainstark",
        description="ministark_tpu_torch brainfuck prover and verifier")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("prove")
    p.add_argument("src")
    p.add_argument("--dst", required=True)
    p.add_argument("--input", default="")
    p.add_argument("--device", default=None,
                   help="torch device to prove on (default: the card)")
    p.set_defaults(fn=cmd_prove)

    v = sub.add_parser("verify")
    v.add_argument("src")
    v.add_argument("--proof", required=True)
    v.add_argument("--input", default="")
    v.add_argument("--output", required=True)
    v.set_defaults(fn=cmd_verify)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
