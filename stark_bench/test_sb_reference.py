"""The plain reference (``plainstark``) at a tiny size, on the CPU: it
gives the bytes of proofs that the reference Rust prover's port wrote
(their SHA-256 digests are held here), imports neither JAX nor the
measured package, and its blocked and chunked paths give the values of
their one-piece forms."""

import hashlib
import os
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from plainstark import eval as peval  # noqa: E402
from plainstark import merkle, ntt  # noqa: E402
from plainstark.air import ProofOptions  # noqa: E402
from plainstark.fields.scalar import P, Fp, Fq3  # noqa: E402
from plainstark.models.brainfuck import (BrainfuckClaim,  # noqa: E402
                                         BrainfuckTrace, simulate)
from plainstark.models.fib import FibClaim, gen_trace  # noqa: E402

# SHA-256 of the golden proofs the JAX package wrote (tests/golden/
# fib_2e10.proof and brainfuck_2plus3.proof)
FIB_2E10 = "369b26da7db29ab8b0cb297eafd87d4f168527efa270cdbbd10ae3d14ece84d0"
BF_2PLUS3 = "8a3f9a437482c961938b04863f171a2e84bdf51e96f88df8429a82871ea42209"
FIB_OPTS = ProofOptions(num_queries=8, lde_blowup_factor=4,
                        grinding_factor=2, fri_folding_factor=4,
                        fri_max_remainder_coeffs=16)


def _digest(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def test_fib_golden_bytes():
    trace = gen_trace(1 << 10, "cpu")
    data = FibClaim(trace.last_value()).prove(FIB_OPTS, trace).to_bytes(Fp)
    assert _digest(data) == FIB_2E10


def test_brainfuck_golden_bytes():
    prog = "++>+++[<+>-]<."
    tables, out = simulate(prog)
    data = BrainfuckClaim(prog, b"", out).prove(
        ProofOptions(9, 16, 0, 4, 16),
        BrainfuckTrace(tables, "cpu")).to_bytes(Fq3)
    assert _digest(data) == BF_2PLUS3


def test_fib_closed_form_is_the_chain():
    n = 8 * 64
    v = [1, 2]
    while len(v) < n:
        v.append(v[-2] * v[-1] % P)
    got = gen_trace(n, "cpu").base_columns().values.T.reshape(-1)
    assert [x % (1 << 64) for x in got.tolist()] == v


@pytest.mark.parametrize("host_level", [1, 2, 8])
def test_tree_levels_tensor_and_host_agree(monkeypatch, host_level):
    leaves = torch.randint(0, 256, (64, 32), dtype=torch.uint8)
    whole = merkle.tree_levels(leaves)
    monkeypatch.setattr(merkle, "HOST_LEVEL", host_level)
    split = merkle.tree_levels(leaves)
    assert len(whole) == len(split) == 7
    for a, b in zip(whole, split):
        assert torch.equal(a, b)


def test_ntt_batch_chunks_agree(monkeypatch):
    x = torch.randint(0, 1 << 62, (5, 64), dtype=torch.int64)
    d = ntt.Domain(64, 7)
    whole = d.fft(x)
    monkeypatch.setattr(ntt, "BATCH_ELEMS", 64)
    assert torch.equal(d.fft(x), whole)
    assert torch.equal(d.ifft(whole), x)  # values below 2^62 < p


def test_eval_blocks_agree(monkeypatch):
    """The composition evaluated in many small blocks equals one block."""
    prog = "++[>+<-]>."
    tables, out = simulate(prog)
    claim = BrainfuckClaim(prog, b"", out)
    got = []
    for block_bytes in (peval.BLOCK_BYTES, 1):
        monkeypatch.setattr(peval, "BLOCK_BYTES", block_bytes)
        got.append(claim.prove(ProofOptions(4, 16, 0, 4, 16),
                               BrainfuckTrace(tables, "cpu")).to_bytes(Fq3))
    assert got[0] == got[1]


def test_imports_no_jax_and_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import plainstark.prover, plainstark.models.fib, "
            "plainstark.models.brainfuck; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'ministark_tpu', 'ministark_tpu_torch'}; "
            "print(sorted(bad))" % HERE)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"
