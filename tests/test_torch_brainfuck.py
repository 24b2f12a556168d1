"""The brainfuck (Fq3) slice end to end, and its host pieces.

* The port's VM tables equal the JAX package's ``simulate``, array for
  array (the memory table comes from one sort and one gap-filling pass).
* The port proves ``"++>+++[<+>-]<."`` on the CPU in a subprocess that
  blocks ``jax`` and ``ministark_tpu`` (``sys.modules[name] = None``) before
  importing it, with the golden-fixture options; it checks that its own
  verifier accepts the proof and rejects tampered copies, and reports the
  proof bytes and the modules it loaded.  This process holds the bytes
  against ``tests/golden/brainfuck_2plus3.proof`` (written by the JAX
  package; it pins the extension-trace commitment, so it also holds the
  port's extension columns against the JAX package's) and against the JAX
  package's verifier.
* A second subprocess proves the same claim with RPO-256 trees and coin;
  its bytes must equal
  ``tests/golden/brainfuck_2plus3_rpo.proof``, which the JAX package wrote
  (``scripts/make_golden_bf_rpo.py``).
* The entry points that put host data on a device default to the card and
  raise when there is none.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "brainfuck_2plus3.proof")
GOLDEN_RPO = os.path.join(ROOT, "tests", "golden",
                          "brainfuck_2plus3_rpo.proof")
PROGRAM = "++>+++[<+>-]<."

_PORT_RUN = r"""
import json, sys
sys.modules["jax"] = None            # any import of JAX now fails
sys.modules["ministark_tpu"] = None  # and so does any of the JAX package
from ministark_tpu_torch import hash_rpo
from ministark_tpu_torch.air import ProofOptions
from ministark_tpu_torch.fields.scalar import Fp, Fq3
from ministark_tpu_torch.models.brainfuck import (BrainfuckClaim,
                                                  BrainfuckTrace, simulate)
from ministark_tpu_torch.proof import Proof
from ministark_tpu_torch.verifier import VerificationError


class BrainfuckClaimRpo(BrainfuckClaim):
    merkle_hash = hash_rpo
    coin_hash = hash_rpo


program, rpo = sys.argv[1], sys.argv[2] == "rpo"
opts = ProofOptions(num_queries=9, lde_blowup_factor=16, grinding_factor=0,
                    fri_folding_factor=4, fri_max_remainder_coeffs=16)
tables, output = simulate(program)
claim = (BrainfuckClaimRpo if rpo else BrainfuckClaim)(program, b"", output)
data = claim.prove(opts, BrainfuckTrace(tables, device="cpu")).to_bytes(Fq3)
# the RPO-256 run only proves: its bytes are held to a proof the JAX
# package verified when it wrote it, and the host RPO verify is seconds
if not rpo:
    claim.verify(Proof.from_bytes(data, Fp, Fq3), 16)
# first bytes of the base and extension commitments; last composition OOD
positions = [] if rpo else [21, 62, len(data) - 1]
rejected = []
for pos in positions:
    bad = bytearray(data)
    bad[pos] ^= 1
    try:
        claim.verify(Proof.from_bytes(bytes(bad), Fp, Fq3), 16)
    except VerificationError:
        rejected.append(pos)
loaded = sorted(m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "ministark_tpu")))
print(json.dumps({"proof": data.hex(), "output": output.hex(),
                  "rejected": rejected, "positions": positions,
                  "loaded": loaded}))
"""


@pytest.fixture(scope="module")
def port_procs():
    """The port's proves over SHA-256 and RPO-256 trees, started together
    with the file's first test that needs one."""
    env = dict(os.environ, PYTHONPATH=ROOT, MINISTARK_TPU_TIMERS="0",
               OMP_NUM_THREADS="1")
    procs = {h: subprocess.Popen(
        [sys.executable, "-c", _PORT_RUN, PROGRAM, h], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for h in ("sha", "rpo")}
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _result(proc):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port_run(port_procs):
    # the imports this file's tests need, made while the port proves
    import ministark_tpu.models.brainfuck  # noqa: F401
    import ministark_tpu.proof  # noqa: F401
    import ministark_tpu_torch.models.brainfuck  # noqa: F401

    return _result(port_procs["sha"])


@pytest.fixture(scope="module")
def port_rpo_run(port_procs):
    return _result(port_procs["rpo"])


def test_port_brainfuck_proof_matches_golden_bytes(port_run):
    from ministark_tpu.fields.scalar import Fp, Fq3
    from ministark_tpu.proof import Proof

    got = bytes.fromhex(port_run["proof"])
    with open(GOLDEN, "rb") as f:
        want = f.read()
    if got != want:
        a, b = Proof.from_bytes(got, Fp, Fq3), Proof.from_bytes(want, Fp, Fq3)
        diff = [k for k in vars(a) if getattr(a, k) != getattr(b, k)]
        pytest.fail(f"port proof differs from the golden fixture in {diff}")


def test_jax_verifier_accepts_port_brainfuck_proof(port_run):
    from ministark_tpu.fields.scalar import Fp, Fq3
    from ministark_tpu.models.brainfuck import BrainfuckClaim
    from ministark_tpu.proof import Proof

    data = bytes.fromhex(port_run["proof"])
    output = bytes.fromhex(port_run["output"])
    claim = BrainfuckClaim(PROGRAM, b"", output)
    claim.verify(Proof.from_bytes(data, Fp, Fq3), 16)
    bad = bytearray(data)
    bad[-1] ^= 1
    with pytest.raises(Exception):
        claim.verify(Proof.from_bytes(bytes(bad), Fp, Fq3), 16)


def test_port_verifier_rejects_tampered_brainfuck_proofs(port_run):
    assert port_run["rejected"] == port_run["positions"]


def test_port_brainfuck_run_never_imports_jax(port_run):
    assert port_run["loaded"] == []


@pytest.mark.parametrize("program", ["++>+++[<+>-]<.", "hello_world.bf",
                                     ",[.-]"])
def test_vm_tables_match_jax_simulate(program):
    from ministark_tpu.models.brainfuck import vm as jax_vm
    from ministark_tpu_torch.models.brainfuck import vm

    if program.endswith(".bf"):
        with open(os.path.join(ROOT, "programs", program)) as f:
            program = f.read()
    inp = b"\x03" if "," in program else b""
    got, got_out = vm.simulate(program, inp)
    want, want_out = jax_vm.simulate(program, inp)
    assert got_out == want_out
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == np.uint64
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_memory_rows_one_pass_matches_jax_derivation():
    """derive_memory_rows (one sort, one gap-filling pass) against the JAX
    package's row-by-row insertion, on a processor table with long gaps."""
    from ministark_tpu.models.brainfuck import vm as jax_vm
    from ministark_tpu_torch.models.brainfuck import vm

    program = "+>++[>+++[<<+>>-]<-]<[>>+<<-]."
    tables, _ = vm.simulate(program)
    proc = tables["processor"]
    proc = proc[proc[:, 7] == 0]  # the unpadded rows
    got = vm.derive_memory_rows(proc)
    want = np.asarray(jax_vm.derive_memory_rows(proc), dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("entry", ["gen_trace", "from_columns_np",
                                   "BrainfuckTrace"])
def test_entry_points_default_to_the_card(entry):
    """With no device argument, host data goes to the card; with no card,
    the entry point raises instead of carrying on on the CPU."""
    import torch

    from ministark_tpu_torch.matrix import Matrix
    from ministark_tpu_torch.models.brainfuck import BrainfuckTrace, simulate
    from ministark_tpu_torch.models.fib import gen_trace

    make = {"gen_trace": lambda: gen_trace(1 << 6).base_columns(),
            "from_columns_np": lambda: Matrix.from_columns_np(
                np.ones((2, 8), dtype=np.uint64)),
            "BrainfuckTrace": lambda: BrainfuckTrace(
                simulate(PROGRAM)[0]).base_columns()}[entry]
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_port_brainfuck_rpo_proof_matches_jax_golden_bytes(port_rpo_run):
    """RPO-256 trees and coin over Fq3: the port's one-process proof
    equals the JAX package's byte for byte."""
    with open(GOLDEN_RPO, "rb") as f:
        want = f.read()
    assert bytes.fromhex(port_rpo_run["proof"]) == want
    assert port_rpo_run["loaded"] == []
