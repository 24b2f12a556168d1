"""The slice end to end: the port's fib prove at 2^10 values on the CPU.

The port runs in a subprocess that blocks ``jax`` and ``ministark_tpu``
(``sys.modules[name] = None``) before importing it: it proves with the
golden-fixture options, checks that its own verifier rejects tampered
copies, and reports the proof bytes, its trace and the modules it loaded.
This process then holds those bytes against ``tests/golden/fib_2e10.proof``
(written by the JAX package) and against the JAX package's verifier.

The JAX package is imported inside the fixture, after the subprocess has
started, so its import overlaps the port's prove.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "fib_2e10.proof")

_PORT_RUN = r"""
import json, sys
sys.modules["jax"] = None            # any import of JAX now fails
sys.modules["ministark_tpu"] = None  # and so does any of the JAX package
from ministark_tpu_torch.air import ProofOptions
from ministark_tpu_torch.fields.scalar import Fp
from ministark_tpu_torch.models.fib import FibClaim, gen_trace
from ministark_tpu_torch.proof import Proof
from ministark_tpu_torch.verifier import VerificationError

opts = ProofOptions(num_queries=8, lde_blowup_factor=4, grinding_factor=2,
                    fri_folding_factor=4, fri_max_remainder_coeffs=16)
trace = gen_trace(1 << 10, device="cpu")
claim = FibClaim(trace.last_value())
data = claim.prove(opts, trace).to_bytes(Fp)
claim.verify(Proof.from_bytes(data, Fp, Fp), 16)
rejected = []
for pos in (21, len(data) - 1):  # base commitment; last composition OOD eval
    bad = bytearray(data)
    bad[pos] ^= 1
    try:
        claim.verify(Proof.from_bytes(bytes(bad), Fp, Fp), 16)
    except VerificationError:
        rejected.append(pos)
loaded = sorted(m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "ministark_tpu")))
print(json.dumps({"proof": data.hex(), "rejected": rejected,
                  "positions": [21, len(data) - 1], "loaded": loaded,
                  "trace": [[int(v) % (1 << 64) for v in row]
                            for row in trace.matrix.values.tolist()]}))
"""


@pytest.fixture(scope="module")
def port_run():
    env = dict(os.environ, PYTHONPATH=ROOT, MINISTARK_TPU_TIMERS="0")
    proc = subprocess.Popen([sys.executable, "-c", _PORT_RUN], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        import ministark_tpu.models.fib  # noqa: F401
        import ministark_tpu.proof  # noqa: F401

        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


def _first_difference(got: bytes, want: bytes) -> str:
    """Name the first proof field (in serialization order) that differs."""
    from ministark_tpu.fields.scalar import Fp
    from ministark_tpu.proof import Proof

    try:
        a, b = Proof.from_bytes(got, Fp, Fp), Proof.from_bytes(want, Fp, Fp)
    except (EOFError, AssertionError) as e:
        return f"unparseable proof bytes ({e})"
    fields = [("options", a.options, b.options),
              ("trace_len", a.trace_len, b.trace_len),
              ("base_trace_commitment", a.base_trace_commitment,
               b.base_trace_commitment),
              ("composition_trace_commitment", a.composition_trace_commitment,
               b.composition_trace_commitment)]
    for i, (la, lb) in enumerate(zip(a.fri_proof.layers, b.fri_proof.layers)):
        fields += [(f"fri layer {i} commitment", la.commitment, lb.commitment),
                   (f"fri layer {i} rows", la.flattened_rows,
                    lb.flattened_rows),
                   (f"fri layer {i} merkle proof", la.merkle_proof,
                    lb.merkle_proof)]
    qa, qb = a.trace_queries, b.trace_queries
    fields += [("fri layer count", len(a.fri_proof.layers),
                len(b.fri_proof.layers)),
               ("fri remainder", a.fri_proof.remainder_coeffs,
                b.fri_proof.remainder_coeffs),
               ("pow_nonce", a.pow_nonce, b.pow_nonce),
               ("base trace query values", qa.base_trace_values,
                qb.base_trace_values),
               ("composition trace query values",
                qa.composition_trace_values, qb.composition_trace_values),
               ("base trace merkle proof", qa.base_trace_proof,
                qb.base_trace_proof),
               ("composition trace merkle proof", qa.composition_trace_proof,
                qb.composition_trace_proof),
               ("execution trace ood evals", a.execution_trace_ood_evals,
                b.execution_trace_ood_evals),
               ("composition trace ood evals", a.composition_trace_ood_evals,
                b.composition_trace_ood_evals)]
    for name, x, y in fields:
        if x != y:
            return name
    return "no field differs (byte layout only)"


def test_port_proof_matches_golden_bytes(port_run):
    got = bytes.fromhex(port_run["proof"])
    with open(GOLDEN, "rb") as f:
        want = f.read()
    assert got == want, (f"port proof differs from the golden fixture; "
                         f"first differing field: {_first_difference(got, want)}")


def test_jax_verifier_accepts_port_proof(port_run):
    from ministark_tpu.fields.scalar import Fp
    from ministark_tpu.models.fib import FibClaim
    from ministark_tpu.proof import Proof

    data = bytes.fromhex(port_run["proof"])
    trace = np.array(port_run["trace"], dtype=np.uint64)
    claim = FibClaim(Fp(int(trace[7, -1])))
    claim.verify(Proof.from_bytes(data, Fp, Fp), 16)


def test_port_verifier_rejects_tampered_proofs(port_run):
    assert port_run["rejected"] == port_run["positions"]


def test_port_never_imports_jax(port_run):
    assert port_run["loaded"] == []


def test_port_trace_matches_jax_trace(port_run):
    """The port's native fib trace is the JAX package's trace, value for
    value (its limb planes joined as ``fields.convert.from_jax_matrix`` joins
    them; that function is checked in test_torch_fields.py)."""
    from ministark_tpu.fields import npfield as nf
    from ministark_tpu.models.fib import gen_trace

    m = gen_trace(1 << 10).matrix
    want = nf.from_limbs(np.asarray(m.lo), np.asarray(m.hi))
    np.testing.assert_array_equal(np.array(port_run["trace"], np.uint64),
                                  want)
