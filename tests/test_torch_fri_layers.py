"""FRI proofs with one layer too many or too few, through the port's
verifier and the JAX package's, on the CPU.

The port's ``FriVerifier.verify`` rejects a proof whose layer count is not
``options.num_layers``; the JAX one loops over ``options.num_layers`` and
never checks the count.  Each case below holds the port to a
``VerificationError`` and records what the JAX verifier does with the same
bytes.

Two ways to get such a proof from a toy fib prove (32 rows, three
FRI layers of folding factor 2):
* "cut": the honest proof's bytes (one prove for both cases) with its last
  layer repeated or dropped.
  The verifier's transcript then differs from the prover's, so both
  verifiers reject before FRI: at the proof-of-work check, or (when the
  2-bit grind passes by chance) at the first trace query.
* "prover": the port's prover run with ``FriOptions.num_layers`` one higher
  or lower, so the transcript, the grind and the queries match the layers
  it committed and verification reaches the FRI layers.  There the JAX
  verifier leaves an extra layer unchecked (its remainder check fails) and
  indexes past the end of a short list (``IndexError``).
"""

import pytest

from ministark_tpu.fields.scalar import Fp as JFp
from ministark_tpu.models.fib import FibClaim as JFibClaim
from ministark_tpu.proof import Proof as JProof
from ministark_tpu.verifier import VerificationError as JVerificationError

# what the JAX verifier raises, and the start of its message
JAX_OUTCOME = {
    ("cut", 1): (JVerificationError,
                 "query does not resolve to the base trace commitment"),
    ("cut", -1): (JVerificationError, "insufficient proof of work"),
    ("prover", 1): (JVerificationError,
                    "fri verification failed: remainder mismatch"),
    ("prover", -1): (IndexError, "list index out of range"),
}


@pytest.fixture(scope="module")
def fib():
    """The claim, its trace, the options and the honest proof's bytes."""
    from ministark_tpu_torch.air import ProofOptions
    from ministark_tpu_torch.fields.scalar import Fp
    from ministark_tpu_torch.models.fib import FibClaim, gen_trace

    trace = gen_trace(256, device="cpu")
    claim, opts = FibClaim(trace.last_value()), ProofOptions(8, 4, 2, 2, 4)
    return claim, trace, opts, claim.prove(opts, trace).to_bytes(Fp)


def _malformed(fib, how, delta):
    from ministark_tpu_torch import fri as tfri
    from ministark_tpu_torch.fields.scalar import Fp
    from ministark_tpu_torch.proof import Proof

    claim, trace, opts, honest_bytes = fib
    if how == "cut":
        proof = Proof.from_bytes(honest_bytes, Fp, Fp)
        layers = proof.fri_proof.layers
        assert len(layers) == 3
        if delta > 0:
            layers.append(layers[-1])
        else:
            layers.pop()
        return proof.to_bytes(Fp)
    honest = tfri.FriOptions.num_layers
    mp = pytest.MonkeyPatch()
    mp.setattr(tfri.FriOptions, "num_layers",
               lambda self, n: honest(self, n) + delta)
    try:
        data = claim.prove(opts, trace).to_bytes(Fp)
    finally:
        mp.undo()
    assert len(Proof.from_bytes(data, Fp, Fp).fri_proof.layers) == 3 + delta
    return data


@pytest.mark.parametrize("how", ["cut", "prover"])
@pytest.mark.parametrize("delta", [1, -1], ids=["extra_layer",
                                                "missing_layer"])
def test_both_verifiers_on_a_wrong_layer_count(fib, how, delta):
    from ministark_tpu_torch.fields.scalar import Fp
    from ministark_tpu_torch.proof import Proof
    from ministark_tpu_torch.verifier import VerificationError

    claim, trace = fib[:2]
    data = _malformed(fib, how, delta)
    with pytest.raises(VerificationError) as port:
        claim.verify(Proof.from_bytes(data, Fp, Fp), 8)
    if how == "prover":
        assert f"expected 3 FRI layers, got {3 + delta}" in str(port.value)
    kind, message = JAX_OUTCOME[(how, delta)]
    with pytest.raises(Exception) as jax:
        JFibClaim(JFp(trace.last_value().v)).verify(
            JProof.from_bytes(data, JFp, JFp), 8)
    assert jax.type is kind and str(jax.value).startswith(message)
