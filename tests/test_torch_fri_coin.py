"""The FRI commit phase on the device coin (``fri.FriProver``), on the
CPU with the coin's plain versions: a toy fib prove (32 rows, three FRI
layers of folding factor 2).

* With the SHA-256 coin every layer's commit, coin step and fold is
  queued with no root reaching the host (no ``CommittedMerkleTree.root``,
  no ``Tensor.cpu``) before the last fold; then one copy.
* A coin step that returns one wrong draw makes the host replay raise at
  that layer.
* An RPO-256 coin over SHA-256 trees keeps the host coin between layers,
  still proves, and both the port's and the JAX package's verifier accept
  the proof.
"""

import pytest
import torch

from ministark_tpu_torch import fri as tfri
from ministark_tpu_torch import hash as H
from ministark_tpu_torch import hash_rpo, merkle
from ministark_tpu_torch.air import ProofOptions
from ministark_tpu_torch.fields import device as fd
from ministark_tpu_torch.fields.scalar import Fp
from ministark_tpu_torch.models.fib import FibClaim, gen_trace
from ministark_tpu_torch.ops import coin as kcoin
from ministark_tpu_torch.proof import Proof

OPTS = ProofOptions(8, 4, 2, 2, 4)
LAYERS = 3


@pytest.fixture(scope="module")
def trace():
    return gen_trace(256, device="cpu")


def _spy(monkeypatch, events, obj, name, tag):
    real = getattr(obj, name)

    def spy(*args, **kwargs):
        events.append(tag)
        return real(*args, **kwargs)

    monkeypatch.setattr(obj, name, spy)


def _fri_events(monkeypatch, claim, trace):
    """The prove's proof and what its FRI commit phase did, in order:
    folds, coin steps, roots read, copies to the host."""
    events = []
    _spy(monkeypatch, events, tfri, "fold_coeffs", "fold")
    _spy(monkeypatch, events, kcoin, "coin_sha", "coin")
    _spy(monkeypatch, events, kcoin, "coin_rpo", "coin")
    _spy(monkeypatch, events, merkle.CommittedMerkleTree, "root", "root")
    _spy(monkeypatch, events, torch.Tensor, "cpu", "cpu")
    real = tfri.FriProver.build_layers

    def build_layers(self, channel, evals):
        events.append("start")
        real(self, channel, evals)
        events.append("end")

    monkeypatch.setattr(tfri.FriProver, "build_layers", build_layers)
    proof = claim.prove(OPTS, trace)
    monkeypatch.undo()
    return proof, events[events.index("start") + 1:events.index("end")]


def test_no_root_reaches_the_host_before_the_last_fold(monkeypatch, trace):
    claim = FibClaim(trace.last_value())
    proof, ev = _fri_events(monkeypatch, claim, trace)
    assert ev.count("fold") == ev.count("coin") == LAYERS
    last_fold = len(ev) - 1 - ev[::-1].index("fold")
    assert "root" not in ev[:last_fold] and "cpu" not in ev[:last_fold], ev
    assert ev[last_fold + 1:].count("cpu") == 1  # the one copy
    assert len(proof.fri_proof.layers) == LAYERS
    claim.verify(Proof.from_bytes(proof.to_bytes(Fp), Fp, Fp), 8)


@pytest.mark.parametrize("layer", range(LAYERS))
def test_a_wrong_device_draw_raises_at_its_layer(monkeypatch, trace, layer):
    real = kcoin.coin_sha_plain
    calls = []

    def wrong(seed, root, k, N):
        new, draws, powers = real(seed, root, k, N)
        calls.append(1)
        if len(calls) == layer + 1:
            draws = fd.add(draws, torch.ones_like(draws))
        return new, draws, powers

    monkeypatch.setattr(kcoin, "coin_sha_plain", wrong)
    with pytest.raises(AssertionError,
                       match=f"device coin diverged from host replay at FRI "
                             f"layer {layer}: "):
        FibClaim(trace.last_value()).prove(OPTS, trace)


@pytest.mark.parametrize("coin, trees, step", [
    (H, H, "coin_sha"), (H, hash_rpo, "coin_sha"),
    (hash_rpo, hash_rpo, "coin_rpo"), (hash_rpo, H, None)])
def test_device_coin_gate(coin, trees, step):
    got = tfri.device_coin_step(coin, trees)
    assert got is (None if step is None else getattr(kcoin, step))


def test_rpo_coin_over_sha_trees_keeps_the_host_coin(monkeypatch, trace):
    """The per-layer path: each root on the host before its fold; the
    proof verifies in both packages."""
    from ministark_tpu.fields.scalar import Fp as JFp
    from ministark_tpu import hash_rpo as jrpo
    from ministark_tpu.models.fib import FibClaim as JFibClaim
    from ministark_tpu.proof import Proof as JProof

    class FibClaimRpoCoin(FibClaim):
        coin_hash = hash_rpo

    class JFibClaimRpoCoin(JFibClaim):
        coin_hash = jrpo

    claim = FibClaimRpoCoin(trace.last_value())
    proof, ev = _fri_events(monkeypatch, claim, trace)
    assert "coin" not in ev and ev.count("fold") == LAYERS
    assert ev.index("root") < ev.index("fold")
    data = proof.to_bytes(Fp)
    claim.verify(Proof.from_bytes(data, Fp, Fp), 8)
    JFibClaimRpoCoin(JFp(trace.last_value().v)).verify(
        JProof.from_bytes(data, JFp, JFp), 8)
