"""Fused FRI layer programs (fold+hash+Merkle in one jit, TPU path run here
in Pallas interpret mode) vs the eager host-path prover.

Oracle pattern follows the reference's GPU-vs-CPU tests
(src/eval_gpu.rs:901-1091): identical transcripts must produce identical
layer commitments, rows, Merkle proofs and remainders.
"""

import numpy as np
import pytest

from ministark_tpu import merkle
from ministark_tpu.fields import device as fd
from ministark_tpu.fields.scalar import Fp, Fq3, P
from ministark_tpu.fri import FriOptions, FriProver


class _CoinChannel:
    """Minimal real-transcript channel (ProverChannel minus the Air): the
    fused pipeline derives alphas ON DEVICE from the same seed, so both
    paths must walk identical coin states for the roots to agree."""

    def __init__(self, fq, hashfn=None):
        from ministark_tpu import hash as H
        from ministark_tpu.random import PublicCoin

        self.public_coin = PublicCoin(b"\x42" * 32, field=fq,
                                      hashfn=hashfn or H)
        self.roots = []
        self.remainder = None

    def commit_fri_layer(self, root: bytes):
        self.public_coin.reseed_with_digest(root)
        self.roots.append(root)

    def draw_fri_alpha(self):
        return self.public_coin.draw()

    def commit_remainder(self, remainder_coeffs):
        self.public_coin.reseed_with_field_element_vector(remainder_coeffs)
        self.remainder = list(remainder_coeffs)


def _rand_codeword_fp(rng, n, blowup):
    """Evaluations (natural order) of a random degree < n/blowup poly."""
    import jax.numpy as jnp

    from ministark_tpu.ntt import Domain

    coeffs = np.zeros(n, dtype=np.uint64)
    coeffs[: n // blowup] = rng.integers(0, P, (n // blowup,), dtype=np.uint64)
    lo, hi = fd.pack_np(coeffs)
    return Domain(n).fft_fp((jnp.asarray(lo), jnp.asarray(hi)))


def _proof_bytes(proof, fq):
    from ministark_tpu import serde

    w = serde.Writer()
    proof.serialize(w, fq)
    return w.bytes()


@pytest.mark.slow
@pytest.mark.parametrize("fq_is_ext", [False, True])
def test_fused_layers_match_host(monkeypatch, no_persistent_cache, fq_is_ext):
    rng = np.random.default_rng(5)
    n, N = 1 << 9, 4  # 2 layers (512->128->64); interpret mode costs ~linear in n
    opts = FriOptions(folding_factor=N, max_remainder_coeffs=16,
                      blowup_factor=4)
    if fq_is_ext:
        evals = tuple(_rand_codeword_fp(rng, n, opts.blowup_factor)
                      for _ in range(3))
        fq = Fq3
    else:
        import jax.numpy as jnp

        z = (jnp.zeros((n,), jnp.uint32), jnp.zeros((n,), jnp.uint32))
        evals = (_rand_codeword_fp(rng, n, opts.blowup_factor), z, z)
        fq = Fp

    # host path (CPU default)
    ch1 = _CoinChannel(fq)
    p1 = FriProver(opts, fq_is_ext)
    p1.build_layers(ch1, evals)
    positions = sorted({int(v) for v in rng.integers(0, n, 9)})
    proof1 = p1.into_proof(positions)

    # fused path (lanes pipeline in interpret mode); the pipeline's on-device
    # coin must reproduce the host draws or its internal cross-check raises
    monkeypatch.setenv("MINISTARK_TPU_LANES", "interpret")
    ch2 = _CoinChannel(fq)
    p2 = FriProver(opts, fq_is_ext)
    p2.build_layers(ch2, evals)
    proof2 = p2.into_proof(positions)

    assert ch1.roots == ch2.roots
    assert ch1.remainder == ch2.remainder
    assert _proof_bytes(proof1, fq) == _proof_bytes(proof2, fq)


@pytest.mark.slow
def test_prove_lanes_interpret_matches(monkeypatch, no_persistent_cache):
    """Full fib prove through the lanes pipeline (fused commits, fused FRI
    layers, bundled decommits) must produce byte-identical proofs to the
    host path."""
    from ministark_tpu.air import ProofOptions
    from ministark_tpu.fields import Fp as FpTag
    from ministark_tpu.models.fib import FibClaim, gen_trace
    from ministark_tpu.proof import Proof

    trace = gen_trace(128)
    claim = FibClaim(trace.last_value())
    opts = ProofOptions(num_queries=8, lde_blowup_factor=4,
                        grinding_factor=0, fri_folding_factor=4,
                        fri_max_remainder_coeffs=4)
    p1 = claim.prove(opts, trace).to_bytes(FpTag)
    monkeypatch.setenv("MINISTARK_TPU_LANES", "interpret")
    p2 = claim.prove(opts, trace).to_bytes(FpTag)
    assert p1 == p2
    claim.verify(Proof.from_bytes(p2, FpTag, FpTag), 10)


@pytest.mark.slow
def test_comp_commit_program_ext_matches(monkeypatch, no_persistent_cache):
    """The fused composition-commit program (Fq3 path) must match the eager
    ifft/split/evaluate/commit pipeline.

    Cache writes are blocked by the fixture: (de)serializing THIS executable
    segfaults XLA:CPU in both the cache write and a later cache read of a
    written entry — the kernel itself runs fine."""
    import jax.numpy as jnp

    from ministark_tpu.fields.scalar import GENERATOR
    from ministark_tpu.matrix import MatrixExt3
    from ministark_tpu.ntt import Domain
    from ministark_tpu.prover import _comp_commit_program

    rng = np.random.default_rng(9)
    trace_len, cb, blowup = 64, 2, 4
    ce_dom = Domain(trace_len * cb, GENERATOR)
    lde_dom = Domain(trace_len * blowup, GENERATOR)

    evals = tuple(
        tuple(jnp.asarray(a) for a in
              fd.pack_np(rng.integers(0, P, (trace_len * cb,),
                                      dtype=np.uint64)))
        for _ in range(3))

    # eager reference
    coeffs = ce_dom.ifft_ext3(evals)
    polys = MatrixExt3(*[(c[0].reshape(trace_len, cb).T,
                          c[1].reshape(trace_len, cb).T) for c in coeffs])
    lde_ref = polys.evaluate(lde_dom)
    e = lde_ref.as_ext3()
    tree_ref = merkle.commit_matrix_ext3(e[0], e[1], e[2])

    prog = _comp_commit_program(trace_len, cb, ce_dom, lde_dom, True, True)
    lde_arrays, levels = prog(
        evals, ce_dom._inv_tbl(), ce_dom._unscale_tbl(), ce_dom._inv_tmat(),
        ce_dom._ipost_tbl(), lde_dom._fwd_tbl(), lde_dom._scale_tbl(),
        lde_dom._fwd_tmat(), lde_dom._scale_brv_tbl())
    tree_new = merkle.CommittedMerkleTree(levels, device_lanes=True)

    assert tree_ref.root() == tree_new.root()
    for k in range(3):
        assert fd.to_ints(e[k]) == fd.to_ints(lde_arrays[k])


# 1099 s: XLA:CPU compiling the JAX package's interpret-mode kernel (8 CPUs).
@pytest.mark.slow
def test_fused_commit_matches_host(monkeypatch, no_persistent_cache):
    rng = np.random.default_rng(6)
    import jax.numpy as jnp

    n, ncols = 1 << 9, 4
    lo, hi = fd.pack_np(rng.integers(0, P, (ncols, n), dtype=np.uint64))
    lo, hi = jnp.asarray(lo), jnp.asarray(hi)

    t1 = merkle.commit_matrix_fp(lo, hi)
    monkeypatch.setenv("MINISTARK_TPU_LANES", "interpret")
    t2 = merkle.commit_matrix_fp(lo, hi)
    assert t1.root() == t2.root()
    idx = [0, 3, 5, 500]
    assert t1.prove(idx).nodes == t2.prove(idx).nodes

    c0 = (lo, hi)
    c1 = tuple(jnp.asarray(a) for a in
               fd.pack_np(rng.integers(0, P, (ncols, n), dtype=np.uint64)))
    c2 = tuple(jnp.asarray(a) for a in
               fd.pack_np(rng.integers(0, P, (ncols, n), dtype=np.uint64)))
    monkeypatch.delenv("MINISTARK_TPU_LANES")
    t3 = merkle.commit_matrix_ext3(c0, c1, c2)
    monkeypatch.setenv("MINISTARK_TPU_LANES", "interpret")
    t4 = merkle.commit_matrix_ext3(c0, c1, c2)
    assert t3.root() == t4.root()


@pytest.mark.slow
def test_fused_layers_rpo_coin_match_host(monkeypatch, no_persistent_cache):
    """Fully-algebraic fused pipeline — RPO-256 trees AND an RPO-256 public
    coin (ops/coin.py rpo_reseed/rpo_draw_fps on device): identical
    roots/remainder/proof bytes to the per-layer host path."""
    from ministark_tpu import hash_rpo

    rng = np.random.default_rng(23)
    n, N = 1 << 9, 4
    opts = FriOptions(folding_factor=N, max_remainder_coeffs=16,
                      blowup_factor=4)
    evals = _rand_codeword_fp(rng, n, opts.blowup_factor)
    import jax.numpy as jnp
    z = (jnp.zeros((n,), jnp.uint32), jnp.zeros((n,), jnp.uint32))
    triple = (evals, z, z)

    ch1 = _CoinChannel(Fp, hashfn=hash_rpo)
    p1 = FriProver(opts, False, hashfn=hash_rpo)
    p1.build_layers(ch1, triple)  # lanes off -> per-layer host coin
    positions = sorted({int(v) for v in rng.integers(0, n, 9)})
    proof1 = p1.into_proof(positions)
    a1 = ch1.public_coin.draw()  # post-remainder state must agree too

    monkeypatch.setenv("MINISTARK_TPU_LANES", "interpret")
    ch2 = _CoinChannel(Fp, hashfn=hash_rpo)
    p2 = FriProver(opts, False, hashfn=hash_rpo)
    p2.build_layers(ch2, triple)  # fused: device RPO coin + replay check
    proof2 = p2.into_proof(positions)
    a2 = ch2.public_coin.draw()

    assert ch1.roots == ch2.roots
    assert ch1.remainder == ch2.remainder
    assert a1 == a2
    assert _proof_bytes(proof1, Fp) == _proof_bytes(proof2, Fp)


@pytest.mark.slow
def test_fused_layers_rpo_trees_match_host(monkeypatch, no_persistent_cache):
    """Fused FRI pipeline with RPO-256 layer trees (SHA coin): identical
    roots/rows/proof bytes to the per-layer host path."""
    from ministark_tpu import hash_rpo

    rng = np.random.default_rng(11)
    n, N = 1 << 9, 4
    opts = FriOptions(folding_factor=N, max_remainder_coeffs=16,
                      blowup_factor=4)
    evals = _rand_codeword_fp(rng, n, opts.blowup_factor)
    import jax.numpy as jnp
    z = (jnp.zeros((n,), jnp.uint32), jnp.zeros((n,), jnp.uint32))
    triple = (evals, z, z)

    ch1 = _CoinChannel(Fp)
    p1 = FriProver(opts, False, hashfn=hash_rpo)
    p1.build_layers(ch1, triple)
    positions = sorted({int(v) for v in rng.integers(0, n, 9)})
    proof1 = p1.into_proof(positions)

    monkeypatch.setenv("MINISTARK_TPU_LANES", "interpret")
    ch2 = _CoinChannel(Fp)
    p2 = FriProver(opts, False, hashfn=hash_rpo)
    p2.build_layers(ch2, triple)
    proof2 = p2.into_proof(positions)

    assert ch1.roots == ch2.roots
    assert ch1.remainder == ch2.remainder
    assert _proof_bytes(proof1, Fp) == _proof_bytes(proof2, Fp)
