"""The RPO-256 slice: the port's RPO parameters, permutation, row hashes,
merges, trees and grind against the JAX package's exact host scalars
(``ministark_tpu.hash_rpo``), and the fully algebraic proves end to end.

* The port proves fib at 2^7 values in two configurations (RPO trees and
  RPO coin; RPO trees and the SHA-256 coin) and the brainfuck program
  ``"++[>+<-]>."`` (32 rows) with RPO trees and coin at the golden
  brainfuck options, on the CPU, in subprocesses that block ``jax`` and
  ``ministark_tpu`` (``sys.modules[name] = None``) before importing the
  port.  Each checks that the port's verifier rejects a tampered copy and
  reports the proof bytes and the modules it loaded; this process holds
  the bytes against the JAX package's verifier, given ``Stark`` subclasses
  with the same hash knobs, and against ``tests/golden/
  fib_2e7_rpo_full.proof`` (written by the JAX package,
  ``scripts/make_golden_rpo.py``).
* The three subprocesses start with the first test, so they prove while
  this process runs the host checks.

The plain permutation is some 16,000 elementwise torch operations a batch
on the CPU, so the proves stay at these sizes.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ministark_tpu import hash_rpo as jrpo
from ministark_tpu.fields.scalar import Fp, P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "fib_2e7_rpo_full.proof")
# a loop, both pointer moves and an output in 32 rows, the shortest trace
# the brainfuck AIR takes at blowup 16: each halving of the rows roughly
# halves the plain RPO work of the prove
PROGRAM = "++[>+<-]>."

_PORT_PRELUDE = r"""
import json, sys
sys.modules["jax"] = None            # any import of JAX now fails
sys.modules["ministark_tpu"] = None  # and so does any of the JAX package
from ministark_tpu_torch import hash_rpo
from ministark_tpu_torch.air import ProofOptions
from ministark_tpu_torch.fields.scalar import Fp, Fq3
from ministark_tpu_torch.proof import Proof
from ministark_tpu_torch.verifier import VerificationError


def tampered_rejected(claim, data, fq, bits):
    bad = bytearray(data)
    bad[21] ^= 1  # first byte of the base trace commitment
    try:
        claim.verify(Proof.from_bytes(bytes(bad), Fp, fq), bits)
    except VerificationError:
        return True
    return False


def loaded():
    return sorted(m for m, v in sys.modules.items() if v is not None and (
        m.split(".")[0] in ("jax", "jaxlib", "ministark_tpu")))
"""

_PORT_FIB = _PORT_PRELUDE + r"""
from ministark_tpu_torch.models.fib import FibClaim, gen_trace


class FibClaimRpoFull(FibClaim):
    merkle_hash = hash_rpo
    coin_hash = hash_rpo


class FibClaimRpo(FibClaim):
    merkle_hash = hash_rpo


cls, opts = {"rpo_full": (FibClaimRpoFull, ProofOptions(8, 4, 3, 4, 4)),
             "rpo_trees": (FibClaimRpo, ProofOptions(8, 4, 0, 4, 4))}[
                 sys.argv[1]]
trace = gen_trace(128, device="cpu")
claim = cls(trace.last_value())
data = claim.prove(opts, trace).to_bytes(Fp)
claim.verify(Proof.from_bytes(data, Fp, Fp), 8)
print(json.dumps({"last": trace.last_value().v, "proof": data.hex(),
                  "rejected": tampered_rejected(claim, data, Fp, 8),
                  "loaded": loaded()}))
"""

_PORT_BF = _PORT_PRELUDE + r"""
from ministark_tpu_torch.models.brainfuck import (BrainfuckClaim,
                                                  BrainfuckTrace, simulate)


class BrainfuckClaimRpo(BrainfuckClaim):
    merkle_hash = hash_rpo
    coin_hash = hash_rpo


program = sys.argv[2]
tables, output = simulate(program)
claim = BrainfuckClaimRpo(program, b"", output)
data = claim.prove(ProofOptions(9, 16, 0, 4, 16),
                   BrainfuckTrace(tables, device="cpu")).to_bytes(Fq3)
print(json.dumps({"proof": data.hex(), "output": output.hex(),
                  "rejected": tampered_rejected(claim, data, Fq3, 16),
                  "loaded": loaded()}))
"""


class _PortRuns:
    """The three subprocess proves (the fib configurations "rpo_full" and
    "rpo_trees", and "bf"), started together; ``result(name)`` waits for
    one and parses its last line."""

    def __init__(self):
        env = dict(os.environ, PYTHONPATH=ROOT, MINISTARK_TPU_TIMERS="0",
                   OMP_NUM_THREADS="1")
        self.procs = {
            name: subprocess.Popen(
                [sys.executable, "-c", script, name, PROGRAM], cwd=ROOT,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
            for name, script in (("bf", _PORT_BF), ("rpo_full", _PORT_FIB),
                                 ("rpo_trees", _PORT_FIB))}
        self.results = {}

    def result(self, name):
        if name not in self.results:
            out, err = self.procs[name].communicate(timeout=300)
            assert self.procs[name].returncode == 0, err[-4000:]
            self.results[name] = json.loads(out.strip().splitlines()[-1])
        return self.results[name]

    def close(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def port_runs():
    runs = _PortRuns()
    try:
        yield runs
    finally:
        runs.close()


def _states(seed, n):
    """n numpy-seeded states plus the boundary states 0, 1, p - 1,
    2^32 - 1 and 2^32 + 1 in every element: (12, n + 5) uint64."""
    rng = np.random.default_rng(seed)
    st = rng.integers(0, P, (12, n), dtype=np.uint64)
    edge = np.array([0, 1, P - 1, (1 << 32) - 1, (1 << 32) + 1], np.uint64)
    return np.concatenate([st, np.broadcast_to(edge, (12, 5))], axis=1)


def _t(a):
    from ministark_tpu_torch.fields.convert import from_u64_numpy

    return from_u64_numpy(a)


def test_parameters_match_jax_package():
    """The MDS row and round constants, converted from Montgomery form with
    the port's own R^-1, are the JAX package's values."""
    from ministark_tpu.ops import rpo256 as jops

    from ministark_tpu_torch.ops import rpo256 as krpo

    assert krpo.MDS_FIRST_ROW == jops.MDS_FIRST_ROW
    np.testing.assert_array_equal(krpo.MDS, jops.MDS)
    np.testing.assert_array_equal(krpo.ROUND_CONSTANTS_0,
                                  jops.ROUND_CONSTANTS_0)
    np.testing.assert_array_equal(krpo.ROUND_CONSTANTS_1,
                                  jops.ROUND_CONSTANTS_1)


def test_permute_plain_matches_host_permutation():
    from ministark_tpu_torch.ops import rpo256 as krpo

    st = _states(1, 16)
    got = krpo.permute_plain(_t(st)).numpy().view(np.uint64)
    for i in range(st.shape[1]):
        want = jrpo._permute([int(v) for v in st[:, i]])
        assert [int(v) for v in got[:, i]] == want, i


_HOST_HARNESS = r"""
#include "rpo256.cuh"
extern "C" void h_permute(uint64_t* s, long n) {
    for (long i = 0; i < n; i++) rpo_permute(s + RPO_WIDTH * i);
}
extern "C" int h_leading_zeros(const uint64_t* d) {
    return rpo_leading_zeros(d);
}
"""


def test_rpo_header_host_build_matches_host_permutation():
    """csrc/rpo256.cuh (the kernel's round math, its constants and its
    x^(1/7) chain) built as host C++ by g++."""
    from ministark_tpu import hash as jH
    from ministark_tpu_torch.ops import build

    lib = build.build_host_library("rpo256_check", _HOST_HARNESS)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.h_permute.argtypes = [u64p, ctypes.c_long]
    lib.h_leading_zeros.argtypes = [u64p]
    st = np.ascontiguousarray(_states(2, 16).T)  # (n, 12), state-major
    want = [jrpo._permute([int(v) for v in row]) for row in st]
    lib.h_permute(st.ctypes.data_as(u64p), st.shape[0])
    assert st.tolist() == want
    for i, row in enumerate(st):
        d = np.ascontiguousarray(row[4:8])
        d[0] &= np.uint64(((1 << 64) - (1 << (4 * i))) % (1 << 64))
        assert lib.h_leading_zeros(d.ctypes.data_as(u64p)) == (
            jH.leading_zeros(d.tobytes()))


@pytest.mark.parametrize("ncols", [1, 3, 8, 9, 16])
def test_hash_rows_match_hash_elements(ncols):
    """Column-major rows (a strided view); 1, 3 and 9 columns pad."""
    from ministark_tpu_torch.ops import rpo256 as krpo

    m = np.random.default_rng(ncols).integers(0, P, (ncols, 4),
                                              dtype=np.uint64)
    got = krpo.hash_rows(_t(m).T).numpy()
    for i in range(m.shape[1]):
        want = jrpo.hash_elements([Fp(int(v)) for v in m[:, i]])
        assert got[i].tobytes() == want, i


@pytest.mark.parametrize("ncols", [1, 3])
def test_hash_rows_ext3_match_hash_elements(ncols):
    """Fq3 rows absorb each element as c0, c1, c2."""
    from ministark_tpu.fields.scalar import Fq3

    from ministark_tpu_torch.ops import rpo256 as krpo

    m = np.random.default_rng(10 + ncols).integers(0, P, (ncols, 3, 4),
                                                   dtype=np.uint64)
    got = krpo.hash_rows_ext3(_t(m)).numpy()
    for i in range(m.shape[2]):
        row = [Fq3(Fp(int(m[c, 0, i])), Fp(int(m[c, 1, i])),
                   Fp(int(m[c, 2, i]))) for c in range(ncols)]
        assert got[i].tobytes() == jrpo.hash_elements(row), i


def test_merge_matches_host_merge():
    import torch

    from ministark_tpu_torch.ops import rpo256 as krpo

    d = np.random.default_rng(5).integers(0, 256, (8, 32), dtype=np.uint8)
    got = krpo.merge(torch.from_numpy(d[:4]), torch.from_numpy(d[4:]))
    for i in range(4):
        assert got[i].numpy().tobytes() == jrpo.merge(d[i].tobytes(),
                                                      d[4 + i].tobytes())


def test_rpo_tree_verifies_with_jax_verifier():
    """A 64-leaf RPO tree: its leaves are hash_elements of the protocol's
    bit-reversed rows, and its root and multi-proof check out with the JAX
    package's host verifier."""
    from ministark_tpu import merkle as jmerkle
    from ministark_tpu.ntt import bit_reverse_index

    from ministark_tpu_torch import hash_rpo, merkle

    vals = np.random.default_rng(3).integers(0, P, (3, 64), dtype=np.uint64)
    tree = merkle.commit_matrix(_t(vals), hash_rpo)
    rows = {i: [Fp(int(v)) for v in vals[:, bit_reverse_index(64, i)]]
            for i in (0, 5, 6, 63)}
    view = tree.prove(list(rows))
    jmerkle.verify_rows(tree.root(), list(rows), list(rows.values()), view,
                        hashfn=jrpo)
    assert view.initial_leaves[0] == jrpo.hash_elements(rows[0])
    with pytest.raises(jmerkle.InvalidProof):
        jmerkle.verify_rows(tree.root(), [0], [rows[5]], tree.prove([0]),
                            hashfn=jrpo)


def test_plain_grind_finds_the_smallest_nonce():
    """The CPU grind (plain permutation batches) finds the same smallest
    nonce as a scan with the JAX package's host coin."""
    from ministark_tpu.random import PublicCoin

    from ministark_tpu_torch.ops import pow as kpow

    seed, bits = bytes(range(32)), 6
    coin = PublicCoin(seed, hashfn=jrpo)
    host = 1
    while not coin.verify_proof_of_work(bits, host):
        host += 1
    assert kpow.grind_rpo(seed, bits, "cpu") == host
    assert kpow.KERNEL.launches == 0


def test_col_ntt_beyond_shared_memory_takes_plain_on_cpu():
    """A column of 2^15 rows (longer than kernel B's tile) on a CPU tensor
    takes the plain version: a DFT per column, checked at a few rows."""
    from ministark_tpu_torch.fields.scalar import get_root_of_unity
    from ministark_tpu_torch.ntt import powers
    from ministark_tpu_torch.ops import ntt as kntt

    n1 = 1 << 15
    w = get_root_of_unity(n1).v
    x = np.random.default_rng(4).integers(0, P, (1, n1, 1), dtype=np.uint64)
    got = kntt.col_ntt(_t(x), powers(w, n1 // 2, "cpu")).numpy()
    xs = [int(v) for v in x[0, :, 0]]
    for k in (0, 1, 12345, n1 - 1):
        wk = pow(w, k, P)
        acc = 0
        for v in reversed(xs):
            acc = (acc * wk + v) % P
        assert int(got[0, k, 0].view(np.uint64)) == acc, k
    assert kntt.KERNEL_STAGE.launches == 0


def _jax_fib_claims():
    from ministark_tpu.models.fib import FibClaim

    class FibClaimRpoFull(FibClaim):
        merkle_hash = jrpo
        coin_hash = jrpo

    class FibClaimRpo(FibClaim):
        merkle_hash = jrpo

    return {"rpo_full": FibClaimRpoFull, "rpo_trees": FibClaimRpo}


@pytest.mark.parametrize("config", ["rpo_full", "rpo_trees"])
def test_jax_verifier_accepts_port_fib_rpo_proofs(port_runs, config):
    from ministark_tpu.proof import Proof

    run = port_runs.result(config)
    claim = _jax_fib_claims()[config](Fp(run["last"]))
    claim.verify(Proof.from_bytes(bytes.fromhex(run["proof"]), Fp, Fp), 8)


def test_port_fib_rpo_proof_matches_jax_golden_bytes(port_runs):
    """The fully algebraic fib proof equals the JAX package's, byte for
    byte (tests/golden/fib_2e7_rpo_full.proof)."""
    with open(GOLDEN, "rb") as f:
        want = f.read()
    got = bytes.fromhex(port_runs.result("rpo_full")["proof"])
    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
    assert got == want, f"first differing byte {first}"


def test_port_verifier_rejects_tampered_rpo_proofs(port_runs):
    for name in ("rpo_full", "rpo_trees", "bf"):
        assert port_runs.result(name)["rejected"], name


def test_port_rpo_runs_never_import_jax(port_runs):
    for name in ("rpo_full", "rpo_trees", "bf"):
        assert port_runs.result(name)["loaded"] == [], name


def test_jax_verifier_accepts_port_brainfuck_rpo_proof(port_runs):
    from ministark_tpu.fields.scalar import Fq3
    from ministark_tpu.models.brainfuck import BrainfuckClaim
    from ministark_tpu.proof import Proof

    class BrainfuckClaimRpo(BrainfuckClaim):
        merkle_hash = jrpo
        coin_hash = jrpo

    run = port_runs.result("bf")
    claim = BrainfuckClaimRpo(PROGRAM, b"", bytes.fromhex(run["output"]))
    claim.verify(Proof.from_bytes(bytes.fromhex(run["proof"]), Fp, Fq3), 16)
