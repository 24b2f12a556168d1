"""The multi-process prover's sharded phases (``parallel``) against the
one-process code they stand for, tolerance 0 throughout:

* kernel E's block entry (``eval.eval_composition_block``, the plain
  version here) on every block of the CE domain at d = 2 and 4, the last
  block's halo wrapping to the first, for fib, brainfuck (Fq3) and the
  4-link Rescue chain (periodic columns), against the JAX package's
  ``eval_composition_numpy`` over the whole domain, sliced;
* the generated source's block entry built by g++ (``ms_eval_host_block``)
  against the plain version, on the wrapping block;
* in 2 and 4 CPU ranks over gloo: the sharded OOD sums and DEEP rows
  (``ShardedDeepPolyComposer``) against ``DeepPolyComposer``; the sharded
  tree's ``prove`` and the sharded matrix's ``get_bit_reversed_rows``
  against the one-process tree's and matrix's, at position sets with
  siblings and duplicates across the ranks' shares; and prove_sharded
  with spies (fib and brainfuck at d = 2 and 4, the Rescue chain at
  d = 2, and over RPO-256 trees and coin the fully algebraic fib at d = 2
  and 4 and brainfuck at d = 2, held to the JAX-written
  ``brainfuck_2plus3_rpo.proof``): the golden bytes with the replicated
  constraint evaluation and DEEP composer made to raise, every LDE, tree
  level and FRI layer a rank holds n / d rows, no collective sending more
  than one LDE column from a rank, and an exception inside a sharded
  phase failing the prove.
"""

import ctypes
import functools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import torch_sharded_tasks as tasks

P = tasks.P
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
FIB_OPTS = dict(num_queries=8, lde_blowup_factor=4, grinding_factor=2,
                fri_folding_factor=4, fri_max_remainder_coeffs=16)
BF_OPTS = dict(num_queries=9, lde_blowup_factor=16, grinding_factor=0,
               fri_folding_factor=4, fri_max_remainder_coeffs=16)
RESCUE_OPTS = dict(num_queries=8, lde_blowup_factor=8, grinding_factor=4,
                   fri_folding_factor=4, fri_max_remainder_coeffs=16)
BF_PROGRAM = "++>+++[<+>-]<."


# what each pool runs, in order: (key, task, arguments)
FAILING = ("ministark_tpu_torch.prover:eval_composition_block",
           "ministark_tpu_torch.parallel.composer:"
           "ShardedDeepPolyComposer._total",
           "ministark_tpu_torch.parallel.tree:ShardedMerkleTree._fetch_many")
RUNS = {
    2: [(("deep", "fib"), tasks.deep_phase, ("fib", 85)),
        (("deep", "bf"), tasks.deep_phase, ("bf", 85)),
        (("decommit",), tasks.decommit, (86,)),
        (("prove", "fib"), tasks.prove_shares, ("fib",)),
        (("prove", "bf"), tasks.prove_shares, ("bf",)),
        (("prove", "rescue"), tasks.prove_shares, ("rescue",)),
        (("prove", "rpo_full"), tasks.prove_shares, ("rpo_full",))]
    + [(("fail", t), tasks.prove_failing, ("fib", t)) for t in FAILING],
    4: [(("deep", "fib"), tasks.deep_phase, ("fib", 85)),
        (("deep", "bf"), tasks.deep_phase, ("bf", 85)),
        (("decommit",), tasks.decommit, (86,)),
        (("prove", "fib"), tasks.prove_shares, ("fib",)),
        (("prove", "bf"), tasks.prove_shares, ("bf",)),
        (("prove", "rpo_full"), tasks.prove_shares, ("rpo_full",))]}


# runs in a spare pool of d = 2 beside the two: brainfuck over RPO-256
# trees takes ~12 s a rank on the CPU (the plain RPO permutation's ~55
# batches), about as long as the first d = 2 pool's other runs together
SPARE = [(("prove", "bf_rpo"), tasks.prove_shares, ("bf_rpo",))]


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """Every run of RUNS and SPARE, the pools working while this process
    runs the tests that need no rank: {(d, key): future of {key: the
    ranks' results (or the exception a run raised)}}.  The spare pool
    starts in its thread while the two start here."""
    def run_all(pool, runs):
        out = {}
        for key, fn, args in runs:
            try:
                out[key] = pool().run(fn, *args)
            except Exception as e:  # the test of this run raises it
                out[key] = e
        return out

    def run_spare(start):
        with start() as pool:
            return run_all(lambda: pool, SPARE)

    with ThreadPoolExecutor(len(RUNS) + 1) as ex:
        spare = ex.submit(run_spare, tasks.spare_pool(tmp_path_factory, 2))
        pools = tasks.Pools(tmp_path_factory)
        futures = {(2, key): spare for key, _f, _a in SPARE}
        for d, runs in RUNS.items():
            done = ex.submit(run_all, lambda d=d: pools(d), runs)
            futures.update({(d, key): done for key, _f, _a in runs})
        yield futures
    pools.close()


def _ranks(ranks, d, *key):
    out = ranks[d, key].result()[key]
    if isinstance(out, Exception):
        raise out
    return out


def _port_air(which, trace_len, public):
    """The port's AIR of `which` ("fib", "bf", "rescue")."""
    from ministark_tpu_torch.air import Air, ProofOptions

    if which == "fib":
        from ministark_tpu_torch.fields.scalar import Fp
        from ministark_tpu_torch.models.fib import FibAirConfig

        return Air(FibAirConfig, trace_len, Fp(public), ProofOptions(
            **FIB_OPTS))
    if which == "bf":
        from ministark_tpu_torch.models.brainfuck import (BrainfuckAirConfig,
                                                          BrainfuckClaim)

        return Air(BrainfuckAirConfig, trace_len,
                   BrainfuckClaim(BF_PROGRAM, b"", b"\x05"),
                   ProofOptions(**BF_OPTS))
    from ministark_tpu_torch.models.rescue import RescueAirConfig

    return Air(RescueAirConfig, trace_len, public, ProofOptions(**RESCUE_OPTS))


@pytest.fixture(scope="module")
def host_builds():
    """The g++ builds of the fib and Rescue sources, started before the
    tests that read them: {which: (source, future of the library)}."""
    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.ops import build

    sources = {w: teval._plan_for(_port_air(w, 64, pub))[1]
               for w, pub in (("fib", 0), ("rescue", (7, 8, 1, 2)))}
    with ThreadPoolExecutor(max_workers=2) as ex:
        yield {w: (src, ex.submit(build.build_host_library,
                                  f"eval_{w}_block_check", src))
               for w, src in sources.items()}


@functools.lru_cache(maxsize=None)
def _whole(which):
    """(port AIR, port transcript, CE points, base (nb, n), ext (ne, 3, n)
    or None, and eval_composition_numpy's values over the whole domain)
    for a random CE-domain trace of `which` at 64 rows."""
    from ministark_tpu.air import Air as JaxAir
    from ministark_tpu.air import ProofOptions as JaxOptions
    from ministark_tpu.eval import eval_composition_numpy
    from ministark_tpu.fields import npfield as nf
    from ministark_tpu.fields.scalar import Fp as JaxFp
    from ministark_tpu.fields.scalar import Fq3 as JaxFq3
    from ministark_tpu.ntt import Domain as JaxDomain
    from ministark_tpu_torch.air import Challenges
    from ministark_tpu_torch.fields.scalar import Fp, Fq3

    rng = np.random.default_rng({"fib": 81, "bf": 82, "rescue": 83}[which])
    T = 64
    if which == "fib":
        from ministark_tpu.models.fib import FibAirConfig as JaxConfig

        public = int(rng.integers(0, P, dtype=np.uint64))
        jair = JaxAir(JaxConfig, T, JaxFp(public), JaxOptions(**FIB_OPTS))
    elif which == "bf":
        from ministark_tpu.models.brainfuck import BrainfuckAirConfig
        from ministark_tpu.models.brainfuck import BrainfuckClaim

        public = None
        jair = JaxAir(BrainfuckAirConfig, T,
                      BrainfuckClaim(BF_PROGRAM, b"", b"\x05"),
                      JaxOptions(**BF_OPTS))
    else:
        from ministark_tpu.models.rescue import RescueAirConfig

        public = tuple(int(v) for v in rng.integers(0, P, 4, dtype=np.uint64))
        jair = JaxAir(RescueAirConfig, T, public, JaxOptions(**RESCUE_OPTS))
    air = _port_air(which, T, public)
    n = T * jair.ce_blowup_factor
    assert n == air.ce_domain().size
    dom = JaxDomain(n, 7)
    x = np.array([dom.element(i).v for i in range(n)], dtype=np.uint64)
    base = rng.integers(0, P, size=(air.config.NUM_BASE_COLUMNS, n),
                        dtype=np.uint64)
    ext = None
    if which == "bf":
        ext = rng.integers(0, P, size=(9, 3, n), dtype=np.uint64)

        def fq3s(k):
            return [JaxFq3(*(int(v) for v in rng.integers(0, P, 3,
                                                          dtype=np.uint64)))
                    for _ in range(k)]
        challenges = fq3s(jair.num_challenges())
        coeffs = fq3s(jair.num_composition_constraint_coeffs())
        ch = [Fq3(v.c0.v, v.c1.v, v.c2.v) for v in challenges]
        cc = [Fq3(v.c0.v, v.c1.v, v.c2.v) for v in coeffs]
        jext = tuple(nf.to_limbs(ext[:, k]) for k in range(3))
    else:
        challenges, ch = [], Challenges()
        coeffs = [JaxFp(int(v)) for v in rng.integers(
            0, P, jair.num_composition_constraint_coeffs(), dtype=np.uint64)]
        cc = [Fp(v.v) for v in coeffs]
        jext = None
    want = eval_composition_numpy(jair, coeffs, challenges,
                                  jair.gen_hints(challenges), nf.to_limbs(x),
                                  nf.to_limbs(base), jext)
    if which == "bf":
        want = np.stack([nf.from_limbs(np.asarray(lo), np.asarray(hi))
                         for lo, hi in want])
    else:
        want = nf.from_limbs(np.asarray(want[0]), np.asarray(want[1]))
    return air, (cc, ch, air.gen_hints(ch)), x, base, ext, want


def _window(a, start, count):
    """a[..., start:start + count], wrapping round the last axis."""
    return np.take(a, np.arange(start, start + count) % a.shape[-1], axis=-1)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("which", ["fib", "bf", "rescue"])
def test_block_entry_matches_eval_composition_numpy(which, d):
    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.fields.convert import from_u64_numpy, to_u64_numpy

    air, (cc, ch, hints), x, base, ext, want = _whole(which)
    n, h = x.shape[0], teval.trace_halo(air)
    assert h == air.ce_blowup_factor  # every AIR here reads the next row
    m = n // d
    for q in range(d):  # the last block's halo wraps to the first
        got = teval.eval_composition_block(
            air, cc, ch, hints, from_u64_numpy(x[q * m:(q + 1) * m]),
            from_u64_numpy(_window(base, q * m, m + h)),
            None if ext is None else from_u64_numpy(
                _window(ext, q * m, m + h)))
        np.testing.assert_array_equal(to_u64_numpy(got),
                                      want[..., q * m:(q + 1) * m])


@pytest.mark.parametrize("groups", [0, 1])
@pytest.mark.parametrize("which", ["fib", "rescue"])
def test_block_entry_host_build_matches_plain(host_builds, which, groups):
    """The generated source's block entry, built as host C++ by g++, on
    the last block at d = 4 (its halo wrapped), equals the plain version:
    both ways of launching (a launch a group, one launch and a sum)."""
    import torch

    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.fields.convert import from_u64_numpy
    from ministark_tpu_torch.ops import eval as keval

    air, _t, x, base, _e, _w = _whole(which)
    plan, source, _ = teval._plan_for(air)
    assert source == host_builds[which][0]
    n, h = x.shape[0], teval.trace_halo(air)
    m = n // 4
    rng = np.random.default_rng(84)

    def rand(*shape):
        return from_u64_numpy(rng.integers(0, P, size=shape, dtype=np.uint64))

    s = rand(plan.num_slots)
    for what, e, _kind in plan.scalars:
        if what == "exp":
            s[plan.slot[("exp", e)]] = e
    args = [from_u64_numpy(_window(base, 3 * m, m + h)),
            torch.zeros((0, 3, m + h), dtype=torch.int64),
            from_u64_numpy(x[3 * m:]), rand(len(plan.periodic), m),
            rand(len(plan.inv_keys), m), torch.zeros((0, 3, m),
                                                     dtype=torch.int64), s]
    want = keval.eval_terms_block(plan, source, air.ce_blowup_factor, *args)
    lib = host_builds[which][1].result()
    lib.ms_eval_host_block.restype = None
    lib.ms_eval_host_block.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
    out = torch.empty(m, dtype=torch.int64)
    part = torch.empty((len(plan.groups), m), dtype=torch.int64)
    lib.ms_eval_host_block(*[t.data_ptr() for t in args], part.data_ptr(),
                           out.data_ptr(), m, m + h, groups)
    assert torch.equal(out, want)
    # the whole-domain entry at the same points reads them modulo n
    whole = keval.eval_terms_plain(
        plan, air.ce_blowup_factor, from_u64_numpy(base),
        torch.zeros((0, 3, n), dtype=torch.int64), from_u64_numpy(x),
        torch.cat([rand(len(plan.periodic), n - m), args[3]], -1),
        torch.cat([rand(len(plan.inv_keys), n - m), args[4]], -1),
        torch.zeros((0, 3, n), dtype=torch.int64), s, points=(n - m, n))
    assert torch.equal(whole, want)


@pytest.mark.parametrize("which,d", [("fib", 2), ("fib", 4), ("bf", 2),
                                     ("bf", 4)])
def test_sharded_ood_and_deep_match_one_process(ranks, which, d):
    out = _ranks(ranks, d, "deep", which)
    one = out[0]["one"]
    for rank, r in enumerate(out):
        assert r["one"]["oods"] == one["oods"]
        assert r["sharded"]["oods"] == one["oods"]
        np.testing.assert_array_equal(r["sharded"]["deep"],
                                      one["deep"][..., rank::d])


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_tree_prove_matches_one_process(ranks, d):
    for r in _ranks(ranks, d, "decommit"):
        assert r["root"][0] == r["root"][1]
        assert r["build_collectives"] == 1  # the d subtree roots
        for k, (one, mine) in enumerate(r["proofs"]):
            assert mine == one, tasks.POSITION_SETS[k]
        # one gather a tree proof and one a matrix
        assert r["decommit_collectives"] == 3 * len(tasks.POSITION_SETS)


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_matrix_rows_match_one_process(ranks, d):
    for r in _ranks(ranks, d, "decommit"):
        for k, rows in enumerate(r["rows"]):
            for one, mine in rows:  # Fp, then Fq3
                assert mine == one, tasks.POSITION_SETS[k]


def _golden(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("which,d,golden", [
    ("fib", 2, "fib_2e10.proof"), ("fib", 4, "fib_2e10.proof"),
    ("bf", 2, "brainfuck_2plus3.proof"), ("bf", 4, "brainfuck_2plus3.proof"),
    ("rescue", 2, "rescue_4links.proof"),
    ("rpo_full", 2, "fib_2e7_rpo_full.proof"),
    ("rpo_full", 4, "fib_2e7_rpo_full.proof"),
    ("bf_rpo", 2, "brainfuck_2plus3_rpo.proof")])
def test_prove_holds_a_share_and_sends_at_most_a_column(ranks, which, d,
                                                        golden):
    """The golden bytes with the one-process constraint evaluation and DEEP
    composer made to raise; every LDE matrix, composition matrix and FRI
    layer a rank commits holds n / d rows and n / d leaves, its sharded
    tree levels a d-th of each level, and no collective sends more than
    one LDE column (n elements, Fq3 three words each) from a rank."""
    out = _ranks(ranks, d, "prove", which)
    want = _golden(golden)
    for r in out:
        assert r["proof"] == want
        n = r["lde_n"]
        kinds = [s[0] for s in r["seen"]]
        ext = which.startswith("bf")
        assert kinds.count("lde") == (3 if ext else 2)
        assert "fri" in kinds
        for kind, size, local, levels, split in r["seen"]:
            rows = local[-1] if kind == "lde" or len(local) == 3 else local[0]
            assert rows * d == size and (kind == "fri" or size == n)
            assert levels[0][0] * d == size
            for k, lv in enumerate(levels):
                assert lv[0] == (size >> k) // (d if k < split else 1)
            assert levels[split][0] == d
        assert r["max_bytes"] <= 8 * n * (3 if ext else 1)


@pytest.mark.parametrize("target", FAILING)
def test_an_exception_in_a_sharded_phase_fails_the_prove(ranks, target):
    """Constraint evaluation, the OOD sums and the decommit: no phase falls
    back to its replicated form on an exception."""
    with pytest.raises(RuntimeError, match="fails on purpose"):
        _ranks(ranks, 2, "fail", target)
