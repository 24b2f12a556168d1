"""Constraint evaluation over Fq3 (kernel E's Fq3 branch): the port's plain
version and the g++ build of the generated source against the JAX
package's numpy evaluator, on the brainfuck AIR with a random CE-domain
trace and random Fq3 transcript scalars from a numpy seed; the source's
shared powers of X against Python's pow.  Equality is exact (integer field
arithmetic).

torch and the port are imported inside the tests, so collecting this file
stays cheap in every pytest-xdist worker.
"""

import ctypes
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from ministark_tpu.air import Air as JaxAir
from ministark_tpu.air import ProofOptions as JaxOptions
from ministark_tpu.eval import eval_composition_numpy
from ministark_tpu.fields import npfield as nf
from ministark_tpu.fields.scalar import Fq3 as JaxFq3
from ministark_tpu.fields.scalar import P
from ministark_tpu.models.brainfuck import BrainfuckAirConfig as JaxBfConfig
from ministark_tpu.models.brainfuck import BrainfuckClaim as JaxBfClaim
from ministark_tpu.ntt import Domain as JaxDomain

PROGRAM = "++>+++[<+>-]<."
OPTS = dict(num_queries=9, lde_blowup_factor=16, grinding_factor=0,
            fri_folding_factor=4, fri_max_remainder_coeffs=16)


def _fq3s(rng, k):
    return [JaxFq3(*(int(v) for v in rng.integers(0, P, 3, dtype=np.uint64)))
            for _ in range(k)]


def _inputs(trace_len, seed):
    """The JAX AIR, CE points, a random base (17, n) and extension (9, 3, n)
    CE-domain trace, and Fq3 challenges and composition coefficients."""
    rng = np.random.default_rng(seed)
    jair = JaxAir(JaxBfConfig, trace_len, JaxBfClaim(PROGRAM, b"", b"\x05"),
                  JaxOptions(**OPTS))
    n = trace_len * jair.ce_blowup_factor
    dom = JaxDomain(n, 7)
    x = np.array([dom.element(i).v for i in range(n)], dtype=np.uint64)
    base = rng.integers(0, P, size=(17, n), dtype=np.uint64)
    ext = rng.integers(0, P, size=(9, 3, n), dtype=np.uint64)
    challenges = _fq3s(rng, jair.num_challenges())
    coeffs = _fq3s(rng, jair.num_composition_constraint_coeffs())
    return jair, x, base, ext, challenges, coeffs


def _port(jair, challenges, coeffs):
    """The port's AIR and the same transcript as port scalars."""
    from ministark_tpu_torch.air import Air, ProofOptions
    from ministark_tpu_torch.fields.scalar import Fq3
    from ministark_tpu_torch.models.brainfuck import (BrainfuckAirConfig,
                                                      BrainfuckClaim)

    air = Air(BrainfuckAirConfig, jair.trace_len,
              BrainfuckClaim(PROGRAM, b"", b"\x05"), ProofOptions(**OPTS))

    def conv(vs):
        return [Fq3(v.c0.v, v.c1.v, v.c2.v) for v in vs]

    ch = conv(challenges)
    return air, ch, air.gen_hints(ch), conv(coeffs)


@pytest.fixture(scope="module", autouse=True)
def host_builds():
    """The g++ build of the generated source, started before the first test
    so that it compiles while the evaluators run: (source, future of the
    loaded library)."""
    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.air import Air, ProofOptions
    from ministark_tpu_torch.models.brainfuck import (BrainfuckAirConfig,
                                                      BrainfuckClaim)
    from ministark_tpu_torch.ops import build

    air = Air(BrainfuckAirConfig, 64, BrainfuckClaim(PROGRAM, b"", b"\x05"),
              ProofOptions(**OPTS))
    source = teval._plan_for(air)[1]
    with ThreadPoolExecutor(max_workers=1) as ex:
        yield source, ex.submit(build.build_host_library, "eval_bf_check",
                                source)


@pytest.mark.parametrize("trace_len", [64, 128])
def test_eval_ext3_matches_eval_composition_numpy(trace_len):
    """The port's whole Fq3 evaluation (Fp denominators through kernel A's
    plain version, terms through kernel E's) equals the JAX package's eager
    numpy evaluator on the brainfuck AIR."""
    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.fields.convert import from_u64_numpy, to_u64_numpy

    jair, x, base, ext, challenges, coeffs = _inputs(trace_len, 61)
    jext = tuple(nf.to_limbs(ext[:, k]) for k in range(3))
    want = eval_composition_numpy(jair, coeffs, challenges,
                                  jair.gen_hints(challenges), nf.to_limbs(x),
                                  nf.to_limbs(base), jext)
    want = np.stack([nf.from_limbs(np.asarray(lo), np.asarray(hi))
                     for lo, hi in want])
    air, ch, hints, cc = _port(jair, challenges, coeffs)
    got = teval.eval_composition(air, cc, ch, hints, from_u64_numpy(x),
                                 from_u64_numpy(base), from_u64_numpy(ext))
    np.testing.assert_array_equal(to_u64_numpy(got), want)


@pytest.mark.parametrize("groups", [0, 1])
def test_generated_ext3_sources_host_build_match_plain(host_builds, groups):
    """The source generated from the brainfuck DAG, built as host C++ by
    g++, equals the plain version point for point: each group's part and
    their sum (the one launch), and the groups added one after another
    (the launches a group), each group's powers of X from the chain's y
    and r."""
    import torch

    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.fields.convert import from_u64_numpy
    from ministark_tpu_torch.ops import eval as keval

    jair, x, base, ext, challenges, coeffs = _inputs(64, 62)
    air, ch, hints, cc = _port(jair, challenges, coeffs)
    plan, source, _ = teval._plan_for(air)
    assert source == host_builds[0]
    assert len(plan.groups) > 1
    n = x.shape[0]
    rng = np.random.default_rng(63)
    n_fp = sum(1 for k in plan.inv_keys if plan.inv_kind[k] == "fp")
    args = [from_u64_numpy(base), from_u64_numpy(ext), from_u64_numpy(x),
            torch.zeros((len(plan.periodic), n), dtype=torch.int64),
            from_u64_numpy(rng.integers(0, P, size=(n_fp, n),
                                        dtype=np.uint64)),
            from_u64_numpy(rng.integers(
                0, P, size=(len(plan.inv_keys) - n_fp, 3, n),
                dtype=np.uint64)),
            keval.scalar_table(plan, ch, hints, cc, "cpu")]
    want = keval.eval_terms(plan, source, air.ce_blowup_factor, *args)

    lib = host_builds[1].result()
    out = torch.empty((3, n), dtype=torch.int64)
    part = torch.empty((len(plan.groups), 3, n), dtype=torch.int64)
    lib.ms_eval_host.restype = None
    lib.ms_eval_host.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64,
                                                         ctypes.c_int]
    lib.ms_eval_host(*[t.data_ptr() for t in args], part.data_ptr(),
                     out.data_ptr(), n, groups)
    assert torch.equal(out, want)


@pytest.mark.parametrize("trace_len", [64, 2048, 1 << 20])
def test_source_is_one_for_every_trace_length(trace_len, host_builds):
    """The degree adjustments' exponents stay out of the source: brainfuck
    at 2^6, 2^11 and 2^20 rows generates the same text, and its shared
    powers of X are nine, every x^e one of the forms the prologue takes."""
    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.air import Air, ProofOptions
    from ministark_tpu_torch.models.brainfuck import (BrainfuckAirConfig,
                                                      BrainfuckClaim)

    air = Air(BrainfuckAirConfig, trace_len,
              BrainfuckClaim(PROGRAM, b"", b"\x05"), ProofOptions(**OPTS))
    plan, source, _ = teval._plan_for(air)
    assert source == host_builds[0]
    assert len(plan.power_of) == len(plan.powers) == 9
    for e, key in plan.power_of.items():
        a, b = divmod(e, trace_len)
        assert key == (("nm1", a) if b == trace_len - 1 else ("small", a, b))
    assert not [v for what, v, _k in plan.scalars
                if what == "exp" and v != trace_len]


def test_shared_powers_match_pow(host_builds):
    """The generated prologue's shared powers at 2^20 rows, from the g++
    build, equal pow(x, e, P) for the nine brainfuck exponents at random x
    (0 and 1 included)."""
    import torch

    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.air import Air, ProofOptions
    from ministark_tpu_torch.fields.convert import from_u64_numpy, to_u64_numpy
    from ministark_tpu_torch.models.brainfuck import (BrainfuckAirConfig,
                                                      BrainfuckClaim)

    rows = 1 << 20
    air = Air(BrainfuckAirConfig, rows, BrainfuckClaim(PROGRAM, b"", b"\x05"),
              ProofOptions(**OPTS))
    plan = teval._plan_for(air)[0]
    s = torch.zeros(max(plan.num_slots, 1), dtype=torch.int64)
    s[plan.slot[("exp", rows)]] = rows
    rng = np.random.default_rng(64)
    xs = np.concatenate([np.array([0, 1, P - 1], dtype=np.uint64),
                         rng.integers(0, P, size=61, dtype=np.uint64)])
    m = xs.shape[0]
    pw = torch.empty(len(plan.powers) * m, dtype=torch.int64)
    lib = host_builds[1].result()
    lib.ms_eval_powers_host.restype = None
    lib.ms_eval_powers_host.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int64, ctypes.c_void_p]
    xt = from_u64_numpy(xs)
    lib.ms_eval_powers_host(xt.data_ptr(), s.data_ptr(), m, pw.data_ptr())
    got = to_u64_numpy(pw).reshape(len(plan.powers), m)
    assert sorted(plan.power_of) == sorted(
        {0xf00001, 0xc00004, 0x50000b, 0xffffff, 0xf00000, 0x800007,
         0xe00001, 0xc00003, 0x600009})
    for e, key in plan.power_of.items():
        k = plan.powers.index(key)
        assert [int(v) for v in got[k]] == [pow(int(v), e, P) for v in xs]
