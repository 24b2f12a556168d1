"""Constraint evaluation over Fq3 (kernel E's Fq3 branch): the port's plain
version and the g++ build of the generated per-group sources against the
JAX package's numpy evaluator, on the brainfuck AIR with a random CE-domain
trace and random Fq3 transcript scalars from a numpy seed.  Equality is
exact (integer field arithmetic).

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
    """The g++ builds of the generated group sources, started before the
    first test so that they compile while the evaluators run: (sources,
    futures of the loaded libraries)."""
    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.air import Air, ProofOptions
    from ministark_tpu_torch.models.brainfuck import (BrainfuckAirConfig,
                                                      BrainfuckClaim)
    from ministark_tpu_torch.ops import build

    air = Air(BrainfuckAirConfig, 64, BrainfuckClaim(PROGRAM, b"", b"\x05"),
              ProofOptions(**OPTS))
    sources = teval._plan_for(air)[1]
    with ThreadPoolExecutor(max_workers=len(sources)) as ex:
        yield sources, [
            ex.submit(build.build_host_library, f"eval_bf_check{g}", s)
            for g, s in enumerate(sources)]


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


def test_generated_ext3_sources_host_build_match_plain(host_builds):
    """Each term group's generated source, built as host C++ by g++, adds
    its terms into one output; the sum of all groups equals the plain
    version point for point."""
    import torch

    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.fields.convert import from_u64_numpy
    from ministark_tpu_torch.ops import eval as keval

    jair, x, base, ext, challenges, coeffs = _inputs(64, 62)
    air, ch, hints, cc = _port(jair, challenges, coeffs)
    plan, sources, _ = teval._plan_for(air)
    assert sources == host_builds[0]
    assert len(sources) == len(plan.groups) > 1
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
    want = keval.eval_terms(plan, sources, air.ce_blowup_factor, *args)

    out = torch.empty((3, n), dtype=torch.int64)
    for g, built in enumerate(host_builds[1]):
        lib = built.result()
        lib.ms_eval_host.restype = None
        lib.ms_eval_host.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64,
                                                             ctypes.c_int]
        lib.ms_eval_host(*[t.data_ptr() for t in args], out.data_ptr(), n,
                         int(g > 0))
    assert torch.equal(out, want)
