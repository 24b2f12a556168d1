"""Constraint evaluation (kernel E) and the DEEP sum (kernel F): the port's
plain versions and the host build of the generated evaluator against the
JAX package's numpy references, and kernel F's DEEP math (csrc/deep.cuh)
built by g++ with a host harness that runs the kernel's lanes, on inputs
from a fixed seed.

torch and the port are imported inside the tests, so collecting this file
stays cheap in every pytest-xdist worker.
"""

import ctypes

import numpy as np
import pytest

from ministark_tpu.air import Air as JaxAir
from ministark_tpu.air import ProofOptions as JaxOptions
from ministark_tpu.eval import eval_composition_numpy
from ministark_tpu.fields import npfield as nf
from ministark_tpu.fields.scalar import Fp as JaxFp
from ministark_tpu.fields.scalar import P
from ministark_tpu.models.fib import FibAirConfig as JaxFibConfig
from ministark_tpu.ntt import Domain as JaxDomain

TRACE_LEN = 128  # the 2^10-value fib trace
OPTS = dict(num_queries=8, lde_blowup_factor=4, grinding_factor=2,
            fri_folding_factor=4, fri_max_remainder_coeffs=16)


def _inputs(seed):
    """A random CE-domain trace, the CE points and transcript scalars."""
    rng = np.random.default_rng(seed)
    claim = JaxFp(int(rng.integers(0, P, dtype=np.uint64)))
    jair = JaxAir(JaxFibConfig, TRACE_LEN, claim, JaxOptions(**OPTS))
    n = TRACE_LEN * jair.ce_blowup_factor
    dom = JaxDomain(n, 7)
    x = np.array([dom.element(i).v for i in range(n)], dtype=np.uint64)
    trace = rng.integers(0, P, size=(8, n), dtype=np.uint64)
    coeffs = [int(v) for v in rng.integers(
        0, P, size=jair.num_composition_constraint_coeffs(), dtype=np.uint64)]
    return jair, x, trace, coeffs


def _port_air(jair):
    from ministark_tpu_torch.air import Air, ProofOptions
    from ministark_tpu_torch.fields.scalar import Fp
    from ministark_tpu_torch.models.fib import FibAirConfig

    return Air(FibAirConfig, TRACE_LEN, Fp(jair.public_inputs.v),
               ProofOptions(**OPTS))


def test_eval_matches_eval_composition_numpy():
    """The port's whole evaluation (denominator inverses through kernel A's
    plain version, terms through kernel E's) equals the JAX package's eager
    numpy evaluator on the fib AIR at 2^10 values."""
    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.fields.convert import from_u64_numpy, to_u64_numpy
    from ministark_tpu_torch.fields.scalar import Fp

    jair, x, trace, coeffs = _inputs(41)
    want = eval_composition_numpy(
        jair, [JaxFp(c) for c in coeffs], [], jair.gen_hints([]),
        nf.to_limbs(x), nf.to_limbs(trace), None)
    want = nf.from_limbs(np.asarray(want[0]), np.asarray(want[1]))
    air = _port_air(jair)
    got = teval.eval_composition(
        air, [Fp(c) for c in coeffs], [], air.gen_hints([]),
        from_u64_numpy(x), from_u64_numpy(trace))
    np.testing.assert_array_equal(to_u64_numpy(got), want)


def test_generated_source_host_build_matches_plain():
    """The CUDA source generated from the fib DAG, built as host C++ by g++,
    equals the plain version point for point."""
    import torch

    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.fields.convert import from_u64_numpy
    from ministark_tpu_torch.ops import build
    from ministark_tpu_torch.ops import eval as keval

    jair, x, trace, _ = _inputs(42)
    air = _port_air(jair)
    plan, source, _ = teval._plan_for(air)
    assert len(plan.groups) == 1  # an Fp AIR's terms form one group
    assert "__global__" in source and "ms_eval_host" in source
    n = x.shape[0]
    rng = np.random.default_rng(43)
    tx, tt = from_u64_numpy(x), from_u64_numpy(trace)
    inv = from_u64_numpy(rng.integers(0, P, size=(len(plan.inv_keys), n),
                                      dtype=np.uint64))
    per = torch.zeros((0, n), dtype=torch.int64)
    ext = torch.zeros((0, 3, n), dtype=torch.int64)
    inv3 = torch.zeros((0, 3, n), dtype=torch.int64)
    s = rng.integers(0, P, size=plan.num_slots, dtype=np.uint64)
    for what, e, _kind in plan.scalars:  # Pow exponents sit in the table
        if what == "exp":
            s[plan.slot[("exp", e)]] = e
    s = from_u64_numpy(s)
    want = keval.eval_terms(plan, source, air.ce_blowup_factor, tt, ext, tx,
                            per, inv, inv3, s)
    lib = build.build_host_library("eval_fib_check", source)
    lib.ms_eval_host.restype = None
    lib.ms_eval_host.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64,
                                                         ctypes.c_int]
    for groups in (0, 1):  # the one launch, and a launch a group
        out = torch.empty(n, dtype=torch.int64)
        part = torch.empty(n, dtype=torch.int64)
        lib.ms_eval_host(*[t.data_ptr() for t in (tt, ext, tx, per, inv, inv3,
                                                  s, part, out)], n, groups)
        assert torch.equal(out, want)


def test_deep_plain_matches_npfield_restatement():
    """Kernel F's contract restated in npfield:
    sum_t alpha_t (ood_t - T_t) inv_t, times (A + B x)."""
    from ministark_tpu_torch.fields.convert import from_u64_numpy, to_u64_numpy
    from ministark_tpu_torch.ops import deep as kdeep

    rng = np.random.default_rng(51)
    T, n = 17, 512
    cols = rng.integers(0, P, size=(T, n), dtype=np.uint64)
    invs = rng.integers(0, P, size=(3, n), dtype=np.uint64)
    which = [t % 2 if t < T - 1 else 2 for t in range(T)]
    s = rng.integers(0, P, size=2 * T + 2, dtype=np.uint64)
    x = rng.integers(0, P, size=n, dtype=np.uint64)

    acc = np.zeros(n, dtype=np.uint64)
    for t in range(T):
        term = nf.mul(nf.mul(nf.sub(np.full(n, s[2 * t], np.uint64), cols[t]),
                             invs[which[t]]), np.full(n, s[2 * t + 1], np.uint64))
        acc = nf.add(acc, term)
    adj = nf.add(np.full(n, s[2 * T], np.uint64),
                 nf.mul(np.full(n, s[2 * T + 1], np.uint64), x))
    want = nf.mul(acc, adj)

    got = kdeep.deep([from_u64_numpy(c) for c in cols],
                     [from_u64_numpy(invs[w]) for w in which],
                     from_u64_numpy(s), from_u64_numpy(x))
    np.testing.assert_array_equal(to_u64_numpy(got), want)


_DEEP_HARNESS = r"""
#include <vector>
#include "deep.cuh"

template <class F>
static void run(const int64_t* plan, const uint64_t* s, const uint64_t* x,
                uint64_t* out, int64_t n, int lanes) {
    typedef typename F::T T;
    std::vector<unsigned char> mem(deep_staged_bytes<F>(plan[0], plan[1]));
    DeepStaged<F> st = deep_staged<F>(plan, s, mem.data());
    deep_stage_terms<F>(plan, st, 0, 1);
    deep_stage_segs<F>(st, 0, 1);
    for (int64_t i = 0; i < n; i++) {
        T r = F::zero();
        for (int lane = 0; lane < lanes; lane++)
            r = F::add(r, deep_lane<F>(st, i, n, lane, lanes));
        F::store(out, i, n, deep_finish<F>(st, r, x[i]));
    }
}

extern "C" void h_deep(const int64_t* plan, const uint64_t* s,
                       const uint64_t* x, uint64_t* out, int64_t n,
                       int lanes, int ext) {
    if (ext)
        run<dp_fq3>(plan, s, x, out, n, lanes);
    else
        run<dp_fp>(plan, s, x, out, n, lanes);
}
"""


@pytest.fixture(scope="module")
def deep_lib():
    from ministark_tpu_torch.ops import build

    lib = build.build_host_library("deep_check", _DEEP_HARNESS)
    lib.h_deep.restype = None
    lib.h_deep.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64,
                                                   ctypes.c_int, ctypes.c_int]
    return lib


def _deep_terms(ext, seed):
    """Toy fib's DEEP terms (16 trace arguments at two points, a
    composition column at a third; 512 points), or toy brainfuck's (49
    trace arguments of 17 Fp and 9 Fq3 columns at two points, 16 Fq3
    composition columns at a third; 1024 points): columns, inverse rows (a
    view of one (3, ...) stack, so terms of a point share storage),
    scalars and x."""
    from ministark_tpu_torch.fields.convert import from_u64_numpy

    rng = np.random.default_rng(seed)

    def rand(*shape):
        return from_u64_numpy(rng.integers(0, P, size=shape, dtype=np.uint64))

    if not ext:
        n, base = 512, rand(8, 512)
        invs = rand(3, n)
        cols = [base[c] for c in range(8) for _ in (0, 1)] + [rand(n)]
        rows = [invs[t % 2] for t in range(16)] + [invs[2]]
        return cols, rows, rand(2 * len(cols) + 2), rand(n)
    n = 1024
    base, extc, comp = rand(17, n), rand(9, 3, n), rand(16, 3, n)
    invs = rand(3, 3, n)
    cols, rows = [], []
    for c in range(26):
        for off in ((0,) if c in (2, 3, 6) else (0, 1)):
            cols.append(base[c] if c < 17 else extc[c - 17])
            rows.append(invs[off])
    cols += [comp[k] for k in range(16)]
    rows += [invs[2]] * 16
    return cols, rows, rand(6 * len(cols) + 6), rand(n)


@pytest.mark.parametrize("lanes", [1, 2, 8])
@pytest.mark.parametrize("ext", [False, True])
def test_deep_host_build_matches_plain(deep_lib, ext, lanes):
    """Kernel F's DEEP math on the host: the plan ``ops.deep.deep_plan``
    makes (terms grouped by inverse row, segments of one column kind), the
    staged scalars and C_g, `lanes` lanes a point, then (A + B x): equal to
    the plain version point for point."""
    import torch

    from ministark_tpu_torch.ops import deep as kdeep

    cols, rows, s, x = _deep_terms(ext, 52 + lanes)
    words, nseg = kdeep.deep_plan(cols, rows, lanes)
    assert nseg >= (5 if ext else 3)  # three points; Fp and Fq3 apart
    plan = torch.tensor(words, dtype=torch.int64)
    n = x.shape[0]
    out = torch.empty((3, n) if ext else (n,), dtype=torch.int64)
    deep_lib.h_deep(plan.data_ptr(), s.data_ptr(), x.data_ptr(),
                    out.data_ptr(), n, lanes, int(ext))
    plain = (kdeep.deep_ext3_plain if ext else kdeep.deep_plain)(cols, rows,
                                                                 s, x)
    assert torch.equal(out, plain)


def test_deep_lanes():
    """Lanes a point: two for Fq3 transcripts, one for Fp ones."""
    from ministark_tpu_torch.ops import deep as kdeep

    assert kdeep.deep_lanes(True) == 2
    assert kdeep.deep_lanes(False) == 1
