"""The port's Fq3 layer against the JAX package's references.

Fq3 = Fp[u]/(u^3 - 2) on tensors (``fields/device.py``, components on axis
-2), its ``gl3_*`` twins in ``csrc/goldilocks.cuh`` built as host C++ by
g++, and the plain versions of the Fq3 inverse, DEEP sum and row hash
(kernels A, F and D's Fq3 entry points), compared with
``ministark_tpu.fields.npfield``, ``ministark_tpu.fields.scalar.Fq3`` and
``ministark_tpu.hash`` on inputs from a numpy seed.  The affine scan of the
extension columns, its plain version and csrc/scan.cuh built by g++ in the
kernel's schedule, is held against its sequential form.  Equality is exact
(integer field arithmetic).

torch and the port are imported inside the tests, so collecting this file
stays cheap in every pytest-xdist worker.
"""

import ctypes

import numpy as np
import pytest

from ministark_tpu.fields import npfield as nf
from ministark_tpu.fields.scalar import Fp as JaxFp
from ministark_tpu.fields.scalar import Fq3 as JaxFq3
from ministark_tpu.fields.scalar import P

EDGE = [0, 1, 2, P - 1, P - 2, 1 << 32, (1 << 32) - 1, 1 << 63]


def _ext3(seed, n=600):
    """(3, n) numpy u64 components: random elements, elements whose
    components are edge values, and zeros."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, P, size=(3, n), dtype=np.uint64)
    edge = np.array(EDGE, dtype=np.uint64)
    k = len(edge)
    a[:, :k * k] = np.stack([np.repeat(edge, k), np.tile(edge, k),
                             np.roll(np.repeat(edge, k), 3)])
    a[:, -5:] = 0
    a[1:, -10:-5] = 0  # base-field elements
    return a


def _t(a):
    from ministark_tpu_torch.fields.convert import from_u64_numpy

    return from_u64_numpy(np.ascontiguousarray(a))


def _np(t):
    from ministark_tpu_torch.fields.convert import to_u64_numpy

    return to_u64_numpy(t.contiguous())


def _scalars(a):
    return [JaxFq3(int(x), int(y), int(z)) for x, y, z in a.T]


def _components(scalars):
    return np.array([[s.c0.v, s.c1.v, s.c2.v] for s in scalars],
                    dtype=np.uint64).T


E = 0x1234567890ABCDEF


@pytest.mark.parametrize("op", ["add", "sub", "neg", "mul", "mul_base",
                                "from_base", "pow", "inv", "batch_inv"])
def test_plain_ext3_ops_match_npfield(op):
    from ministark_tpu_torch.fields import device as fd

    a, b = _ext3(1), _ext3(2)
    c = b[0]
    ta, tb, tc = _t(a), _t(b), _t(c)
    got = {
        "add": lambda: fd.add(ta, tb),
        "sub": lambda: fd.sub(ta, tb),
        "neg": lambda: fd.neg(ta),
        "mul": lambda: fd.ext3_mul(ta, tb),
        "mul_base": lambda: fd.ext3_mul_base(ta, tc),
        "from_base": lambda: fd.ext3_from_base(tc),
        "pow": lambda: fd.ext3_pow_const(ta, E),
        "inv": lambda: fd.ext3_inv(ta),
        "batch_inv": lambda: fd.ext3_batch_inv(ta),
    }[op]()
    A, B = tuple(a), tuple(b)
    want = {
        "add": lambda: nf.ext3_add(A, B),
        "sub": lambda: nf.ext3_sub(A, B),
        "neg": lambda: nf.ext3_neg(A),
        "mul": lambda: nf.ext3_mul(A, B),
        "mul_base": lambda: nf.ext3_mul(A, nf.ext3_from_base(c)),
        "from_base": lambda: nf.ext3_from_base(c),
        "pow": lambda: nf.ext3_pow_const(A, E),
        "inv": lambda: nf.ext3_inv(A),
        "batch_inv": lambda: nf.ext3_inv(A),
    }[op]()
    np.testing.assert_array_equal(_np(got), np.stack(want))


@pytest.mark.parametrize("op", ["mul", "inv", "pow"])
def test_plain_ext3_ops_match_scalar_fq3(op):
    """Against the JAX package's scalar Fq3 (zeros included; 0 -> 0 for
    the inverse, where the scalar field raises)."""
    from ministark_tpu_torch.fields import device as fd

    a, b = _ext3(3, 80), _ext3(4, 80)
    sa, sb = _scalars(a), _scalars(b)
    if op == "mul":
        got, want = fd.ext3_mul(_t(a), _t(b)), [x * y for x, y in zip(sa, sb)]
    elif op == "pow":
        got, want = fd.ext3_pow_const(_t(a), 1000003), [x ** 1000003
                                                         for x in sa]
    else:
        got = fd.ext3_inv(_t(a))
        want = [JaxFq3.zero() if x.is_zero() else x.inverse() for x in sa]
    np.testing.assert_array_equal(_np(got), _components(want))


_HOST_HARNESS = r"""
#include "goldilocks.cuh"
#define MAP3(name, expr) extern "C" void name(const uint64_t* a, \
    const uint64_t* b, uint64_t* o, long n) { \
    for (long i = 0; i < n; i++) gl3_store(o, i, n, expr); }
MAP3(h3_add, gl3_add(gl3_load(a, i, n), gl3_load(b, i, n)))
MAP3(h3_sub, gl3_sub(gl3_load(a, i, n), gl3_load(b, i, n)))
MAP3(h3_neg, gl3_neg(gl3_load(a, i, n)))
MAP3(h3_mul, gl3_mul(gl3_load(a, i, n), gl3_load(b, i, n)))
MAP3(h3_mul_base, gl3_mul_base(gl3_load(a, i, n), b[i]))
MAP3(h3_add_base, gl3_add_base(gl3_load(a, i, n), b[i]))
MAP3(h3_sub_base, gl3_sub_base(gl3_load(a, i, n), b[i]))
MAP3(h3_from_base, gl3_from_base(b[i]))
MAP3(h3_pow, gl3_pow(gl3_load(a, i, n), 0x1234567890ABCDEFULL))
MAP3(h3_inv, gl3_inv(gl3_load(a, i, n)))
"""


def test_gl3_header_host_build_matches_npfield():
    """The ``gl3_*`` functions of csrc/goldilocks.cuh (the Fq3 kernels'
    math) built as host C++ by g++, zeros included."""
    from ministark_tpu_torch.ops import build

    lib = build.build_host_library("goldilocks3_check", _HOST_HARNESS)
    a, b = _ext3(5), _ext3(6)
    A, B, c = tuple(a), tuple(b), b[0]
    want = {"add": nf.ext3_add(A, B), "sub": nf.ext3_sub(A, B),
            "neg": nf.ext3_neg(A), "mul": nf.ext3_mul(A, B),
            "mul_base": nf.ext3_mul(A, nf.ext3_from_base(c)),
            "add_base": nf.ext3_add(A, nf.ext3_from_base(c)),
            "sub_base": nf.ext3_sub(A, nf.ext3_from_base(c)),
            "from_base": nf.ext3_from_base(c),
            "pow": nf.ext3_pow_const(A, E), "inv": nf.ext3_inv(A)}
    u64p = ctypes.POINTER(ctypes.c_uint64)
    for name, expected in want.items():
        out = np.zeros_like(a)
        fn = getattr(lib, f"h3_{name}")
        fn.restype = None
        fn.argtypes = [u64p, u64p, u64p, ctypes.c_long]
        fn(a.ctypes.data_as(u64p), b.ctypes.data_as(u64p),
           out.ctypes.data_as(u64p), a.shape[1])
        np.testing.assert_array_equal(out, np.stack(expected), err_msg=name)


def test_inv_ext3_plain_matches_scalar_loop():
    """Kernel A's Fq3 entry point, plain version: a (B, 3, n) batch of
    elementwise inverses, 0 -> 0, each times its input is 1."""
    from ministark_tpu_torch.ops import inv as kinv

    a = np.stack([_ext3(7, 64), _ext3(8, 64)])
    got = _np(kinv.inv_ext3(_t(a)))
    for blk in range(2):
        want = [JaxFq3.zero() if x.is_zero() else x.inverse()
                for x in _scalars(a[blk])]
        np.testing.assert_array_equal(got[blk], _components(want))


def test_deep_ext3_plain_matches_scalar_loop():
    """Kernel F's Fq3 contract restated with scalars: sum over terms of
    alpha_t * (ood_t - T_t(x)) * inv_t(x), base-field columns promoted,
    times (A + B * x)."""
    from ministark_tpu_torch.ops import deep as kdeep

    rng = np.random.default_rng(9)
    n, kinds = 32, ["fp", "fq", "fp", "fq", "fq"]
    T = len(kinds)
    cols = [rng.integers(0, P, size=n, dtype=np.uint64) if k == "fp"
            else rng.integers(0, P, size=(3, n), dtype=np.uint64)
            for k in kinds]
    invs = rng.integers(0, P, size=(2, 3, n), dtype=np.uint64)
    which = [t % 2 for t in range(T)]
    s = rng.integers(0, P, size=6 * T + 6, dtype=np.uint64)
    x = rng.integers(0, P, size=n, dtype=np.uint64)
    sc = _scalars(s.reshape(-1, 3).T)

    def col_at(t, i):
        c = cols[t]
        return (JaxFq3.from_base(JaxFp(int(c[i]))) if c.ndim == 1
                else JaxFq3(*(int(v) for v in c[:, i])))

    want = []
    for i in range(n):
        acc = JaxFq3.zero()
        for t in range(T):
            inv = JaxFq3(*(int(v) for v in invs[which[t]][:, i]))
            acc = acc + (sc[2 * t] - col_at(t, i)) * inv * sc[2 * t + 1]
        want.append(acc * (sc[2 * T] + sc[2 * T + 1] * JaxFp(int(x[i]))))

    got = kdeep.deep_ext3([_t(c) for c in cols],
                          [_t(invs[w]) for w in which], _t(s), _t(x))
    np.testing.assert_array_equal(_np(got), _components(want))


@pytest.mark.parametrize("ncols", [1, 9, 16])
def test_hash_rows_ext3_matches_host_hash(ncols):
    """Kernel D over Fq3 rows (the port of ``hash_rows_ext3_lanes``), plain
    version: each row of a (C, 3, n) matrix is the SHA-256 of its elements
    serialized c0 || c1 || c2, as ``ministark_tpu.hash.hash_elements``."""
    from ministark_tpu import hash as jax_hash
    from ministark_tpu_torch.ops import sha256 as ksha

    rng = np.random.default_rng(10 + ncols)
    m = rng.integers(0, P, size=(ncols, 3, 24), dtype=np.uint64)
    got = ksha.hash_rows_ext3(_t(m)).numpy()
    for i in range(m.shape[2]):
        row = [JaxFq3(*(int(v) for v in m[c, :, i])) for c in range(ncols)]
        assert bytes(got[i]) == jax_hash.hash_elements(row), i


@pytest.mark.parametrize("n", [1, 37, 64])
def test_affine_scan_ext3_matches_sequential(n):
    """The batched Hillis-Steele scan against the step-by-step recurrence,
    inclusive and exclusive columns in one batch."""
    import torch

    from ministark_tpu_torch.scan import (affine_scan_ext3,
                                          affine_scan_ext3_sequential)

    rng = np.random.default_rng(20 + n)
    a = _t(rng.integers(0, P, size=(4, 3, n), dtype=np.uint64))
    b = _t(rng.integers(0, P, size=(4, 3, n), dtype=np.uint64))
    init = _t(rng.integers(0, P, size=(4, 3), dtype=np.uint64))
    inclusive = [True, False, False, True]
    got = affine_scan_ext3(a, b, init, inclusive)
    assert torch.equal(got, affine_scan_ext3_sequential(a, b, init, inclusive))
    assert torch.equal(got[1, :, 0], init[1])  # exclusive: the initial state


_SCAN_HARNESS = r"""
#include <vector>
#include "scan.cuh"

// csrc/scan.cu's three launches, one thread at a time.  The block scan as
// the shuffles make it: Hillis-Steele over the lanes of each warp of 32,
// then over the warps; a thread's prefix is the earlier warps' fold, then
// its earlier lanes'.
static void block_scan(const std::vector<aff3>& mine,
                       std::vector<aff3>& prefix, aff3& total) {
    const long T = mine.size(), NW = T / 32;
    std::vector<aff3> incl = mine, warps(NW);
    for (long d = 1; d < 32; d <<= 1) {
        const std::vector<aff3> lo = incl;
        for (long t = 0; t < T; t++)
            if (t % 32 >= d) incl[t] = aff3_then(lo[t - d], incl[t]);
    }
    for (long w = 0; w < NW; w++) warps[w] = incl[32 * w + 31];
    for (long d = 1; d < NW; d <<= 1) {
        const std::vector<aff3> lo = warps;
        for (long w = d; w < NW; w++) warps[w] = aff3_then(lo[w - d], warps[w]);
    }
    prefix.resize(T);
    for (long t = 0; t < T; t++) {
        const aff3 lane = t % 32 ? incl[t - 1] : aff3_identity();
        prefix[t] = t < 32 ? lane : aff3_then(warps[t / 32 - 1], lane);
    }
    total = warps[NW - 1];
}

// A tile of T K elements of a column from t0: staged as the kernel stages
// it (scan_slot) or read in place; each thread's fold (scan_thread_fold),
// or with `in` its walk (scan_thread_walk) from its prefix applied to `in`
template <int K>
static void tile(const uint64_t* ac, const uint64_t* bc, uint64_t* oc, long n,
                 long t0, int T, bool stage, std::vector<aff3>& prefix,
                 aff3& total, const gl3* in, bool inclusive) {
    const long plane = SCAN_PLANE(T, K);
    std::vector<uint64_t> sm(6 * plane);
    if (stage)
        for (int p = 0; p < 6; p++)
            for (int e = 0; e < T * K; e++)
                sm[p * plane + scan_slot(e, K)] =
                    t0 + e >= n ? 0 : p < 3 ? ac[p * n + t0 + e]
                                            : bc[(p - 3) * n + t0 + e];
    const uint64_t* ra = stage ? sm.data() : ac;
    const uint64_t* rb = stage ? sm.data() + 3 * plane : bc;
    const long stride = stage ? plane : n;
    std::vector<aff3> mine(T);
    for (int t = 0; t < T; t++) {
        const long i0 = stage ? scan_slot(t * K, K) : t0 + t * K;
        const long count = scan_count(n, t0 + t * K, K);
        if (in)
            scan_thread_walk<K>(ra, rb, stage ? sm.data() : oc, stride, i0,
                                count, aff3_apply(prefix[t], *in),
                                inclusive);
        else
            mine[t] = scan_thread_fold<K>(ra, rb, stride, i0, count);
    }
    if (!in) block_scan(mine, prefix, total);
    if (in && stage)
        for (int p = 0; p < 3; p++)
            for (int e = 0; e < T * K && t0 + e < n; e++)
                oc[p * n + t0 + e] = sm[p * plane + scan_slot(e, K)];
}

template <int K>
static void run(const uint64_t* a, const uint64_t* b, const uint64_t* init,
                uint64_t mask, uint64_t* out, long B, long n, int T,
                bool stage) {
    const long tpc = scan_tiles(n, (long)T * K);
    for (long c = 0; c < B; c++) {
        const uint64_t* ac = a + c * 3 * n;
        const uint64_t* bc = b + c * 3 * n;
        // 1: each tile's prefixes and fold, as (3, tpc) planes of a and b
        std::vector<std::vector<aff3>> prefixes(tpc);
        std::vector<uint64_t> ta(3 * tpc), tb(3 * tpc), tin(3 * tpc);
        for (long j = 0; j < tpc; j++) {
            aff3 total;
            tile<K>(ac, bc, nullptr, n, j * T * K, T, stage, prefixes[j],
                    total, nullptr, false);
            gl3_store(ta.data(), j, tpc, total.a);
            gl3_store(tb.data(), j, tpc, total.b);
        }
        // 2: the tiles' incoming states, T tiles a round from init
        gl3 s = gl3_load(init, 3 * c, 1);
        for (long t0 = 0; t0 < tpc; t0 += T) {
            std::vector<aff3> mine(T), prefix;
            aff3 total;
            for (int t = 0; t < T; t++)
                mine[t] = scan_thread_fold<1>(ta.data(), tb.data(), tpc,
                                              t0 + t, scan_count(tpc, t0 + t,
                                                                 1));
            block_scan(mine, prefix, total);
            for (int t = 0; t < T; t++)
                scan_thread_walk<1>(ta.data(), tb.data(), tin.data(), tpc,
                                    t0 + t, scan_count(tpc, t0 + t, 1),
                                    aff3_apply(prefix[t], s), false);
            s = aff3_apply(total, s);
        }
        // 3: each tile's walks from its incoming state
        for (long j = 0; j < tpc; j++) {
            aff3 total;
            const gl3 in = gl3_load(tin.data(), j, tpc);
            tile<K>(ac, bc, out + c * 3 * n, n, j * T * K, T, stage,
                    prefixes[j], total, &in, (mask >> c) & 1);
        }
    }
}

extern "C" int host_scan(const uint64_t* a, const uint64_t* b,
                         const uint64_t* init, uint64_t mask, uint64_t* out,
                         long B, long n, long K, long T, long stage) {
    if (T % 32) return 1;
    if (K == SCAN_K) run<SCAN_K>(a, b, init, mask, out, B, n, (int)T, stage);
    else if (K == 2) run<2>(a, b, init, mask, out, B, n, (int)T, stage);
    else return 1;
    return 0;
}

extern "C" long host_scan_shape(long which) {
    return which == 0 ? SCAN_THREADS : SCAN_K;
}
"""


@pytest.mark.parametrize("n", [1, 2, 31, 255, 257, 4097, 1 << 13])
def test_scan_header_host_build_matches_sequential(n):
    """csrc/scan.cuh's compose, apply and per-thread walks, run by a host
    loop in the kernel's schedule (three launches: tiles staged as the
    kernel stages them or read in place, lanes and warps, the tiles' scan
    from init T tiles a round) at the shipped threads and elements a thread
    and at 32 threads of 2 (up to 128 tiles a column), against the
    step-by-step recurrence and the plain version: nine columns with
    brainfuck's mixed inclusive flags, a nonzero init, a and b holding 0, 1
    and p - 1."""
    import torch

    from ministark_tpu_torch.models.brainfuck.trace import _INCLUSIVE
    from ministark_tpu_torch.ops import build
    from ministark_tpu_torch.ops.scan import inclusive_mask
    from ministark_tpu_torch.scan import (affine_scan_ext3,
                                          affine_scan_ext3_sequential)

    lib = build.build_host_library("scan_check", _SCAN_HARNESS)
    rng = np.random.default_rng(30 + n)
    a = rng.integers(0, P, size=(9, 3, n), dtype=np.uint64)
    b = rng.integers(0, P, size=(9, 3, n), dtype=np.uint64)
    for m in (a, b):
        m[:, :, rng.random(n) < 0.1] = 0
        m[:, 0, rng.random(n) < 0.1] = 1
        m[:, 1:, rng.random(n) < 0.1] = P - 1
    init = rng.integers(1, P, size=(9, 3), dtype=np.uint64)
    want = affine_scan_ext3_sequential(_t(a), _t(b), _t(init), _INCLUSIVE)
    assert torch.equal(affine_scan_ext3(_t(a), _t(b), _t(init), _INCLUSIVE),
                       want)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.host_scan.argtypes = [u64p, u64p, u64p, ctypes.c_uint64, u64p,
                              *[ctypes.c_long] * 5]
    lib.host_scan_shape.restype = ctypes.c_long
    threads, k = lib.host_scan_shape(0), lib.host_scan_shape(1)
    for T, K, stage in ((threads, k, 1), (threads, k, 0), (32, 2, 1)):
        out = np.zeros_like(a)
        assert lib.host_scan(a.ctypes.data_as(u64p), b.ctypes.data_as(u64p),
                             init.ctypes.data_as(u64p),
                             inclusive_mask(_INCLUSIVE, 9),
                             out.ctypes.data_as(u64p), 9, n, K, T, stage) == 0
        np.testing.assert_array_equal(out, _np(want),
                                      err_msg=f"T={T} K={K} stage={stage}")


def test_scan_kernel_wrapper_checks():
    """ops/scan.py: the inclusive flags as the kernel's bit mask, and the
    checks that raise before any launch (a CPU tensor, shapes that are not
    (B, 3, n) and (B, 3), more columns than the mask holds, a flag a
    column missing)."""
    import torch

    from ministark_tpu_torch.models.brainfuck.trace import _INCLUSIVE
    from ministark_tpu_torch.ops import scan as kscan

    assert kscan.inclusive_mask(True, 3) == 0b111
    assert kscan.inclusive_mask(False, 2) == 0
    assert kscan.inclusive_mask(_INCLUSIVE, 9) == 0b111100000
    with pytest.raises(ValueError, match="flags"):
        kscan.inclusive_mask([True], 2)
    z = torch.zeros((2, 3, 5), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        kscan.affine_scan_ext3(z, z, z[:, :, 0], True)
    for a, init in ((z[:, :2], z[:, :, 0]), (z, z[:1, :, 0]),
                    (z[0], z[:, :, 0])):
        with pytest.raises(ValueError, match="needs"):
            kscan.affine_scan_ext3(a, a, init, True)
    many = torch.zeros((65, 3, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="columns"):
        kscan.affine_scan_ext3(many, many, many[:, :, 0], True)
    with pytest.raises(ValueError, match="flags"):
        kscan.affine_scan_ext3(z, z, z[:, :, 0], [True])
