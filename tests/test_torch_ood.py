"""The OOD barycentric sums, kernel F's second entry point, on the CPU: the
plain version (``ops.deep.ood_sums_plain``, ``ood_sums_ext3_plain``)
against a numpy restatement of S[j][c] = sum_i col_c[i] inv_j[i] g^i
(``ministark_tpu.fields.npfield``), and the kernel's math (csrc/deep.cuh)
built by g++ with a host harness that runs the kernel's schedule: the
groups ``ops.deep.ood_groups`` makes, each chunk of points a block of
threads, each thread's products in unreduced 160-bit accumulators and g^i
made from the first power and a step, one partial a pair and chunk, then
the sum of the partials.  Shapes are toy fib (8 + 1 columns, 512 points)
and brainfuck (17 + 9 + 16 columns, 1024 points) ones, both on a rank's
cyclic share, and awkward ones; the accumulators are also run over a
thread's longest run on every input p - 1.  Inputs are numpy draws from a
fixed seed; equality is exact.  No JAX compile.
"""

import ctypes

import numpy as np
import pytest

from ministark_tpu.fields import npfield as nf
from ministark_tpu.fields.scalar import P

_HARNESS = r"""
#include <vector>
#include "deep.cuh"

// The kernel's schedule (csrc/deep.cu ood_kernel) one thread at a time:
// block (group, chunk) of T threads, thread t taking points a + t + k T,
// its first power from the table g^(2^b) (ood_pow2_table on gpow[0],
// gpow[1]) and then one product by g^T a point; the threads' reduced sums
// added, one partial a pair and chunk, then the chunks' sum.
template <bool EXT, int K, bool KARA, int Q, int P, int W>
static void run_block(const OodRec<P, W>& r, int64_t a, int64_t b,
                      int64_t n, const uint64_t* tbl, uint64_t first, int T,
                      int logT, uint64_t* partial, int64_t chunk_i,
                      int64_t pairs) {
    constexpr bool KA = KARA && K == 1;
    constexpr int A = OOD_ACCS(EXT, KA);
    const int64_t np = r.pairs();
    std::vector<gl3> sums(Q, gl3_from_base(0));
    std::vector<uint64_t> wt(OOD_WEIGHT_WORDS(EXT, KARA) * W);
    for (int t = 0; t < T; t++) {
        ood_acc acc[Q * A];
        for (int p = 0; p < Q * A; p++) ood_acc_zero(acc[p]);
        uint64_t gi = ood_power(tbl, first, t);
        for (int64_t i = a + t; i < b; i += T) {
            if (EXT)
                ood_point_fq3<Q, P, W, K, KARA>(r, (uint32_t)i, (uint32_t)n,
                                                gi, acc, wt.data(), 1);
            else
                ood_point_fp<P, W>(r, (uint32_t)i, gi, acc, wt.data(), 1);
            gi = gl_mul_cc_lazy(gi, tbl[logT]);
        }
        for (int p = 0; p < np; p++)
            sums[p] = gl3_add(sums[p],
                              EXT ? ood_finish_fq3<KA>(acc + p * A)
                                  : gl3_from_base(ood_acc_reduce(acc[p])));
    }
    const int slots = EXT ? 3 : 1;
    for (int p = 0; p < np; p++)
        for (int k = 0; k < slots; k++)
            partial[ood_partial_index(chunk_i, k, r.out(p), pairs, slots)] =
                dp_fq3::plane(sums[p], k);
}

template <bool EXT, bool KARA, int P, int P0, int W>
static void run(const int64_t* recs, int64_t groups, const uint64_t* gpow,
                uint64_t* partial, uint64_t* out, int64_t n, int64_t chunks,
                int64_t pairs, int T) {
    constexpr int RP = P > P0 ? P : P0;
    int logT = 0;
    while ((1 << logT) < T) logT++;
    uint64_t tbl[32];
    ood_pow2_table(gpow[0], gpow[n > 1 ? 1 : 0], n, tbl);
    const int64_t chunk = (n + chunks - 1) / chunks;
    for (int64_t g = 0; g < groups; g++) {
        const OodRec<RP, W> r{recs + g * OOD_RECORD(RP, W)};
        for (int64_t c = 0; c < chunks; c++) {
            const int64_t a = c * chunk, b = a + chunk < n ? a + chunk : n;
            const uint64_t first = ood_power(tbl, gpow[0], a);
            if (EXT && r.kind())
                run_block<EXT, 1, KARA, P, RP, W>(r, a, b, n, tbl, first, T,
                                                  logT, partial, c, pairs);
            else
                run_block<EXT, 0, KARA, P0, RP, W>(r, a, b, n, tbl, first, T,
                                                   logT, partial, c, pairs);
        }
    }
    const int64_t K = (EXT ? 3 : 1) * pairs;
    for (int64_t k = 0; k < K; k++) {
        uint64_t v = 0;
        for (int64_t c = 0; c < chunks; c++) v = gl_add(v, partial[c * K + k]);
        out[k] = v;
    }
}

// kara: 1 Karatsuba, 0 the schoolbook, -1 the shipped form (OOD_KARA)
extern "C" int h_ood(const int64_t* recs, int64_t groups,
                     const uint64_t* gpow, uint64_t* partial, uint64_t* out,
                     int64_t n, int64_t chunks, int64_t pairs, int ext, int P,
                     int P0, int T, int kara) {
#define H_ARGS recs, groups, gpow, partial, out, n, chunks, pairs, T
#define H_FP(p) \
    if (P == p) { run<false, false, p, p, 4>(H_ARGS); return 0; }
#define H_FQ3(p, p0)                                                      \
    if (P == p && P0 == p0) {                                             \
        if (kara) run<true, true, p, p0, 2>(H_ARGS);                      \
        else run<true, false, p, p0, 2>(H_ARGS);                          \
        return 0;                                                         \
    }
    if (kara < 0) kara = OOD_KARA;
    if (!ext) {
        H_FP(8) H_FP(12) H_FP(16) H_FP(20) H_FP(24) H_FP(32)
        return 1;
    }
    H_FQ3(2, 4) H_FQ3(4, 4) H_FQ3(4, 8) H_FQ3(4, 12) H_FQ3(8, 8)
    return 1;
#undef H_ARGS
#undef H_FP
#undef H_FQ3
}

// `count` products x y in one accumulator, reduced
extern "C" uint64_t h_acc(uint64_t x, uint64_t y, int64_t count) {
    ood_acc a;
    ood_acc_zero(a);
    for (int64_t k = 0; k < count; k++) ood_mac(a, x, y);
    return ood_acc_reduce(a);
}

extern "C" int64_t h_chunks(int64_t n, int64_t groups, int64_t resident,
                            int64_t threads) {
    return ood_chunk_count(n, groups, resident, threads);
}

extern "C" int64_t h_max_run() { return OOD_MAX_RUN; }
extern "C" int64_t h_chunk_min() { return OOD_CHUNK_MIN; }
"""

G = 7  # the coset generator of the toy LDE domains


@pytest.fixture(scope="module")
def lib():
    from ministark_tpu_torch.ops import build

    lib = build.build_host_library("ood_check", _HARNESS)
    lib.h_ood.restype = ctypes.c_int
    lib.h_ood.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                          ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int]
    lib.h_acc.restype = ctypes.c_uint64
    lib.h_acc.argtypes = [ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int64]
    lib.h_chunks.restype = ctypes.c_int64
    lib.h_chunks.argtypes = [ctypes.c_int64] * 4
    for f in (lib.h_max_run, lib.h_chunk_min):
        f.restype = ctypes.c_int64
    return lib


def _fib_pairs():
    """Toy fib: 8 base columns at two points, the composition column at a
    third."""
    return [(j, c) for c in range(8) for j in (0, 1)] + [(2, 8)]


def _bf_pairs():
    """Toy brainfuck: the AIR's 49 trace arguments (17 base, 9 extension
    columns at two points), then 16 composition columns at a third."""
    from ministark_tpu_torch.air import Air, ProofOptions
    from ministark_tpu_torch.models.brainfuck import (BrainfuckAirConfig,
                                                      BrainfuckClaim)

    air = Air(BrainfuckAirConfig, 64, BrainfuckClaim("+.", b"", b"\x01"),
              ProofOptions(9, 16, 0, 4, 16))
    pairs = sorted({(off, col) for col, off in air.trace_arguments()},
                   key=lambda jc: (jc[1], jc[0]))
    return pairs + [(2, 26 + k) for k in range(16)]


# name: (points, Fp columns, Fq3 columns, the pairs, Fq3 transcript, the
# rows (r, d): the whole domain, or a rank's cyclic share j = r + i d)
SHAPES = {
    "fib": (512, 9, 0, _fib_pairs, False, (0, 1)),
    "bf": (1024, 17, 25, _bf_pairs, True, (0, 1)),
    # a column read by five points (more than a group holds), a lone point,
    # pairs out of column order, 777 points (no chunk divides them)
    "awkward_fp": (777, 30, 0, lambda: [(j, 3) for j in range(5)]
                   + [(5, 0), (1, 29), (0, 29)]
                   + [(j % 4, c) for c in range(4, 28) for j in (c, c + 1)],
                   False, (0, 1)),
    "awkward_ext3": (777, 4, 9, lambda: [(j, 12) for j in range(6)]
                     + [(1, 0), (0, 5), (2, 3), (3, 5)]
                     + [(j % 3, c) for c in range(4, 12) for j in (0, c)],
                     True, (0, 1)),
    # rank 1 of 2 and rank 3 of 4: g^i from a first power g^r that is not 1
    "fib_rank": (256, 9, 0, _fib_pairs, False, (1, 2)),
    "bf_rank": (256, 17, 25, _bf_pairs, True, (3, 4)),
}


def _inputs(name, seed):
    """Columns (numpy and torch), inverse rows, g^i and the pairs."""
    from ministark_tpu_torch.fields.convert import from_u64_numpy

    n, nfp, nfq, pairs_fn, ext, (r, d) = SHAPES[name]
    pairs = pairs_fn()
    rng = np.random.default_rng(seed)
    npts = max(j for j, _c in pairs) + 1
    cols = [rng.integers(0, P, size=n, dtype=np.uint64) for _ in range(nfp)]
    cols += [rng.integers(0, P, size=(3, n), dtype=np.uint64)
             for _ in range(nfq)]
    invs = rng.integers(0, P, size=(npts, 3, n) if ext else (npts, n),
                        dtype=np.uint64)
    invs[:, ..., ::97] = 0
    N = n * d  # the domain whose rows r + i d the share holds
    g = pow(G, (P - 1) // N, P) if (P - 1) % N == 0 else G
    gpow = np.array([pow(g, r + i * d, P) for i in range(n)], dtype=np.uint64)
    return (cols, [from_u64_numpy(c) for c in cols], invs,
            from_u64_numpy(invs), gpow, from_u64_numpy(gpow), pairs, ext)


def _np_sum(a):
    """Field sum along the last axis by pairwise halving (numpy)."""
    while a.shape[-1] > 1:
        h = a.shape[-1] // 2
        s = nf.add(a[..., :h], a[..., h:2 * h])
        a = np.concatenate([s, a[..., 2 * h:]], axis=-1) if a.shape[-1] % 2 \
            else s
    return a[..., 0]


def _np_ood(cols, invs, gpow, pairs, ext):
    """S[k] = sum_i cols[c][i] invs[j][i] gpow[i], restated in npfield."""
    out = []
    for j, c in pairs:
        if not ext:
            out.append(_np_sum(nf.mul(nf.mul(cols[c], invs[j]), gpow)))
            continue
        w = tuple(nf.mul(invs[j][k], gpow) for k in range(3))
        col = (tuple(cols[c]) if cols[c].ndim == 2
               else nf.ext3_from_base(cols[c]))
        out.append([_np_sum(v) for v in nf.ext3_mul(col, w)])
    return np.array(out, dtype=np.uint64).T


@pytest.mark.parametrize("name", list(SHAPES))
def test_ood_plain_matches_npfield(name):
    """The plain OOD sums equal the npfield restatement."""
    from ministark_tpu_torch.fields.convert import to_u64_numpy
    from ministark_tpu_torch.ops import deep as kdeep

    cols, tcols, invs, tinvs, gpow, tgpow, pairs, ext = _inputs(name, 71)
    fn = kdeep.ood_sums_ext3 if ext else kdeep.ood_sums
    got = to_u64_numpy(fn(tcols, tinvs, pairs, tgpow))
    np.testing.assert_array_equal(got, _np_ood(cols, invs, gpow, pairs, ext))


def _host_run(lib, tcols, tinvs, pairs, tgpow, ext, chunks, P=None, P0=None,
              T=256, kara=-1):
    """The kernel's schedule, by the host build, on the groups
    ``ops.deep.ood_groups`` makes (P pairs a group, P0 of Fp columns in an
    Fq3 transcript; by default the wrapper's), every record within its
    pairs and points; Fq3 columns' products in Karatsuba form (kara 1),
    the schoolbook (0) or the shipped form (-1)."""
    import torch

    from ministark_tpu_torch.ops import deep as kdeep

    if P is None:
        P, P0 = kdeep.ood_pairs_a_group(ext, len(pairs))
    P0 = P0 or P
    words = kdeep.ood_groups(tcols, tinvs, pairs, ext, P, P0)
    R = kdeep.ood_record_words(ext, P, P0)
    groups = len(words) // R
    for g in range(groups):  # no group over its points or pairs
        rec = words[g * R:(g + 1) * R]
        assert 0 < rec[0] <= (P if rec[2] or not ext else P0)
        assert 0 < rec[1] <= kdeep.OOD_W[ext]
    recs = torch.tensor(words, dtype=torch.int64)
    slots = 3 if ext else 1
    n = tgpow.shape[0]
    partial = torch.zeros(chunks * slots * len(pairs), dtype=torch.int64)
    out = torch.zeros(slots * len(pairs), dtype=torch.int64)
    assert lib.h_ood(recs.data_ptr(), groups, tgpow.data_ptr(),
                     partial.data_ptr(), out.data_ptr(), n, chunks,
                     len(pairs), int(ext), P, P0, T, kara) == 0
    return out.reshape(3, -1) if ext else out


@pytest.mark.parametrize("chunks", [1, 3, 64])
@pytest.mark.parametrize("name", list(SHAPES))
def test_ood_host_build_matches_plain(lib, name, chunks):
    """The kernel's schedule on the host (the groups, a block a chunk of
    256 threads, one partial a pair and chunk, their sum) equals the plain
    version and the npfield restatement, for any cut of the points into
    chunks: the Fp transcripts in one pass of every pair (fib's 17 in one
    group of 20), the Fq3 ones by groups, g^i from the first power and
    g^256."""
    from ministark_tpu_torch.fields.convert import to_u64_numpy
    from ministark_tpu_torch.ops import deep as kdeep

    cols, tcols, invs, tinvs, gpow, tgpow, pairs, ext = _inputs(name, 72)
    got = _host_run(lib, tcols, tinvs, pairs, tgpow, ext, chunks)
    plain = (kdeep.ood_sums_ext3_plain if ext else kdeep.ood_sums_plain)(
        tcols, tinvs, pairs, tgpow)
    assert got.equal(plain)
    if chunks == 3:
        np.testing.assert_array_equal(to_u64_numpy(got),
                                      _np_ood(cols, invs, gpow, pairs, ext))


@pytest.mark.parametrize("name, P, P0, T", [
    ("fib", 32, 32, 1), ("fib_rank", 24, 24, 32), ("awkward_fp", 8, 8, 4),
    ("fib", 24, 24, 128), ("awkward_fp", 12, 12, 256), ("bf", 4, 8, 256),
    ("bf", 4, 4, 128), ("bf_rank", 2, 4, 4), ("bf_rank", 8, 8, 1),
    ("awkward_ext3", 2, 4, 32), ("awkward_ext3", 8, 8, 128)])
def test_ood_host_build_variants(lib, name, P, P0, T):
    """The variants scripts/ab_kernels.py times (other pairs a group and
    threads a block), all equal to the plain version."""
    from ministark_tpu_torch.ops import deep as kdeep

    _c, tcols, _i, tinvs, _g, tgpow, pairs, ext = _inputs(name, 74)
    plain = (kdeep.ood_sums_ext3_plain if ext else kdeep.ood_sums_plain)(
        tcols, tinvs, pairs, tgpow)
    assert _host_run(lib, tcols, tinvs, pairs, tgpow, ext, 5, P, P0,
                     T=T).equal(plain)


@pytest.mark.parametrize("name", ["bf", "bf_rank", "awkward_ext3"])
def test_ood_host_build_karatsuba_and_schoolbook(lib, name):
    """Both forms of an Fq3 column's products (scripts/ab_kernels.py times
    them in turns, deep.cuh OOD_KARA ships one) equal the plain version:
    nine products into three accumulators, and Karatsuba's six into six
    combined once a thread."""
    from ministark_tpu_torch.ops import deep as kdeep

    _c, tcols, _i, tinvs, _g, tgpow, pairs, ext = _inputs(name, 75)
    plain = kdeep.ood_sums_ext3_plain(tcols, tinvs, pairs, tgpow)
    for kara in (0, 1):
        assert _host_run(lib, tcols, tinvs, pairs, tgpow, ext, 3,
                         kara=kara).equal(plain)


@pytest.mark.parametrize("x, y", [(P - 1, P - 1), ((1 << 64) - 1,
                                                    (1 << 64) - 1)])
def test_ood_accumulator_longest_run(lib, x, y):
    """One accumulator of a thread's longest run (3 products a point,
    OOD_MAX_RUN points) of the largest products: canonical inputs p - 1,
    and the lazy weights' bound 2^64 - 1, reduced exactly."""
    count = 3 * lib.h_max_run()
    assert lib.h_acc(x, y, count) == x * y * count % P


@pytest.mark.parametrize("ext", [False, True])
def test_ood_host_build_every_input_p_minus_1(lib, ext):
    """Every column and inverse plane p - 1, g^i = 1, over one thread's
    longest run (OOD_MAX_RUN points, a chunk of one thread): each product
    the largest a canonical one can be.  Fp: (p - 1)^2 = 1 a point; Fq3:
    an Fp column by (p - 1)(1, 1, 1) gives (1, 1, 1), an Fq3 column
    (p - 1)(1, 1, 1) by it (1 + u + u^2)^2 = 5 + 4u + 3u^2 a point, in
    both forms of the Fq3 product (Karatsuba's sums p - 2)."""
    import torch

    n = lib.h_max_run()
    m1 = P - 1 - (1 << 64)  # p - 1 as an int64 bit pattern
    base = torch.full((n,), m1, dtype=torch.int64)
    wide = torch.full((3, n), m1, dtype=torch.int64)
    cols = [base, wide] if ext else [base]
    invs = torch.full((2, 3, n) if ext else (2, n), m1, dtype=torch.int64)
    pairs = [(0, 0), (1, 0)] + ([(0, 1), (1, 1)] if ext else [])
    gpow = torch.ones(n, dtype=torch.int64)
    if not ext:
        got = _host_run(lib, cols, invs, pairs, gpow, ext, 1, T=1)
        assert got.tolist() == [n % P] * 2
        return
    want = [[n % P] * 2 + [5 * n % P] * 2, [n % P] * 2 + [4 * n % P] * 2,
            [n % P] * 2 + [3 * n % P] * 2]
    for kara in (0, 1):
        got = _host_run(lib, cols, invs, pairs, gpow, ext, 1, T=1, kara=kara)
        assert [[v % (1 << 64) for v in row] for row in got.tolist()] == want


def test_ood_gpow_must_be_geometric():
    """The kernel reads gpow[0] and gpow[1] alone, so its wrapper checks
    that the row is f g^i (its middle and last powers) and raises where it
    is not; a rank's share f g^i with f != 1 passes."""
    import torch

    from ministark_tpu_torch.fields import device as fd
    from ministark_tpu_torch.ops import deep as kdeep

    for f in (1, 5):
        gpow = fd.mul(fd.powers(7, 1000, "cpu"), f)
        kdeep._check_geometric(gpow)
        for i in (500, 999):
            bad = gpow.clone()
            bad[i] = 3
            with pytest.raises(ValueError, match="geometric"):
                kdeep._check_geometric(bad)
    with pytest.raises(ValueError, match="geometric"):
        kdeep._check_geometric(torch.zeros(8, dtype=torch.int64))


def test_ood_groups_read_a_column_once():
    """Brainfuck's 65 pairs fill groups of at most OOD_P3 pairs of Fq3
    columns or OOD_P30 of Fp ones, each of one column kind, at most one
    short group a kind; each column sits in one group; a pair's slot names
    one of its group's points; unused slots and pairs repeat the group's
    first row and column.  Fib's 17 pairs make one group of 20."""
    from ministark_tpu_torch.ops import deep as kdeep

    _c, tcols, _i, tinvs, _g, _tg, pairs, _e = _inputs("bf", 73)
    P_, P0 = kdeep.ood_pairs_a_group(True, len(pairs))
    assert (P_, P0) == (kdeep.OOD_P3, kdeep.OOD_P30)
    words = kdeep.ood_groups(tcols, tinvs, pairs, True, P_, P0)
    R, W = kdeep.ood_record_words(True, P_, P0), kdeep.OOD_W[True]
    RP = max(P_, P0)
    recs = [words[k:k + R] for k in range(0, len(words), R)]
    assert len(recs) <= -(-31 // P0) + -(-34 // P_) + 4
    seen = {}
    for g, rec in enumerate(recs):
        np_, npts = rec[0], rec[1]
        assert np_ <= (P_ if rec[2] else P0)
        rows = rec[3:3 + W]
        ptrs = rec[3 + W:3 + W + RP]
        slots = rec[3 + W + RP:3 + W + RP + np_]
        assert rows[npts:] == rows[:1] * (W - npts)
        assert ptrs[np_:] == ptrs[:1] * (RP - np_)
        kinds = {tcols[c].ndim for c in range(len(tcols))
                 if tcols[c].data_ptr() in ptrs[:np_]}
        assert kinds == {2 if rec[2] else 1}  # one column kind a group
        for ptr, sl in zip(ptrs[:np_], slots):
            assert seen.setdefault(ptr, g) == g
            assert 0 <= sl < npts
    assert len(seen) == 17 + 9 + 16
    _c, tcols, _i, tinvs, _g, _tg, pairs, _e = _inputs("fib", 73)
    assert kdeep.ood_pairs_a_group(False, len(pairs)) == (20, 20)
    words = kdeep.ood_groups(tcols, tinvs, pairs, False, 20)
    assert len(words) == kdeep.ood_record_words(False, 20)
    assert words[:3] == [17, 3, 0]


def test_ood_chunks(lib):
    """The launch's chunks (deep.cuh ood_chunk_count, the one rule the
    wrapper asks the kernel for): one wave of the card's resident blocks
    over the groups, none shorter than OOD_CHUNK_MIN points, and no thread
    (of 128 a block) over OOD_MAX_RUN points."""
    cmin, run = lib.h_chunk_min(), lib.h_max_run()
    assert lib.h_chunks(1 << 24, 9, 396, 128) == 44
    assert lib.h_chunks(1 << 15, 1, 396, 128) == (1 << 15) // cmin
    assert lib.h_chunks(1 << 23, 1, 396, 128) == 396
    assert lib.h_chunks(3000, 1, 396, 128) == 2
    assert lib.h_chunks(500, 1, 396, 128) == 1
    assert lib.h_chunks(1 << 31, 65535, 396, 128) == (1 << 31) // (128 * run)
    assert lib.h_chunks(1 << 31, 1, 1 << 20, 128) == 65535
    assert 128 * run * 16 == 1 << 31
