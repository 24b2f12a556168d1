"""The OOD barycentric sums, kernel F's second entry point, on the CPU: the
plain version (``ops.deep.ood_sums_plain``, ``ood_sums_ext3_plain``)
against a numpy restatement of S[j][c] = sum_i col_c[i] inv_j[i] g^i
(``ministark_tpu.fields.npfield``), and the kernel's math (csrc/deep.cuh)
built by g++ with a host harness that runs the kernel's schedule: the
groups ``ops.deep.ood_groups`` makes, each chunk of points a block, one
partial a pair and chunk, then the sum of the partials.  Shapes are toy
fib (8 + 1 columns, 512 points) and brainfuck (17 + 9 + 16 columns, 1024
points) ones and awkward ones; inputs are numpy draws from a fixed seed;
equality is exact.  No JAX compile.
"""

import ctypes

import numpy as np
import pytest

from ministark_tpu.fields import npfield as nf
from ministark_tpu.fields.scalar import P

_HARNESS = r"""
#include <vector>
#include "deep.cuh"

template <class F, int P>
static void run(const int64_t* recs, int64_t groups, const uint64_t* gpow,
                uint64_t* partial, uint64_t* out, int64_t n, int64_t chunks,
                int64_t pairs) {
    typedef typename F::T T;
    const int64_t chunk = (n + chunks - 1) / chunks;
    for (int64_t g = 0; g < groups; g++) {
        const int64_t* rec = recs + g * OOD_RECORD(P);
        for (int64_t c = 0; c < chunks; c++) {
            T acc[P];
            for (int p = 0; p < P; p++) acc[p] = F::zero();
            const int64_t a = c * chunk, b = a + chunk < n ? a + chunk : n;
            for (int64_t i = a; i < b; i++)
                ood_point<F, P>(rec, i, n, gpow[i], acc);
            for (int64_t p = 0; p < rec[0]; p++)
                for (int k = 0; k < F::SLOTS; k++)
                    partial[ood_partial_index(c, k, rec[OOD_OUT(P, p)], pairs,
                                              F::SLOTS)] = F::plane(acc[p], k);
        }
    }
    const int64_t K = F::SLOTS * pairs;
    for (int64_t k = 0; k < K; k++) {
        uint64_t v = 0;
        for (int64_t c = 0; c < chunks; c++) v = gl_add(v, partial[c * K + k]);
        out[k] = v;
    }
}

extern "C" void h_ood(const int64_t* recs, int64_t groups,
                      const uint64_t* gpow, uint64_t* partial, uint64_t* out,
                      int64_t n, int64_t chunks, int64_t pairs, int ext) {
    if (ext)
        run<dp_fq3, 4>(recs, groups, gpow, partial, out, n, chunks, pairs);
    else
        run<dp_fp, 8>(recs, groups, gpow, partial, out, n, chunks, pairs);
}
"""

G = 7  # the coset generator of the toy LDE domains


@pytest.fixture(scope="module")
def lib():
    from ministark_tpu_torch.ops import build

    lib = build.build_host_library("ood_check", _HARNESS)
    lib.h_ood.restype = None
    lib.h_ood.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                          ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
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


# name: (points, Fp columns, Fq3 columns, the pairs, Fq3 transcript)
SHAPES = {
    "fib": (512, 9, 0, _fib_pairs, False),
    "bf": (1024, 17, 25, _bf_pairs, True),
    # a column read by five points (more than a group holds), a lone point,
    # pairs out of column order, 777 points (no chunk divides them)
    "awkward_fp": (777, 30, 0, lambda: [(j, 3) for j in range(5)]
                   + [(5, 0), (1, 29), (0, 29)]
                   + [(j % 4, c) for c in range(4, 28) for j in (c, c + 1)],
                   False),
    "awkward_ext3": (777, 4, 9, lambda: [(j, 12) for j in range(6)]
                     + [(1, 0), (0, 5), (2, 3), (3, 5)]
                     + [(j % 3, c) for c in range(4, 12) for j in (0, c)],
                     True),
}


def _inputs(name, seed):
    """Columns (numpy and torch), inverse rows, g^i and the pairs."""
    from ministark_tpu_torch.fields.convert import from_u64_numpy

    n, nfp, nfq, pairs_fn, ext = SHAPES[name]
    pairs = pairs_fn()
    rng = np.random.default_rng(seed)
    npts = max(j for j, _c in pairs) + 1
    cols = [rng.integers(0, P, size=n, dtype=np.uint64) for _ in range(nfp)]
    cols += [rng.integers(0, P, size=(3, n), dtype=np.uint64)
             for _ in range(nfq)]
    invs = rng.integers(0, P, size=(npts, 3, n) if ext else (npts, n),
                        dtype=np.uint64)
    invs[:, ..., ::97] = 0
    g = pow(G, (P - 1) // n, P) if (P - 1) % n == 0 else G
    gpow = np.array([pow(g, i, P) for i in range(n)], dtype=np.uint64)
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


@pytest.mark.parametrize("chunks", [1, 3, 64])
@pytest.mark.parametrize("name", list(SHAPES))
def test_ood_host_build_matches_plain(lib, name, chunks):
    """The kernel's schedule on the host (the groups, one partial a pair
    and chunk, their sum) equals the plain version, for any cut of the
    points into chunks."""
    import torch

    from ministark_tpu_torch.ops import deep as kdeep

    _c, tcols, _i, tinvs, _g, tgpow, pairs, ext = _inputs(name, 72)
    words = kdeep.ood_groups(tcols, tinvs, pairs, ext)
    P_, R = kdeep.OOD_PAIRS[ext], kdeep.ood_record_words(ext)
    groups = len(words) // R
    recs = torch.tensor(words, dtype=torch.int64)
    for g in range(groups):  # no group over its points or pairs
        rec = words[g * R:(g + 1) * R]
        assert 0 < rec[0] <= P_ and 0 < rec[1] <= kdeep.OOD_W
    slots = 3 if ext else 1
    n = tgpow.shape[0]
    partial = torch.zeros(chunks * slots * len(pairs), dtype=torch.int64)
    out = torch.zeros(slots * len(pairs), dtype=torch.int64)
    lib.h_ood(recs.data_ptr(), groups, tgpow.data_ptr(), partial.data_ptr(),
              out.data_ptr(), n, chunks, len(pairs), int(ext))
    plain = (kdeep.ood_sums_ext3_plain if ext else kdeep.ood_sums_plain)(
        tcols, tinvs, pairs, tgpow)
    assert torch.equal(out.reshape(plain.shape), plain)


def test_ood_groups_read_a_column_once():
    """Brainfuck's 65 pairs fill groups of at most OOD_PAIRS pairs, each of
    one column kind, at most one short group a kind; each column sits in
    one group, its second pair marked to reuse it."""
    from ministark_tpu_torch.ops import deep as kdeep

    _c, tcols, _i, tinvs, _g, _tg, pairs, _e = _inputs("bf", 73)
    words = kdeep.ood_groups(tcols, tinvs, pairs, True)
    R, W, P_ = (kdeep.ood_record_words(True), kdeep.OOD_W,
                kdeep.OOD_PAIRS[True])
    recs = [words[k:k + R] for k in range(0, len(words), R)]
    assert len(recs) <= -(-31 // P_) + -(-34 // P_) + 4
    seen = {}
    for g, rec in enumerate(recs):
        np_ = rec[0]
        ptrs = rec[3 + W:3 + W + np_]
        metas = rec[3 + W + P_:3 + W + P_ + np_]
        kinds = {tcols[c].ndim for c in range(len(tcols))
                 if tcols[c].data_ptr() in ptrs}
        assert kinds == {2 if rec[2] else 1}  # one column kind a group
        for p, (ptr, m) in enumerate(zip(ptrs, metas)):
            assert seen.setdefault(ptr, g) == g
            assert bool(m & 2) == (p > 0 and ptrs[p - 1] == ptr)
    assert len(seen) == 17 + 9 + 16


def test_ood_chunks():
    """About OOD_BLOCKS blocks, none shorter than OOD_CHUNK_MIN points."""
    from ministark_tpu_torch.ops import deep as kdeep

    assert kdeep.ood_chunks(1 << 24, 9) == -(-kdeep.OOD_BLOCKS // 9)
    assert kdeep.ood_chunks(1 << 15, 9) == 64
    assert kdeep.ood_chunks(1000, 1) == 2
    assert kdeep.ood_chunks(500, 1) == 1
