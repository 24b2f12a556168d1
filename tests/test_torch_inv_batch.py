"""Kernel A's schedule (csrc/inv_batch.cuh) on the CPU: the header built by
g++ with a host driver that runs the kernel's threads one at a time over
each tile, in Fp and in Fq3, against ``ministark_tpu.fields.npfield``
(what the JAX package's ``batch_inv`` runs on the CPU) and the port's
plain versions.

Every group size K in {8, 16, 32}, with the group kept in registers or
read again, at T = 256 threads a block (the kernel's) and T = 4; lengths
around a group and a tile (0, 1, K - 1, K, K + 1, KT - 1, KT, KT + 1,
2^16 + 3), zeros at the first and last slot of a group and a whole group
of zeros, 0, 1 and p - 1 as values, and for Fq3 elements with zero
components and (B, 3, n) batches whose rows are shorter or longer than a
tile.  And the addition chain for p - 2 on its own.  Inputs are numpy
draws from a fixed seed; equality is exact.  No JAX compile.
"""

import ctypes

import numpy as np
import pytest

from ministark_tpu.fields import npfield as nf
from ministark_tpu.fields.scalar import P

N = (1 << 16) + 3
KS = (8, 16, 32)
TS = (4, 256)
EDGE = [0, 1, 2, P - 1, P - 2, 1 << 32, (1 << 32) - 1, 1 << 63]

_HARNESS = r"""
#include "inv_batch.cuh"

template <int K, bool KEEP>
static void fp(const uint64_t* in, uint64_t* out, long n, int T) {
    for (long j = 0; j * K * T < n; j++)
        for (int t = 0; t < T; t++)
            inv_fp_thread<K, KEEP>(in, out, n, j, t, T, gl_mul_cc_fn());
}

template <int K, bool KEEP>
static void ext3(const uint64_t* in, uint64_t* out, long B, long n, int T) {
    for (long j = 0; j * K * T < B * n; j++)
        for (int t = 0; t < T; t++)
            inv_ext3_thread<K, KEEP>(in, out, n, B * n, j, t, T,
                                     gl_mul_cc_fn());
}

#define DISPATCH(call)                                                 \
    switch (K * 2 + keep) {                                            \
        case 16: call(8, false); return 0;                             \
        case 17: call(8, true); return 0;                              \
        case 32: call(16, false); return 0;                            \
        case 33: call(16, true); return 0;                             \
        case 64: call(32, false); return 0;                            \
        case 65: call(32, true); return 0;                             \
    }                                                                  \
    return 1;

extern "C" int host_inv_fp(const uint64_t* in, uint64_t* out, long n,
                           long K, long keep, long T) {
#define FP(k, kp) fp<k, kp>(in, out, n, (int)T)
    DISPATCH(FP)
}

extern "C" int host_inv_ext3(const uint64_t* in, uint64_t* out, long B,
                             long n, long K, long keep, long T) {
#define EXT3(k, kp) ext3<k, kp>(in, out, B, n, (int)T)
    DISPATCH(EXT3)
}

extern "C" void host_inv_chain(const uint64_t* a, uint64_t* o, long n) {
    for (long i = 0; i < n; i++) o[i] = gl_inv(a[i]);
}
"""

_U64P = ctypes.POINTER(ctypes.c_uint64)


@pytest.fixture(scope="module")
def lib():
    from ministark_tpu_torch.ops import build

    lib = build.build_host_library("inv_batch_check", _HARNESS)
    for name, nargs in (("host_inv_fp", 4), ("host_inv_ext3", 5)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [_U64P, _U64P] + [ctypes.c_long] * nargs
    lib.host_inv_chain.restype = None
    lib.host_inv_chain.argtypes = [_U64P, _U64P, ctypes.c_long]
    return lib


def _ptr(a):
    return a.ctypes.data_as(_U64P)


def _torch(a):
    from ministark_tpu_torch.fields.convert import from_u64_numpy

    return from_u64_numpy(np.ascontiguousarray(a))


def _numpy(t):
    from ministark_tpu_torch.fields.convert import to_u64_numpy

    return to_u64_numpy(t.contiguous())


@pytest.fixture(scope="module")
def fp_ref():
    """N random elements and their inverses by npfield, which the port's
    plain version (fd.inv) must equal."""
    from ministark_tpu_torch.fields import device as fd

    a = np.random.default_rng(5).integers(1, P, size=N, dtype=np.uint64)
    want = nf.inv(a)
    np.testing.assert_array_equal(_numpy(fd.inv(_torch(a))), want)
    return a, want


@pytest.fixture(scope="module")
def ext3_ref():
    """(3, N) random Fq3 elements and their inverses by npfield, which the
    port's plain version (fd.ext3_inv) must equal."""
    from ministark_tpu_torch.fields import device as fd

    a = np.random.default_rng(6).integers(1, P, size=(3, N), dtype=np.uint64)
    want = np.stack(nf.ext3_inv(tuple(a)))
    np.testing.assert_array_equal(_numpy(fd.ext3_inv(_torch(a))), want)
    return a, want


def _special_slots(n, K, T, rng):
    """Flat indices below n: the group slots (the first slot, k = 0, of
    thread 1's group and the last, k = K - 1, of thread 2's in tile 0, and
    all of thread 3's group), then a few others drawn at random."""
    group = [1, (K - 1) * T + 2] + [k * T + 3 for k in range(K)]
    group = np.unique([s for s in group if s < n]).astype(np.int64)
    drawn = np.setdiff1d(rng.integers(0, max(n, 1), size=16), group)
    return group, drawn[drawn < n].astype(np.int64)


def _sizes(K, T):
    return [0, 1, K - 1, K, K + 1, K * T - 1, K * T, K * T + 1, N]


CASES = [(K, keep, T, i) for K in KS for keep in (True, False) for T in TS
         for i in range(9)]


def _case_id(c):
    K, keep, T, i = c
    return f"K{K}-{'keep' if keep else 'reload'}-T{T}-n{i}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_inv_batch_fp_matches_npfield(lib, fp_ref, case):
    K, keep, T, i = case
    n = _sizes(K, T)[i]
    base, base_inv = fp_ref
    rng = np.random.default_rng(n)
    a, want = base[:n].copy(), base_inv[:n].copy()
    group, drawn = _special_slots(n, K, T, rng)
    # zeros at the group slots; 0, 1 and p - 1 at the others
    a[group] = 0
    a[drawn] = np.array([0, 1, P - 1] * 6, dtype=np.uint64)[:len(drawn)]
    slots = np.concatenate([group, drawn])
    want[slots] = nf.inv(a[slots])
    out = np.full(n, 12345, dtype=np.uint64)
    assert lib.host_inv_fp(_ptr(a), _ptr(out), n, K, keep, T) == 0
    np.testing.assert_array_equal(out, want)


def _ext3_shapes(K, T):
    """(B, n): the Fp lengths as one row, then batches whose rows are
    shorter than a tile (each element divides) and longer than one (a
    thread's group crosses at most one row boundary; with n = KT + T + 5
    the rows start at the k = 1 and k = 2 slots of a group)."""
    return ([(1, n) for n in _sizes(K, T)]
            + [(5, 7), (3, K - 1), (2, K * T - 1), (3, K * T + 1),
               (3, K * T + T + 5)])


EXT3_CASES = [(K, keep, T, i) for K in KS for keep in (True, False)
              for T in TS for i in range(14)]


@pytest.mark.parametrize("case", EXT3_CASES, ids=_case_id)
def test_inv_batch_ext3_matches_npfield(lib, ext3_ref, case):
    K, keep, T, i = case
    B, n = _ext3_shapes(K, T)[i]
    m = B * n
    base, base_inv = ext3_ref
    rng = np.random.default_rng(m)
    a, want = base[:, :m].copy(), base_inv[:, :m].copy()
    group, drawn = _special_slots(m, K, T, rng)
    # zero elements at the group slots; at the others elements with zero
    # components (not zero themselves) and components 1 and p - 1
    r = int(base[0, 0])
    kinds = [(0, r, 0), (0, 0, r), (r, 0, 0), (r, r, 0), (0, r, r),
             (1, 0, 0), (P - 1, 0, 0), (0, 1, P - 1), (P - 1, P - 1, P - 1),
             (1, 1, 1), (0, 0, 0)] * 2
    a[:, group] = 0
    a[:, drawn] = np.array(kinds[:len(drawn)], dtype=np.uint64).T
    slots = np.concatenate([group, drawn])
    want[:, slots] = np.stack(nf.ext3_inv(tuple(a[:, slots])))
    # element e = b n + i at [b, :, i]
    x = np.ascontiguousarray(a.reshape(3, B, n).transpose(1, 0, 2))
    out = np.full_like(x, 12345)
    assert lib.host_inv_ext3(_ptr(x), _ptr(out), B, n, K, keep, T) == 0
    np.testing.assert_array_equal(out.transpose(1, 0, 2).reshape(3, m), want)


def test_inv_chain_matches_pow(lib):
    """gl_inv's addition chain for p - 2 alone, on the edge values and
    random ones, against Python's pow, npfield and the plain version."""
    from ministark_tpu_torch.fields import device as fd

    a = np.concatenate([np.array(EDGE, dtype=np.uint64),
                        np.random.default_rng(7).integers(
                            0, P, size=200, dtype=np.uint64)])
    out = np.zeros_like(a)
    lib.host_inv_chain(_ptr(a), _ptr(out), len(a))
    want = np.array([pow(int(v), P - 2, P) for v in a], dtype=np.uint64)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, nf.inv(a))
    np.testing.assert_array_equal(out, _numpy(fd.inv(_torch(a))))
