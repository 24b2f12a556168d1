"""The port's Fq3 layer against the JAX package's references.

Fq3 = Fp[u]/(u^3 - 2) on tensors (``fields/device.py``, components on axis
-2), its ``gl3_*`` twins in ``csrc/goldilocks.cuh`` built as host C++ by
g++, and the plain versions of the Fq3 inverse, DEEP sum and row hash
(kernels A, F and D's Fq3 entry points), compared with
``ministark_tpu.fields.npfield``, ``ministark_tpu.fields.scalar.Fq3`` and
``ministark_tpu.hash`` on inputs from a numpy seed.  The affine scan of the
extension columns is held against its sequential form.  Equality is exact
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
