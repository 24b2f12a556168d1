"""The port's Goldilocks layer against the JAX package's references.

``ministark_tpu_torch.fields.device`` (the plain PyTorch field ops, which are
also the plain version of kernel A) and the host build of
``csrc/goldilocks.cuh`` are compared with ``ministark_tpu.fields.npfield``
on the same numpy inputs; equality is exact (integer field arithmetic).

torch and the port are imported inside the tests, so collecting this file
stays cheap in every pytest-xdist worker.
"""

import ctypes

import numpy as np
import pytest

from ministark_tpu.fields import npfield as nf
from ministark_tpu.fields.scalar import P

EDGE = [0, 1, 2, P - 1, P - 2, 1 << 32, (1 << 32) - 1, (1 << 63), P >> 1]


def _vectors(seed, n=2000):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, P, size=n, dtype=np.uint64)
    b = rng.integers(0, P, size=n, dtype=np.uint64)
    edge = np.array(EDGE, dtype=np.uint64)
    a = np.concatenate([a, np.repeat(edge, len(edge))])
    b = np.concatenate([b, np.tile(edge, len(edge))])
    return a, b


@pytest.mark.parametrize("op", ["add", "sub", "mul", "neg", "inv", "pow"])
def test_plain_field_ops_match_npfield(op):
    from ministark_tpu_torch.fields import device as fd
    from ministark_tpu_torch.fields.convert import from_u64_numpy, to_u64_numpy

    a, b = _vectors(11)
    ta, tb = from_u64_numpy(a), from_u64_numpy(b)
    got = {
        "add": lambda: fd.add(ta, tb),
        "sub": lambda: fd.sub(ta, tb),
        "mul": lambda: fd.mul(ta, tb),
        "neg": lambda: fd.neg(ta),
        "inv": lambda: fd.inv(ta),
        "pow": lambda: fd.pow_const(ta, 0x1234567890ABCDEF),
    }[op]()
    want = {
        "add": lambda: nf.add(a, b),
        "sub": lambda: nf.sub(a, b),
        "mul": lambda: nf.mul(a, b),
        "neg": lambda: nf.neg(a),
        "inv": lambda: nf.inv(a),
        "pow": lambda: nf.pow_const(a, 0x1234567890ABCDEF),
    }[op]()
    np.testing.assert_array_equal(to_u64_numpy(got), want)


def test_batch_inv_plain_matches_npfield_with_zeros():
    """Kernel A's plain version: elementwise inverse, 0 -> 0."""
    from ministark_tpu_torch.fields.convert import from_u64_numpy, to_u64_numpy
    from ministark_tpu_torch.ops import inv as kinv

    a, _ = _vectors(12, 512)
    a[::7] = 0
    got = to_u64_numpy(kinv.inv_fp(from_u64_numpy(a)))
    np.testing.assert_array_equal(got, nf.inv(a))
    assert (got[::7] == 0).all()
    nz = a != 0
    np.testing.assert_array_equal(nf.mul(got[nz], a[nz]),
                                  np.ones(nz.sum(), dtype=np.uint64))


def test_powers_and_sum_match_scalar_math():
    from ministark_tpu_torch.fields import device as fd

    base = 0x1234_5678_9ABC_DEF % P
    got = fd.to_ints(fd.powers(base, 37, "cpu"))
    assert got == [pow(base, i, P) for i in range(37)]
    a, _ = _vectors(13, 101)
    from ministark_tpu_torch.fields.convert import from_u64_numpy
    assert fd.to_ints(fd.sum_mod(from_u64_numpy(a))) == [
        sum(int(v) for v in a) % P]


def test_limb_conversion_roundtrip():
    """from_jax_matrix / to_jax_limbs are npfield.from_limbs / to_limbs."""
    from ministark_tpu_torch.fields.convert import (from_jax_matrix,
                                                    to_jax_limbs,
                                                    to_u64_numpy)

    a, _ = _vectors(14, 64)
    a = a[:144]
    lo, hi = nf.to_limbs(a.reshape(4, -1))
    t = from_jax_matrix(lo, hi)
    np.testing.assert_array_equal(to_u64_numpy(t), a.reshape(4, -1))
    lo2, hi2 = to_jax_limbs(t)
    np.testing.assert_array_equal(lo2, lo)
    np.testing.assert_array_equal(hi2, hi)


_HOST_HARNESS = r"""
#include "goldilocks.cuh"
#define MAP2(name, expr) extern "C" void name(const uint64_t* a, \
    const uint64_t* b, uint64_t* o, long n) { \
    for (long i = 0; i < n; i++) o[i] = expr; }
MAP2(h_add, gl_add(a[i], b[i]))
MAP2(h_sub, gl_sub(a[i], b[i]))
MAP2(h_mul, gl_mul(a[i], b[i]))
MAP2(h_neg, gl_neg(a[i]))
MAP2(h_inv, gl_inv(a[i]))
MAP2(h_pow, gl_pow(a[i], 0x1234567890ABCDEFULL))
"""


def test_goldilocks_header_host_build_matches_npfield():
    """csrc/goldilocks.cuh built as host C++ by g++ (the kernels' math)."""
    from ministark_tpu_torch.ops import build

    lib = build.build_host_library("goldilocks_check", _HOST_HARNESS)
    a, b = _vectors(15)
    want = {"add": nf.add(a, b), "sub": nf.sub(a, b), "mul": nf.mul(a, b),
            "neg": nf.neg(a), "inv": nf.inv(a),
            "pow": nf.pow_const(a, 0x1234567890ABCDEF)}
    u64p = ctypes.POINTER(ctypes.c_uint64)
    for name, expected in want.items():
        out = np.zeros_like(a)
        fn = getattr(lib, f"h_{name}")
        fn.restype = None
        fn.argtypes = [u64p, u64p, u64p, ctypes.c_long]
        fn(a.ctypes.data_as(u64p), b.ctypes.data_as(u64p),
           out.ctypes.data_as(u64p), len(a))
        np.testing.assert_array_equal(out, expected, err_msg=name)
