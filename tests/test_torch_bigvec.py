"""The port's big prime field vectors (``ministark_tpu_torch.fields.bigvec``,
Fp128 and Fp252 as u64 Montgomery limbs) on the CPU, through the plain
versions of ``ops.bigfield``, against Python bigint oracles on the values
of the JAX package's ``tests/test_bigvec.py`` (numpy seeds 0-4), against
the JAX package's ``pack`` (host numpy) through ``fields.convert``, and
the 32-point NTT, plain and coset, against the JAX package's
``BigDomain`` and Horner's rule.

csrc/bigfield.cuh is built by g++ with a host harness that runs the
kernels' schedule (the product, the sums, and the NTT as a tile of T
points with its stages, then a stage a pass, the scales folded in) at
several tile sizes, against the same oracles.  Equality is exact.
"""

import ctypes

import numpy as np
import pytest
import torch

from ministark_tpu_torch.fields import convert
from ministark_tpu_torch.fields.bigvec import BigDomain, Fp128Vec, Fp252Vec
from ministark_tpu_torch.ops import bigfield as kbig

FIELDS = [Fp128Vec, Fp252Vec]
fields = pytest.mark.parametrize("f", FIELDS, ids=lambda f: f.name)

_HARNESS = r"""
#include "bigfield.cuh"

template <int L>
static void mul_n(const uint64_t* a, const uint64_t* b, uint64_t* out,
                  long n, const uint64_t* mod, int op) {
    const BigMod<L> m = big_mod_from<L>(mod);
    for (long i = 0; i < n; i++) {
        uint64_t x[L], y[L], z[L];
        big_load<L>(a, n, i, x);
        big_load<L>(b, n, i, y);
        if (op == 0) big_mont_mul<L>(x, y, m, z);
        if (op == 1) big_add<L>(x, y, m, z);
        if (op == 2) big_sub<L>(x, y, m, z);
        big_store<L>(out, n, i, z);
    }
}

extern "C" void h_big_op(const uint64_t* a, const uint64_t* b, uint64_t* out,
                         long n, const uint64_t* mod, long L, int op) {
    if (L == 2) mul_n<2>(a, b, out, n, mod, op);
    if (L == 4) mul_n<4>(a, b, out, n, mod, op);
}

// big_ntt's schedule on one thread: tiles of T points (the gather, the
// stages of span 2 .. T), then the stages of span 2T .. n a butterfly at
// a time, scale_last at the launch that runs the last stage
template <int L>
static void ntt(const uint64_t* x, uint64_t* y, const uint64_t* tw,
                const uint64_t* sf, const uint64_t* sl, long n, long T,
                const uint64_t* mod) {
    const BigMod<L> m = big_mod_from<L>(mod);
    int log_n = 0;
    while ((1L << log_n) < n) log_n++;
    uint64_t (*sm)[L] = new uint64_t[T][L];
    for (long base = 0; base < n; base += T) {
        for (long idx = 0; idx < T; idx++) {
            const int64_t src = big_bitrev(base + idx, log_n);
            big_load<L>(x, n, src, sm[idx]);
            if (sf) {
                uint64_t s[L];
                big_load<L>(sf, n, src, s);
                big_mont_mul<L>(sm[idx], s, m, sm[idx]);
            }
        }
        for (long span = 2; span <= T; span *= 2)
            for (long k = 0; k < T / 2; k++) {
                int64_t i0, i1, ti;
                big_stage_pair(k, span, n, i0, i1, ti);
                uint64_t w[L];
                big_load<L>(tw, n / 2, ti, w);
                big_butterfly<L>(sm[i0], sm[i1], w, m);
            }
        for (long idx = 0; idx < T; idx++) {
            if (sl && T == n) {
                uint64_t s[L];
                big_load<L>(sl, n, base + idx, s);
                big_mont_mul<L>(sm[idx], s, m, sm[idx]);
            }
            big_store<L>(y, n, base + idx, sm[idx]);
        }
    }
    delete[] sm;
    for (long span = 2 * T; span <= n; span *= 2)
        for (long k = 0; k < n / 2; k++) {
            int64_t i0, i1, ti;
            big_stage_pair(k, span, n, i0, i1, ti);
            uint64_t u[L], v[L], w[L];
            big_load<L>(y, n, i0, u);
            big_load<L>(y, n, i1, v);
            big_load<L>(tw, n / 2, ti, w);
            big_butterfly<L>(u, v, w, m);
            if (sl && span == n) {
                uint64_t s[L];
                big_load<L>(sl, n, i0, s);
                big_mont_mul<L>(u, s, m, u);
                big_load<L>(sl, n, i1, s);
                big_mont_mul<L>(v, s, m, v);
            }
            big_store<L>(y, n, i0, u);
            big_store<L>(y, n, i1, v);
        }
}

extern "C" void h_big_ntt(const uint64_t* x, uint64_t* y, const uint64_t* tw,
                          const uint64_t* sf, const uint64_t* sl, long n,
                          long T, const uint64_t* mod, long L) {
    if (L == 2) ntt<2>(x, y, tw, sf, sl, n, T, mod);
    if (L == 4) ntt<4>(x, y, tw, sf, sl, n, T, mod);
}
"""


def rand_ints(field, n, seed=0):
    """tests/test_bigvec.py's values: uniform below p from numpy bytes."""
    rng = np.random.default_rng(seed)
    nbytes = (field.p.bit_length() + 7) // 8 + 8
    return [int.from_bytes(rng.bytes(nbytes), "little") % field.p
            for _ in range(n)]


def operands(f):
    a = rand_ints(f, 33, seed=1) + [0, f.p - 1, 1]
    b = rand_ints(f, 33, seed=2) + [f.p - 1, f.p - 1, 0]
    return a, b


ORACLES = {
    "add": lambda p, x, y: (x + y) % p,
    "sub": lambda p, x, y: (x - y) % p,
    "mul": lambda p, x, y: x * y % p,
    "neg": lambda p, x, y: (-x) % p,
}


@pytest.fixture(scope="module")
def lib():
    from ministark_tpu_torch.ops import build

    lib = build.build_host_library("bigfield_check", _HARNESS)
    c, lg = ctypes.c_void_p, ctypes.c_long
    lib.h_big_op.argtypes = [c, c, c, lg, ctypes.c_char_p, lg, ctypes.c_int]
    lib.h_big_ntt.argtypes = [c, c, c, c, c, lg, lg, ctypes.c_char_p, lg]
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


@fields
@pytest.mark.parametrize("op", list(ORACLES))
def test_field_ops_match_bigints(f, op):
    a_i, b_i = operands(f)
    a, b = f.pack(a_i, "cpu"), f.pack(b_i, "cpu")
    got = f.neg(a) if op == "neg" else getattr(f, op)(a, b)
    assert f.unpack(got) == [ORACLES[op](f.p, x, y) for x, y in zip(a_i, b_i)]


@fields
@pytest.mark.parametrize("op", ["pow", "inverse", "batch_inverse"])
def test_pow_and_inverses_match_bigints(f, op):
    a_i = rand_ints(f, 9, seed=3) + [1, f.p - 1]
    a = f.pack(a_i, "cpu")
    e = 0xDEADBEEF
    if op == "pow":
        assert f.unpack(f.pow(a, e)) == [pow(x, e, f.p) for x in a_i]
    else:
        assert f.unpack(getattr(f, op)(a)) == [pow(x, -1, f.p) for x in a_i]


@fields
def test_scalar_operand_broadcasts(f):
    a_i, b_i = operands(f)
    got = f.mul(f.pack(a_i, "cpu"), f.pack_scalar(b_i[0], "cpu")[:, None])
    assert f.unpack(got) == [x * b_i[0] % f.p for x in a_i]
    assert f.unpack(f.ones((3,), "cpu")) == [1, 1, 1]
    assert f.is_zero(f.pack([0, 5, 0], "cpu")).tolist() == [True, False, True]


@fields
def test_pack_matches_jax_package(f):
    """The port's limbs and the JAX package's 16-bit limbs (host numpy,
    no compile) hold the same Montgomery values."""
    from ministark_tpu.fields import bigvec as jbig

    jf = getattr(jbig, f.name + "Vec")
    vals = rand_ints(f, 17) + [0, 1, f.p - 1]
    port = f.pack(vals, "cpu")
    assert torch.equal(convert.from_jax_big_limbs(jf.pack(vals)), port)
    assert np.array_equal(convert.to_jax_big_limbs(port), jf.pack(vals))
    assert jf.unpack(convert.to_jax_big_limbs(port)) == vals
    assert f.unpack(port) == vals
    assert jf.R == f.R


def horner(f, coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % f.p
    return acc


@fields
@pytest.mark.parametrize("offset", [1, 7])
def test_ntt_roundtrip_and_horner(f, offset):
    n = 32
    dom = BigDomain(f, n, offset)
    coeffs = rand_ints(f, n, seed=4)
    evals = dom.fft(f.pack(coeffs, "cpu"))
    ev = f.unpack(evals)
    assert ev == [horner(f, coeffs, dom.element(k)) for k in range(n)]
    assert f.unpack(dom.ifft(evals)) == coeffs


@fields
def test_ntt_matches_jax_package(f):
    """The 32-point coset transform and its inverse against the JAX
    package's BigDomain (eager jnp on the CPU, a few seconds a field)."""
    import jax.numpy as jnp

    from ministark_tpu.fields import bigvec as jbig

    jf = getattr(jbig, f.name + "Vec")
    coeffs = rand_ints(f, 32, seed=4)
    jdom, dom = jbig.BigDomain(jf, 32, 7), BigDomain(f, 32, 7)
    jev = jdom.fft(jnp.asarray(jf.pack(coeffs)))
    ev = dom.fft(f.pack(coeffs, "cpu"))
    assert torch.equal(convert.from_jax_big_limbs(np.asarray(jev)), ev)
    jback = jdom.ifft(jev)
    assert torch.equal(convert.from_jax_big_limbs(np.asarray(jback)),
                       dom.ifft(ev))


@fields
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_header_host_build_matches_bigints(lib, f, op):
    a_i, b_i = operands(f)
    a, b = f.pack(a_i, "cpu"), f.pack(b_i, "cpu")
    out = torch.empty_like(a)
    lib.h_big_op(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[1],
                 f.mod_desc, f.L64, ["mul", "add", "sub"].index(op))
    assert f.unpack(out) == [ORACLES[op](f.p, x, y) for x, y in zip(a_i, b_i)]
    if op == "mul":
        assert torch.equal(out, kbig.big_mul_plain(a, b, f))


@fields
@pytest.mark.parametrize("inverse", [False, True], ids=["fft", "ifft"])
@pytest.mark.parametrize("offset", [1, 7])
@pytest.mark.parametrize("tile", [1, 2, 8, 32])
def test_ntt_host_build_matches_plain(lib, f, inverse, offset, tile):
    """The kernel's schedule with tiles of 1 to 32 points (32: every stage
    in the tile pass) against the plain version and the bigint oracles."""
    n = 32
    dom = BigDomain(f, n, offset)
    x = f.pack(rand_ints(f, n, seed=5), "cpu")
    tw, first, last = dom._tables(inverse, "cpu")
    y = torch.empty_like(x)
    lib.h_big_ntt(x.data_ptr(), y.data_ptr(), tw.data_ptr(), _ptr(first),
                  _ptr(last), n, tile, f.mod_desc, f.L64)
    want = dom.ifft(x) if inverse else dom.fft(x)
    assert torch.equal(y, want)
    if not inverse:
        vals = f.unpack(x)
        assert f.unpack(y)[3] == horner(f, vals, dom.element(3))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: pack goes to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Fp128Vec.pack([1, 2])
    assert kbig.KERNEL_MUL.launches == kbig.KERNEL_NTT.launches == 0
