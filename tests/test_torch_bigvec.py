"""The port's big prime field vectors (``ministark_tpu_torch.fields.bigvec``,
Fp128 and Fp252 as u64 Montgomery limbs) on the CPU, through the plain
versions of ``ops.bigfield``, against Python bigint oracles on the values
of the JAX package's ``tests/test_bigvec.py`` (numpy seeds 0-4), against
the JAX package's ``pack`` (host numpy) through ``fields.convert``, and
the 32-point NTT, plain and coset, against the JAX package's
``BigDomain`` and Horner's rule.

csrc/bigfield.cuh is built by g++ with a host harness that runs the
kernels' code: the products (specialised to Fp128's and Fp252's sparse
words, and the generic CIOS, on those primes and on other odd moduli) and
sums against bigints on raw Montgomery limbs and edges, the NTT's pass
plan, and each pass of the transform a block and a thread at a time
between its barriers (shared memory poisoned before each exchange) with
the twiddle table BigDomain builds, at n = 1 .. 2^12, passes of up to
2^9 points and, in a second build, of up to 2^5 (three passes), several
groups a block, against the plain version and the bigint oracles.
Equality is exact.
"""

import ctypes
import functools

import numpy as np
import pytest
import torch

from ministark_tpu_torch.fields import convert
from ministark_tpu_torch.fields.bigvec import (BigDomain, BigField, Fp128Vec,
                                               Fp252Vec)
from ministark_tpu_torch.ops import bigfield as kbig

FIELDS = [Fp128Vec, Fp252Vec]
fields = pytest.mark.parametrize("f", FIELDS, ids=lambda f: f.name)

_HARNESS = r"""
#include <stddef.h>
#include <vector>
#include "bigfield.cuh"

// the product, sum and difference an element at a time (b of stride 0 or
// 1), in the field the modulus names (generic: BigGeneric whatever it is);
// returns 1 where that was a BigSparse field
template <class F>
static void op_n(const F& f, const uint64_t* a, const uint64_t* b,
                 uint64_t* out, long n, long bs, int op) {
    constexpr int W = F::W;
    for (long i = 0; i < n; i++) {
        uint32_t x[W], y[W], z[W];
        big_ld<W>(a, n, i, x);
        big_ld<W>(b, bs ? n : 1, i * bs, y);
        if (op == 0) f.mul(x, y, z);
        if (op == 1) big_add(f, x, y, z);
        if (op == 2) big_sub(f, x, y, z);
        big_st<W>(out, n, i, z);
    }
}

extern "C" int h_big_op(const uint64_t* a, const uint64_t* b, uint64_t* out,
                        long n, long bs, const uint64_t* mod, long L, int op,
                        int generic) {
    return big_dispatch(mod, L, [&](auto f) {
        op_n(f, a, b, out, n, bs, op);
        return (int)decltype(f)::SPARSE;
    }, generic != 0);
}

// the plan: passes, then each pass's log_r, v, rounds and their log_rho
extern "C" long h_big_ntt_plan(long log_n, long* out, int64_t* exps) {
    BigNttPlan pl;
    big_ntt_plan((int)log_n, pl, exps);
    long k = 0;
    out[k++] = pl.passes;
    for (int q = 0; q < pl.passes; q++) {
        out[k++] = pl.pass[q].log_r;
        out[k++] = pl.pass[q].v;
        out[k++] = pl.pass[q].nrounds;
        for (int b = 0; b < pl.pass[q].nrounds; b++)
            out[k++] = pl.pass[q].log_rho[b];
    }
    return pl.table;
}

// one pass as the kernel runs it, a block at a time and, between its
// barriers, a thread at a time; shared memory poisoned before each exchange
template <class F, int V>
static void pass_host(const F& f, BigNttPass ps, const uint64_t* x,
                      uint64_t* y, const uint64_t* tab, int64_t ntab,
                      const uint64_t* sf, const uint64_t* sl, long points) {
    constexpr int W = F::W;
    typedef uint32_t (*regs)[W];
    ps.cols = big_ntt_cols(ps, points);
    const int64_t R = (int64_t)1 << ps.log_r, groups = ps.n / R;
    const int threads = (int)(ps.cols * (R / V));
    std::vector<uint64_t> sm((W / 2) * big_plane(ps));
    std::vector<uint32_t> reg((size_t)threads * V * W);
    for (int64_t blk = 0; blk < groups / ps.cols; blk++) {
        auto each = [&](auto fn) {
            for (int tid = 0; tid < threads; tid++)
                fn(tid % ps.cols, tid / ps.cols,
                   (regs)&reg[(size_t)tid * V * W]);
        };
        each([&](int col, int t, regs v) {
            big_ntt_load<F, V>(f, ps, x, sf, tab, ntab,
                               blk * ps.cols + col, t, v);
        });
        for (int b = 0; b < ps.nrounds; b++) {
            if (b > 0) {
                for (auto& s : sm) s = 0xA5A5A5A5A5A5A5A5ULL;
                each([&](int col, int t, regs v) {
                    big_ntt_put<F, V>(ps, b - 1, sm.data(), col, t, v);
                });
                each([&](int col, int t, regs v) {
                    big_ntt_get<F, V>(ps, sm.data(), col, t, v);
                });
            }
            each([&](int, int t, regs v) {
                big_ntt_round<F, V>(f, ps, b, tab, ntab, t, v);
            });
        }
        each([&](int col, int t, regs v) {
            big_ntt_store<F, V>(f, ps, y, sl, blk * ps.cols + col, t, v);
        });
    }
}

template <class F, int V>
static void ntt_host(const F& f, const BigNttPlan& pl, const uint64_t* x,
                     uint64_t* y, uint64_t* tmp, const uint64_t* tab,
                     int64_t ntab, const uint64_t* sf, const uint64_t* sl,
                     long points) {
    const uint64_t* in = x;
    for (int q = 0; q < pl.passes; q++) {
        uint64_t* out = (pl.passes - 1 - q) % 2 == 0 ? y : tmp;
        pass_host<F, V>(f, pl.pass[q], in, out, tab, ntab,
                        q == 0 ? sf : nullptr,
                        q == pl.passes - 1 ? sl : nullptr, points);
        in = out;
    }
}

// big_ntt's launches with `points` a block (the kernel: 2048)
extern "C" int h_big_ntt(const uint64_t* x, uint64_t* y, uint64_t* tmp,
                         const uint64_t* tab, long ntab, const uint64_t* sf,
                         const uint64_t* sl, long n, const uint64_t* mod,
                         long L, int generic, long points) {
    int log_n = 0;
    while ((1L << log_n) < n) log_n++;
    BigNttPlan pl;
    big_ntt_plan(log_n, pl, nullptr);
    if (ntab != pl.table) return -2;
    return big_dispatch(mod, L, [&](auto f) {
        using F = decltype(f);
        const int v = pl.pass[0].v;
        if (v == 4) ntt_host<F, 4>(f, pl, x, y, tmp, tab, ntab, sf, sl, points);
        if (v == 2) ntt_host<F, 2>(f, pl, x, y, tmp, tab, ntab, sf, sl, points);
        if (v == 1) ntt_host<F, 1>(f, pl, x, y, tmp, tab, ntab, sf, sl, points);
        return (int)F::SPARSE;
    }, generic != 0);
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


# the harness's second build: passes of up to 2^5 points
SMALL = {"BIG_NTT_LOG_R": 5}


def _build(log_r=None):
    from ministark_tpu_torch.ops import build

    head = "" if log_r is None else "".join(
        f"#define {k} {v}\n" for k, v in SMALL.items())
    lib = build.build_host_library(f"bigfield_check{log_r or ''}",
                                   head + _HARNESS)
    c, lg = ctypes.c_void_p, ctypes.c_long
    lib.h_big_op.argtypes = [c, c, c, lg, lg, ctypes.c_char_p, lg,
                             ctypes.c_int, ctypes.c_int]
    lib.h_big_ntt_plan.argtypes = [lg, c, c]
    lib.h_big_ntt_plan.restype = lg
    lib.h_big_ntt.argtypes = [c, c, c, c, lg, c, c, lg, ctypes.c_char_p, lg,
                              ctypes.c_int, lg]
    return lib


@pytest.fixture(scope="module")
def libs():
    """The harness as the kernel builds it (passes of up to 2^9 points, 4
    values a thread: radix-2 and -4 rounds), and with passes of up to 2^5
    (three passes at 2^11 and 2^12)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as ex:  # two g++ processes at once
        return dict(zip((9, 5), ex.map(_build, (None, 5))))


@pytest.fixture(scope="module")
def lib(libs):
    return libs[9]


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
    sparse = lib.h_big_op(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                          a.shape[1], 1, f.mod_desc, f.L64,
                          ["mul", "add", "sub"].index(op), 0)
    assert sparse == 1
    assert f.unpack(out) == [ORACLES[op](f.p, x, y) for x, y in zip(a_i, b_i)]
    if op == "mul":
        assert torch.equal(out, kbig.big_mul_plain(a, b, f))


# odd moduli that take the generic product: a Mersenne prime below R/2,
# and primes above R/2 (the result's overflow word) at L = 2 and 4
OTHER = [BigField("M127", 2**127 - 1, 3, 1),
         BigField("P128m159", 2**128 - 159, 3, 1),
         BigField("P255m19", 2**255 - 19, 2, 2)]
PRODUCTS = [(f, g) for f in FIELDS for g in (False, True)] + [
    (f, True) for f in OTHER]


def raw_operands(f, n, seed):
    """Montgomery limbs that are not the pack of anything in particular:
    numpy-seeded words below p and the edges 0, 1, p - 1, p - 2, R mod p,
    2^(64 L - 1) mod p, and words just below p's top limb boundaries."""
    vals = rand_ints(f, n, seed) + [0, 1, f.p - 1, f.p - 2, f.R % f.p,
                                    (f.R >> 1) % f.p]
    vals += [(f.p >> (64 * k)) << (64 * k) for k in range(1, f.L64)]
    return vals


@pytest.mark.parametrize("f, generic", PRODUCTS,
                         ids=[f"{f.name}-{'generic' if g else 'sparse'}"
                              for f, g in PRODUCTS])
def test_products_match_bigints(lib, f, generic):
    """The specialised product (the named primes) and the generic one
    (forced for them, and any other odd modulus) on raw Montgomery limbs:
    a b R^-1 mod p, every pair of values and edges, against bigints and the
    plain version; a scalar second operand too."""
    vals = raw_operands(f, 24, seed=11)
    a_i = [x for x in vals for _ in vals]
    b_i = [y for _ in vals for y in vals]
    a, b = f._limbs(a_i, "cpu"), f._limbs(b_i, "cpu")
    out = torch.empty_like(a)
    sparse = lib.h_big_op(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                          a.shape[1], 1, f.mod_desc, f.L64, 0, int(generic))
    assert sparse == (not generic)
    r_inv = f.R_inv
    want = [x * y * r_inv % f.p for x, y in zip(a_i, b_i)]
    got = out.T.contiguous().numpy().tobytes()
    nb = 8 * f.L64
    assert [int.from_bytes(got[i:i + nb], "little")
            for i in range(0, len(got), nb)] == want
    assert torch.equal(out, kbig.big_mul_plain(a, b, f))
    scalar = b[:, 7:8].contiguous()
    lib.h_big_op(a.data_ptr(), scalar.data_ptr(), out.data_ptr(), a.shape[1],
                 0, f.mod_desc, f.L64, 0, int(generic))
    assert torch.equal(out, kbig.big_mul_plain(a, scalar, f))


def plan(lib, log_n):
    out = (ctypes.c_long * 64)()
    count = lib.h_big_ntt_plan(log_n, out, None)
    exps = np.zeros(max(min(count, 1 << 20), 1), dtype=np.int64)
    if count <= 1 << 20:  # the exponents of transforms a test runs
        lib.h_big_ntt_plan(log_n, out, exps.ctypes.data)
    passes, k, rows = out[0], 1, []
    for _ in range(passes):
        log_r, v, nr = out[k], out[k + 1], out[k + 2]
        rows.append((log_r, v, list(out[k + 3:k + 3 + nr])))
        k += 3 + nr
    return rows, exps[:count]


@pytest.mark.parametrize("log_r", [9, 5])
@pytest.mark.parametrize("log_n", [0, 1, 2, 3, 5, 9, 10, 11, 12, 18, 19, 27,
                                   28, 40])
def test_ntt_plan(libs, log_r, log_n):
    """Passes of at most 2^log_r points that multiply to n (2^18 points:
    two passes), each a smaller round then rounds of the thread's V =
    min(4, n) values, V <= R; the table's exponents below n."""
    rows, exps = plan(libs[log_r], log_n)
    vmax = 4
    assert len(rows) == max(1, -(-log_n // log_r))
    assert sum(r for r, _v, _rounds in rows) == log_n
    for r, v, rounds in rows:
        assert r <= log_r and sum(rounds) == r and v == min(vmax, 1 << log_n)
        assert all(1 << x == v for x in rounds[1:])
        assert 1 << max(rounds + [0]) <= v <= 1 << r
    if log_r == 9 and log_n == 18:
        assert [r for r, _v, _rounds in rows] == [9, 9]
    assert ((exps >= 0) & (exps < (1 << log_n))).all()


NTT_CASES = [  # (n, a pass's largest radix, points a block, generic)
    (1, 9, 2048, False), (2, 9, 2048, False), (4, 9, 2048, True),
    (8, 9, 2048, False), (32, 9, 2048, False), (128, 9, 64, False),
    (1 << 9, 9, 2048, False), (1 << 10, 9, 2048, False),
    (1 << 11, 9, 256, True), (1 << 12, 9, 2048, False),
    (8, 5, 2048, False), (1 << 9, 5, 2048, False),
    (1 << 11, 5, 2048, False), (1 << 12, 5, 64, False)]


@functools.lru_cache(maxsize=None)
def _ntt_inputs(f, n, offset, inverse):
    dom = BigDomain(f, n, offset)
    x = f.pack(rand_ints(f, n, seed=5), "cpu")
    tw, first, last = dom._tables(inverse, "cpu")
    return dom, x, tw, first, last, dom.ifft(x) if inverse else dom.fft(x)


@fields
@pytest.mark.parametrize("inverse", [False, True], ids=["fft", "ifft"])
@pytest.mark.parametrize("offset", [1, 7])
@pytest.mark.parametrize("case", NTT_CASES,
                         ids=[f"n{n}-r{r}-b{b}{'-generic' if g else ''}"
                              for n, r, b, g in NTT_CASES])
def test_ntt_host_build_matches_plain(libs, f, inverse, offset, case):
    """The kernel's passes, a block and a thread at a time, with the table
    BigDomain builds (``twiddle_values`` over the plan's exponents),
    against the plain version and, at a point, the bigint oracle."""
    n, log_r, points, generic = case
    lib = libs[log_r]
    dom, x, tw, first, last, want = _ntt_inputs(f, n, offset, inverse)
    _rows, exps = plan(lib, n.bit_length() - 1)
    tab = kbig.twiddle_values(tw, f, n, torch.from_numpy(exps))
    y, tmp = torch.empty_like(x), torch.empty_like(x)
    sparse = lib.h_big_ntt(x.data_ptr(), y.data_ptr(), tmp.data_ptr(),
                           tab.data_ptr(), tab.shape[1], _ptr(first),
                           _ptr(last), n, f.mod_desc, f.L64, int(generic),
                           points)
    assert sparse == (not generic)
    assert torch.equal(y, want)
    k = 3 % n
    if not inverse:
        assert f.unpack(y)[k] == horner(f, f.unpack(x), dom.element(k))
    else:
        evals = f.unpack(x)
        w_inv = pow(dom.group_gen_inv, k, f.p)
        acc = sum(e * pow(w_inv, i, f.p) for i, e in enumerate(evals)) % f.p
        want_k = acc * dom.size_inv * pow(pow(dom.offset, -1, f.p), k, f.p)
        assert f.unpack(y)[k] == want_k % f.p


def test_twiddle_table_is_cached_per_domain(monkeypatch):
    """BigDomain builds the kernel's table from its own twiddles once per
    direction and device; a transform of CPU tensors builds none."""
    calls = []
    monkeypatch.setattr(kbig.KERNEL_NTT, "query",
                        lambda fn, *a: calls.append(fn) or (4 if fn.endswith(
                            "table") else 1))
    f = Fp128Vec
    dom = BigDomain(f, 8, 3)
    dom.fft(f.pack(rand_ints(f, 8), "cpu"))
    assert calls == []
    try:
        first = dom._kernel_table(False, "cpu")
        assert dom._kernel_table(False, "cpu") is first
        n_calls = len(calls)
        assert dom._kernel_table(True, "cpu") is not first
        assert len(calls) > n_calls
        tw = dom._tables(False, "cpu")[0]
        zeros = torch.zeros(4, dtype=torch.int64)  # the mocked exponents
        assert torch.equal(first[0], kbig.twiddle_values(tw, f, 8, zeros))
        assert first[1] == 1
    finally:  # the mocked tables go
        BigDomain._kernel_table.cache_clear()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: pack goes to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Fp128Vec.pack([1, 2])
    assert kbig.KERNEL_MUL.launches == kbig.KERNEL_NTT.launches == 0
