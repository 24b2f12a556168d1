"""Kernel D's math (csrc/sha256.cuh) on the CPU: the header built by g++
with a host harness, against hashlib, the port's plain versions and the
native host grind; the tree-tops step runs each thread of its block as a
std::thread with the block's barrier.  Equality is exact.

Also the port's plain grind (``ops.sha256.leading_zeros_plain``) against
the JAX package's ``ops.sha256.merge_with_int_words`` and
``leading_zero_bits`` on 256 nonces.
"""

import ctypes
import hashlib

import numpy as np
import pytest

_HARNESS = r"""
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>
#include "sha256.cuh"

struct Barrier {
    std::mutex m;
    std::condition_variable cv;
    int n, count = 0;
    long gen = 0;
    explicit Barrier(int n_) : n(n_) {}
    void wait() {
        std::unique_lock<std::mutex> l(m);
        const long g = gen;
        if (++count == n) {
            count = 0;
            gen++;
            cv.notify_all();
        } else {
            cv.wait(l, [&] { return gen != g; });
        }
    }
};

struct HostSync {
    Barrier* bar;
    void operator()() const { bar->wait(); }
};

// any message: FIPS 180-4 padding built here, then sha256_compress a block
// at a time
extern "C" void h_sha256_bytes(const uint8_t* msg, long len, uint8_t* out) {
    std::vector<uint8_t> buf(msg, msg + len);
    buf.push_back(0x80);
    while (buf.size() % 64 != 56) buf.push_back(0);
    const uint64_t bits = (uint64_t)len * 8;
    for (int k = 7; k >= 0; k--) buf.push_back((uint8_t)(bits >> (8 * k)));
    uint32_t st[8];
    sha256_init(st);
    for (size_t b = 0; b < buf.size(); b += 64) {
        uint32_t w[16];
        sha256_load_digest(&buf[b], w);
        sha256_load_digest(&buf[b + 32], w + 8);
        sha256_compress(st, w);
    }
    sha256_store_digest(out, st);
}

// a W-word message through sha256_message, its padding generated and its
// pure-padding block (if any) run on sha256_pad_kw
extern "C" void h_sha256_words(const uint32_t* words, long W, uint8_t* out) {
    const Sha256KW pad = sha256_pad_kw(W);
    uint32_t st[8];
    sha256_message([&](int64_t t) { return words[t]; }, W, pad.kw, st);
    sha256_store_digest(out, st);
}

extern "C" int h_pad_kw(long W, uint32_t* kw) {
    const Sha256KW pad = sha256_pad_kw(W);
    for (int t = 0; t < 64; t++) kw[t] = pad.kw[t];
    return sha256_total_words(W) > sha256_data_words(W);
}

// row digests as ms_hash_rows reads them: element (i, c) at
// m[i * rs + c * cs], each element's 32-bit halves byte-swapped
extern "C" void h_hash_rows(const uint64_t* m, long n, long ncols, long rs,
                            long cs, uint8_t* out) {
    const Sha256KW pad = sha256_pad_kw(2 * ncols);
    for (long i = 0; i < n; i++) {
        const uint64_t* row = m + i * rs;
        uint32_t st[8];
        sha256_message([&](int64_t t) {
            uint64_t v = row[(t >> 1) * cs];
            return sha256_bswap((t & 1) ? (uint32_t)(v >> 32) : (uint32_t)v);
        }, 2 * ncols, pad.kw, st);
        sha256_store_digest(out + 32 * i, st);
    }
}

extern "C" void h_merge(const uint8_t* left, const uint8_t* right,
                        uint8_t* out, long n) {
    const Sha256KW pad = sha256_pad_kw(16);
    for (long i = 0; i < n; i++) {
        uint32_t w[16], st[8];
        sha256_load_digest(left + 32 * i, w);
        sha256_load_digest(right + 32 * i, w + 8);
        sha256_merge_words(w, pad.kw, st);
        sha256_store_digest(out + 32 * i, st);
    }
}

extern "C" void h_grind_lz(const uint8_t* seed, uint64_t start, long n,
                           int* lz) {
    const Sha256GrindSeed g = sha256_grind_seed(seed);
    for (long i = 0; i < n; i++) {
        uint32_t st[8];
        sha256_grind_digest(g, start + (uint64_t)i, st);
        lz[i] = sha256_leading_zeros(st);
    }
}

// the smallest nonce >= start with >= bits leading zeros, one at a time
extern "C" uint64_t h_grind(const uint8_t* seed, uint64_t start, int bits) {
    const Sha256GrindSeed g = sha256_grind_seed(seed);
    for (uint64_t nonce = start;; nonce++) {
        uint32_t st[8];
        sha256_grind_digest(g, nonce, st);
        if (sha256_leading_zeros(st) >= bits) return nonce;
    }
}

// one block as ms_sha_tree_tops launches it: m/2 threads, the block's
// shared words, a barrier between levels
extern "C" void h_tree_tops(const uint8_t* in, uint8_t* out, long m) {
    const Sha256KW pad = sha256_pad_kw(16);
    const long threads = m / 2;
    std::vector<uint32_t> sm(2 * 8 * threads);
    Barrier bar((int)threads);
    std::vector<std::thread> th;
    for (long t = 0; t < threads; t++)
        th.emplace_back([&, t] {
            sha256_tree_tops(in, out, m, t, sm.data(), pad.kw,
                             HostSync{&bar});
        });
    for (auto& t : th) t.join();
}
"""

U8P = ctypes.POINTER(ctypes.c_uint8)
U32P = ctypes.POINTER(ctypes.c_uint32)
U64P = ctypes.POINTER(ctypes.c_uint64)
I32P = ctypes.POINTER(ctypes.c_int)
P = 0xFFFFFFFF00000001


@pytest.fixture(scope="module")
def lib():
    from ministark_tpu_torch.ops import build

    lib = build.build_host_library("sha256_check", _HARNESS)
    L = ctypes.c_long
    for fn, args in (("h_sha256_bytes", [U8P, L, U8P]),
                     ("h_sha256_words", [U32P, L, U8P]),
                     ("h_hash_rows", [U64P, L, L, L, L, U8P]),
                     ("h_merge", [U8P, U8P, U8P, L]),
                     ("h_grind_lz", [U8P, ctypes.c_uint64, L, I32P]),
                     ("h_tree_tops", [U8P, U8P, L])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = None
    lib.h_pad_kw.argtypes = [L, U32P]
    lib.h_pad_kw.restype = ctypes.c_int
    lib.h_grind.argtypes = [U8P, ctypes.c_uint64, ctypes.c_int]
    lib.h_grind.restype = ctypes.c_uint64
    return lib


def _p(a, t=U8P):
    return a.ctypes.data_as(t)


def _bytes(b):
    return np.frombuffer(b, np.uint8).copy()


@pytest.mark.parametrize("lo", range(0, 301, 50))
def test_compression_matches_hashlib(lib, lo):
    """Messages of every length lo .. lo + 49 bytes (0 .. 300), seeded."""
    rng = np.random.default_rng(lo)
    for n in range(lo, min(lo + 50, 301)):
        msg = rng.integers(0, 256, n, dtype=np.uint8)
        out = np.zeros(32, np.uint8)
        lib.h_sha256_bytes(_p(msg), n, _p(out))
        assert out.tobytes() == hashlib.sha256(msg.tobytes()).digest(), n


def test_padded_word_messages_match_hashlib(lib):
    """Word messages of 0 .. 80 words: the padding generated in place, and
    the pure-padding block of W % 16 in {0, 14, 15} run on its constant
    schedule."""
    rng = np.random.default_rng(3)
    for W in range(81):
        words = rng.integers(0, 1 << 32, W, dtype=np.uint64).astype(np.uint32)
        out = np.zeros(32, np.uint8)
        lib.h_sha256_words(_p(words, U32P), W, _p(out))
        assert out.tobytes() == hashlib.sha256(
            words.astype(">u4").tobytes()).digest(), W


@pytest.mark.parametrize("W", [0, 14, 15, 16, 30, 32, 96])
def test_pad_schedule_is_the_padding_blocks(lib, W):
    """K + W of the pure-padding block against the plain version's
    schedule of the same constant block."""
    from ministark_tpu_torch.ops import sha256 as ksha

    kw = np.zeros(64, np.uint32)
    assert lib.h_pad_kw(W, _p(kw, U32P)) == 1
    total = -(-(W + 3) // 16) * 16
    bitlen = 32 * W
    block = [0] * 16
    if W % 16 == 0:
        block[0] = 0x80000000
    block[14], block[15] = bitlen >> 32, bitlen & 0xFFFFFFFF
    assert total - 16 >= W
    want = [(k + w) & 0xFFFFFFFF
            for k, w in zip(ksha._K, ksha._const_schedule(block))]
    assert kw.tolist() == want


@pytest.mark.parametrize("ncols", [1, 7, 8, 9, 16, 17])
def test_row_digests_match_plain(lib, ncols):
    """Column-major rows read through strides, as the kernel reads the
    trace: 8 and 16 columns end in a pure-padding block, 7 in one with
    only the length."""
    import torch

    from ministark_tpu_torch.ops import sha256 as ksha

    n = 5
    m = np.random.default_rng(ncols).integers(0, P, (ncols, n),
                                              dtype=np.uint64)
    out = np.zeros((n, 32), np.uint8)
    lib.h_hash_rows(_p(m, U64P), n, ncols, 1, n, _p(out))
    want = ksha.hash_rows_plain(torch.from_numpy(m.view(np.int64)).T)
    np.testing.assert_array_equal(out, want.numpy())


def test_merges_match_hashlib(lib):
    d = np.random.default_rng(11).integers(0, 256, (2, 20, 32),
                                           dtype=np.uint8)
    out = np.zeros((20, 32), np.uint8)
    lib.h_merge(_p(d[0]), _p(d[1]), _p(out), 20)
    for i in range(20):
        assert out[i].tobytes() == hashlib.sha256(
            d[0, i].tobytes() + d[1, i].tobytes()).digest(), i


@pytest.mark.parametrize("bits", range(6, 17))
def test_grind_matches_native_pow_grind(lib, bits):
    """The grind's midstate and 8-byte nonce against the native host
    grind, over 8 seeds."""
    from ministark_tpu_torch import native

    for s in range(8):
        seed = hashlib.sha256(bytes([bits, s])).digest()
        assert lib.h_grind(_p(_bytes(seed)), 1, bits) == native.pow_grind(
            seed, bits), s


def test_grind_carries_into_the_high_word(lib):
    """Nonces across 2^32: the low word wraps, the high word takes the
    carry (leading zeros against hashlib's digests), and a grind from just
    below 2^32 ends at the first valid nonce above it."""
    from ministark_tpu_torch import hash as H

    seed = bytes(range(32))
    start, n = (1 << 32) - 40, 80
    lz = (ctypes.c_int * n)()
    lib.h_grind_lz(_p(_bytes(seed)), start, n, lz)
    want = [H.leading_zeros(H.merge_with_int(seed, start + i))
            for i in range(n)]
    assert list(lz) == want
    # from just past the last hit below 2^32, the first hit above it
    bits = 3
    below = [i for i in range(40) if want[i] >= bits]
    from_ = start + (below[-1] + 1 if below else 0)
    first = next(start + i for i in range(40, n) if want[i] >= bits)
    assert lib.h_grind(_p(_bytes(seed)), from_, bits) == first


def test_plain_leading_zeros_match_the_header(lib):
    """The wrappers' plain version (what the CPU prover grinds with)
    against the header, across 2^32."""
    from ministark_tpu_torch.ops import sha256 as ksha

    seed = hashlib.sha256(b"plain").digest()
    start, n = (1 << 32) - 100, 200
    lz = (ctypes.c_int * n)()
    lib.h_grind_lz(_p(_bytes(seed)), start, n, lz)
    assert ksha.leading_zeros_plain(seed, start, n).tolist() == list(lz)
    assert ksha.grind(seed, 9, "cpu") == lib.h_grind(_p(_bytes(seed)), 1, 9)


@pytest.mark.parametrize("m", [2, 4, 8, 16, 32, 64, 256])
def test_tree_tops_match_merge_plain(lib, m):
    """Every level above m digests, written one after the other by one
    block of m/2 threads, equals merge_plain of the two halves of the
    level below as written (the leaves for the first)."""
    import torch

    from ministark_tpu_torch.ops import sha256 as ksha

    leaves = np.random.default_rng(60 + m).integers(0, 256, (m, 32),
                                                    dtype=np.uint8)
    out = np.zeros((m - 1, 32), np.uint8)
    lib.h_tree_tops(_p(leaves), _p(out), m)
    levels = [leaves] + [out[m - 2 * h:m - h] for h in _halves(m)]
    left = np.concatenate([lv[:lv.shape[0] // 2] for lv in levels[:-1]])
    right = np.concatenate([lv[lv.shape[0] // 2:] for lv in levels[:-1]])
    want = ksha.merge_plain(torch.from_numpy(left), torch.from_numpy(right))
    np.testing.assert_array_equal(out, want.numpy())


def _halves(m):
    """Node counts of the levels above m leaves: m/2, m/4, .., 1."""
    return [m >> k for k in range(1, m.bit_length())]


def test_tree_levels_same_with_and_without_tops(lib):
    """merkle.tree_levels on the CPU merges every level (the tops launch
    is the card's); the levels at and above TOPS_LEAVES nodes equal the
    tops step's from the same level, and tree_tops refuses a CPU tensor."""
    import torch

    from ministark_tpu_torch import hash as H
    from ministark_tpu_torch import merkle
    from ministark_tpu_torch.ops import sha256 as ksha

    n, m = 256, ksha.TOPS_LEAVES
    leaves = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (n, 32), dtype=np.uint8))
    levels = merkle.tree_levels(leaves, H)
    assert [lv.shape[0] for lv in levels] == [n >> k for k in range(9)]
    start = levels[(n // m).bit_length() - 1].numpy()
    assert start.shape[0] == m
    out = np.zeros((m - 1, 32), np.uint8)
    lib.h_tree_tops(_p(np.ascontiguousarray(start)), _p(out), m)
    above = torch.cat(levels[(n // m).bit_length():]).numpy()
    np.testing.assert_array_equal(out, above)
    assert ksha.KERNEL_TREE.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        ksha.tree_tops(torch.from_numpy(start))


def test_plain_leading_zeros_match_jax_package():
    """256 seeded nonces across 2^32 through the port's plain grind and the
    JAX package's merge_with_int_words + leading_zero_bits."""
    import jax.numpy as jnp

    from ministark_tpu.ops import sha256 as dsha
    from ministark_tpu_torch.ops import sha256 as ksha

    seed = hashlib.sha256(b"jax").digest()
    start, n = (1 << 32) - 128, 256
    nonces = np.array([[(start + i) >> 32, (start + i) & 0xFFFFFFFF]
                       for i in range(n)], np.uint32)
    seed_words = jnp.asarray(dsha.digest_bytes_to_words_np([seed])[0])
    want = np.asarray(dsha.leading_zero_bits(
        dsha.merge_with_int_words(seed_words, jnp.asarray(nonces))))
    got = ksha.leading_zeros_plain(seed, start, n).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.max() >= 4  # the counts are not all trivial
