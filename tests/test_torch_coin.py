"""The port's device coin step (``ministark_tpu_torch.ops.coin``) on the
CPU: the plain versions and csrc/coin.cuh built by g++, against the host
coin (the port's and the JAX package's ``random.PublicCoin``) and, for
the SHA-256 step, the JAX package's device coin (``ops.coin.reseed`` and
``draw_fps``).  The RPO-256 step is held to the host coin only: the JAX
package's ``rpo_draw_fps`` takes minutes to compile on the CPU.

The host build runs both steps as the kernels do, on a warp of 32 lanes,
each lane a std::thread, the ballots and shuffles emulated by barriers:
the SHA-256 step's digests 32 counters a round, its accepted draws placed
by ballots (also on crafted candidates: rejections, a round boundary,
alpha's components across rounds), the RPO-256 step on two groups of 16
lanes (with gl_mul_cc's products and with the kernel's wide ones), and
alpha's powers by the prefix product over the lanes (Fp and Fq3, past 32
powers).  Equality is exact.
"""

import ctypes
import hashlib

import numpy as np
import pytest
import torch

from ministark_tpu_torch import hash as H
from ministark_tpu_torch import hash_rpo
from ministark_tpu_torch.fields.scalar import Fp, Fq3, P
from ministark_tpu_torch.ops import coin as kcoin
from ministark_tpu_torch.random import PublicCoin

_HARNESS = r"""
#include <condition_variable>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>
#include "coin.cuh"

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

// a group's exchange: lane l's value in slot l, between two barriers
struct HostEx {
    Barrier* bar;
    uint64_t* slots;
    int lane;
    void operator()(const uint64_t* v, uint64_t* s) const {
        slots[lane] = v[0];
        bar->wait();
        for (int k = 0; k < RPO_WIDTH; k++) s[k] = slots[k];
        bar->wait();
    }
};

// the warp's collectives (coin.cuh's Warp): each lane's value in its
// slot, between two barriers of the 32 lanes
struct HostWarp {
    Barrier* bar;
    uint64_t* slots;
    int lane;
    uint64_t swap(uint64_t v, int from) {
        slots[lane] = v;
        bar->wait();
        const uint64_t r = slots[from];
        bar->wait();
        return r;
    }
    uint32_t ballot(bool p) {
        slots[lane] = p;
        bar->wait();
        uint32_t m = 0;
        for (int l = 0; l < COIN_LANES; l++)
            if (slots[l]) m |= 1u << l;
        bar->wait();
        return m;
    }
    uint64_t shfl(uint64_t v, int from) { return swap(v, from); }
    uint64_t shfl_up(uint64_t v, int d) {
        return swap(v, lane >= d ? lane - d : lane);
    }
};

// fn(lane, warp) on 32 lanes, each a std::thread
static void on_warp(const std::function<void(int, HostWarp&)>& fn) {
    Barrier bar(COIN_LANES);
    std::vector<uint64_t> slots(COIN_LANES);
    std::vector<std::thread> lanes;
    for (int l = 0; l < COIN_LANES; l++)
        lanes.emplace_back([&, l] {
            HostWarp w{&bar, slots.data(), l};
            fn(l, w);
        });
    for (auto& th : lanes) th.join();
}

extern "C" void h_coin_sha(const uint8_t* seed, const uint8_t* root, long k,
                           long N, uint8_t* seed_out, uint64_t* draws,
                           uint64_t* pw) {
    on_warp([&](int l, HostWarp& w) {
        coin_sha_warp(seed, root, k, N, l, w, seed_out, draws, pw);
    });
}

// The draws of rounds of given candidates: cands[(r * 32 + lane) * 4 + i]
// is the popped u64 i of lane's digest in round r; rounds run until k are
// accepted (or `rounds` run out).  alpha gets the components of places
// below ka.  Returns the u64s accepted.
extern "C" long h_coin_sha_select(const uint64_t* cands, long rounds, long k,
                                  long ka, uint64_t* draws, uint64_t* alpha) {
    long out = 0;
    on_warp([&](int l, HostWarp& w) {
        gl3 a = gl3_from_base(0);
        int64_t got = 0;
        for (long r = 0; r < rounds && got < k; r++)
            got = coin_sha_select(cands + (r * COIN_LANES + l) * 4, l, got, k,
                                  ka, w, draws, a);
        if (l == 0) {
            out = got;
            alpha[0] = a.c0;
            alpha[1] = a.c1;
            alpha[2] = a.c2;
        }
    });
    return out;
}

// one digest's draws (words d) as lane 0's candidates, every other lane's
// rejected: the draws in pop order
extern "C" long h_coin_sha_take(const uint32_t* d, long k, uint64_t* draws) {
    std::vector<uint64_t> cands(COIN_LANES * 4, ~0ULL);
    for (int i = 0; i < 4; i++) cands[i] = coin_sha_popped(d, i);
    uint64_t alpha[3];
    const long got = h_coin_sha_select(cands.data(), 1, k, 0, draws, alpha);
    return got < k ? got : k;
}

extern "C" void h_alpha_powers(const uint64_t* a, long k, long N,
                               uint64_t* pw) {
    on_warp([&](int l, HostWarp& w) {
        coin_alpha_powers_warp(gl3_make(a[0], k == 3 ? a[1] : 0,
                                        k == 3 ? a[2] : 0),
                               k, N, l, w, pw);
    });
}

// The RPO-256 step as the kernel runs it: two groups of 16 lanes (one
// element a lane) on one warp of 32 threads, the products gl_mul_cc_fn's
// (gl_mul on the host) or gl_mul_wide_fn's (the kernel's, its own code on
// the host too)
template <class Mul>
static void rpo_warp(const uint8_t* seed, const uint8_t* root, long k, long N,
                     uint8_t* seed_out, uint64_t* draws, uint64_t* pw) {
    const int G = rpo_group_lanes<1>();
    const uint64_t* rc = &rpo_rc_host[0][0][0];
    Barrier gb0(G), gb1(G);
    Barrier* gbars[2] = {&gb0, &gb1};
    std::vector<std::vector<uint64_t>> gslots(2, std::vector<uint64_t>(G));
    on_warp([&](int l, HostWarp& w) {
        const int g = l / G;
        const RpoLane<1> ln(l % G, rc);
        const HostEx ex{gbars[g], gslots[g].data(), l % G};
        coin_rpo_warp(seed, root, k, N, l, CoinRpoPerm<HostEx, Mul>{ln, ex},
                      w, seed_out, draws, pw);
    });
}

extern "C" void h_coin_rpo(const uint8_t* seed, const uint8_t* root, long k,
                           long N, uint8_t* seed_out, uint64_t* draws,
                           uint64_t* pw) {
    rpo_warp<gl_mul_cc_fn>(seed, root, k, N, seed_out, draws, pw);
}

extern "C" void h_coin_rpo_lanes(const uint8_t* seed, const uint8_t* root,
                                 long k, long N, uint8_t* seed_out,
                                 uint64_t* draws, uint64_t* pw) {
    rpo_warp<gl_mul_wide_fn>(seed, root, k, N, seed_out, draws, pw);
}

// merge_with_int(seed, counter)'s digest elements
extern "C" void h_rpo_draw_digest(const uint64_t* seed, uint64_t counter,
                                  uint64_t* d) {
    uint64_t s[RPO_WIDTH];
    coin_rpo_draw_state(s, seed, counter);
    rpo_permute(s);
    for (int j = 0; j < RPO_DIGEST; j++) d[j] = s[RPO_CAPACITY + j];
}
"""

SEEDS = [hashlib.sha256(b"coin seed %d" % i).digest() for i in range(5)]
ROOTS = [hashlib.sha256(b"layer root %d" % i).digest() for i in range(5)]


def _rpo_digest(tag: int) -> bytes:
    """An RPO digest (four canonical elements), as RPO trees' roots are."""
    return hash_rpo.hash_elements([tag, 7 * tag + 1])


RPO_SEEDS = [_rpo_digest(i) for i in range(5)]
RPO_ROOTS = [_rpo_digest(100 + i) for i in range(5)]


@pytest.fixture(scope="module")
def lib():
    from ministark_tpu_torch.ops import build

    lib = build.build_host_library("coin_check", _HARNESS)
    c, lg, u64 = ctypes.c_void_p, ctypes.c_long, ctypes.c_uint64
    for name in ("h_coin_sha", "h_coin_rpo", "h_coin_rpo_lanes"):
        getattr(lib, name).argtypes = [ctypes.c_char_p, ctypes.c_char_p, lg,
                                       lg, c, c, c]
    lib.h_coin_sha_take.argtypes = [c, lg, c]
    lib.h_coin_sha_take.restype = ctypes.c_long
    lib.h_coin_sha_select.argtypes = [c, lg, lg, lg, c, c]
    lib.h_coin_sha_select.restype = ctypes.c_long
    lib.h_alpha_powers.argtypes = [c, lg, lg, c]
    lib.h_rpo_draw_digest.argtypes = [c, u64, c]
    return lib


def host_step(seed: bytes, root: bytes, k: int, hashfn, jax=False):
    """The host coin's reseed with `root`, then k Fp draws (the seed and
    the draws' values): the port's coin, or the JAX package's where
    `jax`."""
    if jax:
        from ministark_tpu.fields.scalar import Fp as JFp
        from ministark_tpu.random import PublicCoin as JPublicCoin

        coin = JPublicCoin(seed, JFp, hashfn)
    else:
        coin = PublicCoin(seed, Fp, hashfn)
    coin.reseed_with_digest(root)
    return coin.seed, [coin.draw().v for _ in range(k)]


def host_powers(draws: list[int], N: int) -> list[list[int]]:
    """alpha^j for j < N, (k, N) component planes, from host scalars."""
    alpha = Fp(draws[0]) if len(draws) == 1 else Fq3(*map(Fp, draws))
    p, out = type(alpha).one(), []
    for _ in range(N):
        out.append([p.v] if len(draws) == 1 else [p.c0.v, p.c1.v, p.c2.v])
        p = p * alpha
    return [list(col) for col in zip(*out)] if out else [[]] * len(draws)


def plain_step(fn, seed: bytes, root: bytes, k: int, N: int = 0):
    """(seed', draws[, powers]) of a plain coin step, as host values."""
    new, draws, pw = fn(kcoin.seed_tensor(seed, "cpu"),
                        kcoin.seed_tensor(root, "cpu"), k, N)
    out = (bytes(new.tolist()), [v % (1 << 64) for v in draws.tolist()])
    if not N:
        return out
    return out + ([[v % (1 << 64) for v in row] for row in pw.tolist()],)


def host_build_step(fn, seed: bytes, root: bytes, k: int, N: int = 0):
    out = ctypes.create_string_buffer(32)
    draws = np.zeros(k, dtype=np.uint64)
    pw = np.zeros((k, max(N, 1)), dtype=np.uint64)
    fn(seed, root, k, N, out, draws.ctypes.data, pw.ctypes.data)
    res = (out.raw, [int(v) for v in draws])
    if not N:
        return res
    return res + ([[int(v) for v in row] for row in pw],)


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("i", range(5))
def test_sha_step_matches_host_coin(lib, i, k):
    """The plain version and the host build against the port's and the
    JAX package's host coin, k = 5 reaching the second digest."""
    from ministark_tpu import hash as jH

    want = host_step(SEEDS[i], ROOTS[i], k, H)
    assert host_step(SEEDS[i], ROOTS[i], k, jH, jax=True) == want
    assert plain_step(kcoin.coin_sha_plain, SEEDS[i], ROOTS[i], k) == want
    assert host_build_step(lib.h_coin_sha, SEEDS[i], ROOTS[i], k) == want


@pytest.mark.parametrize("i", range(2))
def test_sha_step_matches_jax_device_coin(i):
    """The JAX package's device coin (reseed, then draw_fps) on two
    seeds."""
    from ministark_tpu.ops import coin as jcoin

    seed = jcoin.reseed(jcoin.seed_to_words(SEEDS[i]),
                        jcoin.seed_to_words(ROOTS[i]))
    jax_draws = [jcoin.alpha_canonical_int(d)
                 for d in jcoin.draw_fps(seed, 5)]
    new, draws = plain_step(kcoin.coin_sha_plain, SEEDS[i], ROOTS[i], 5)
    assert new == b"".join(int(w).to_bytes(4, "big")
                           for w in np.asarray(seed))
    assert draws == jax_draws


def test_sha_step_takes_an_rpo_root_as_bytes(lib):
    """Over RPO-256 trees the SHA-256 coin absorbs the root's 32 bytes."""
    want = host_step(SEEDS[0], RPO_ROOTS[0], 3, H)
    assert plain_step(kcoin.coin_sha_plain, SEEDS[0], RPO_ROOTS[0], 3) == want
    assert host_build_step(lib.h_coin_sha, SEEDS[0], RPO_ROOTS[0], 3) == want


@pytest.mark.parametrize("k", range(1, 9))
def test_rpo_step_matches_host_coin(lib, k):
    """k = 1-8 (two digests from k = 5), one seed and root a k: the plain
    version and the host build as the kernel's two groups of lanes (the
    carry-chain products, and the kernel's wide products), against the
    port's and the JAX package's host coin."""
    from ministark_tpu import hash_rpo as jrpo

    seed, root = RPO_SEEDS[k % 5], RPO_ROOTS[(k + 2) % 5]
    want = host_step(seed, root, k, hash_rpo)
    assert host_step(seed, root, k, jrpo, jax=True) == want
    assert plain_step(kcoin.coin_rpo_plain, seed, root, k) == want
    assert host_build_step(lib.h_coin_rpo, seed, root, k) == want
    assert host_build_step(lib.h_coin_rpo_lanes, seed, root, k) == want


@pytest.mark.parametrize("counter", [1, 2, (1 << 32) + 5, (1 << 40) + 3])
def test_rpo_draw_digest_takes_the_counters_high_half(lib, counter):
    """merge_with_int at counters at and above 2^32: the plain version and
    the host build against hash_rpo's."""
    seed = RPO_SEEDS[1]
    want = [int.from_bytes(hash_rpo.merge_with_int(seed, counter)
                           [8 * j:8 * j + 8], "little") for j in range(4)]
    sd = torch.frombuffer(bytearray(seed), dtype=torch.int64)
    d = kcoin.rpo_draw_digests(sd, torch.tensor([counter]))
    assert [v % (1 << 64) for v in d[:, 0].tolist()] == want
    out = np.zeros(4, dtype=np.uint64)
    lib.h_rpo_draw_digest(np.frombuffer(seed, np.uint64).ctypes.data,
                          counter, out.ctypes.data)
    assert [int(v) for v in out] == want


def _digest_words(candidates):
    """(8,) digest words whose four popped u64s are `candidates`."""
    d = [0] * 8
    for i, u in enumerate(candidates):
        d[7 - 2 * i] = int.from_bytes((u >> 32).to_bytes(4, "little"), "big")
        d[6 - 2 * i] = int.from_bytes((u & 0xFFFFFFFF).to_bytes(4, "little"),
                                      "big")
    return d


@pytest.mark.parametrize("cands", [
    [P - 1, P, (1 << 64) - 1, 0],
    [P, P + 5, 0x7FFFFFFFFFFFFFFF, (1 << 64) - 1],
])
def test_rejection_predicate_boundaries(lib, cands):
    """A digest whose popped u64s sit at the boundaries: u < p accepted,
    u >= p skipped, in the plain version and the host build's lane
    selection alike (the digest in lane 0, every other lane's u64s
    rejected)."""
    want = [u * pow(2 ** 64 % P, P - 2, P) % P for u in cands if u < P]
    d = torch.tensor([_digest_words(cands)], dtype=torch.int64)
    u = kcoin.sha_candidates(d)
    assert [v % (1 << 64) for v in u.tolist()] == cands
    assert kcoin.accepted(u).tolist() == [c < P for c in cands]
    draws = np.zeros(4, dtype=np.uint64)
    words = np.array(_digest_words(cands), dtype=np.uint32)
    got = lib.h_coin_sha_take(words.ctypes.data, 4, draws.ctypes.data)
    assert [int(v) for v in draws[:got]] == want


def test_wrappers_take_the_plain_version_on_the_cpu():
    seed, root = kcoin.seed_tensor(SEEDS[2], "cpu"), kcoin.seed_tensor(
        ROOTS[2], "cpu")
    for wrapper, plain in ((kcoin.coin_sha, kcoin.coin_sha_plain),
                           (kcoin.coin_rpo, kcoin.coin_rpo_plain)):
        got, want = wrapper(seed, root, 3, 4), plain(seed, root, 3, 4)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert kcoin.KERNEL_SHA.launches == kcoin.KERNEL_RPO.launches == 0


@pytest.mark.parametrize("k, N", [(1, 1), (1, 8), (3, 2), (3, 16)])
def test_alpha_powers_match_host_scalars(lib, k, N):
    """The fold's powers of alpha (Fp, or Fq3 from three draws) from the
    plain versions and both host-build steps against host scalars."""
    seed, root = SEEDS[k], ROOTS[N % 5]
    _, draws = host_step(seed, root, k, H)
    want = (plain_step(kcoin.coin_sha_plain, seed, root, k)
            + (host_powers(draws, N),))
    assert plain_step(kcoin.coin_sha_plain, seed, root, k, N) == want
    assert host_build_step(lib.h_coin_sha, seed, root, k, N) == want
    seed, root = RPO_SEEDS[k], RPO_ROOTS[N % 5]
    _, draws = host_step(seed, root, k, hash_rpo)
    want = (plain_step(kcoin.coin_rpo_plain, seed, root, k)
            + (host_powers(draws, N),))
    assert plain_step(kcoin.coin_rpo_plain, seed, root, k, N) == want
    for fn in (lib.h_coin_rpo, lib.h_coin_rpo_lanes):
        assert host_build_step(fn, seed, root, k, N) == want


def test_fq3_alpha_is_three_draws():
    """An Fq3 alpha is the first three draws after the reseed, c0, c1, c2."""
    coin = PublicCoin(SEEDS[3], Fq3, H)
    coin.reseed_with_digest(ROOTS[3])
    a = coin.draw()
    _, draws = plain_step(kcoin.coin_sha_plain, SEEDS[3], ROOTS[3], 3)
    assert draws == [a.c0.v, a.c1.v, a.c2.v]


def _select_rounds(cands, k):
    """The host coin's loop over given candidates (rounds x 32 lanes x 4
    popped u64s, counter order): the first k accepted, as draws."""
    r_inv = pow(2 ** 64 % P, P - 2, P)
    out = [u * r_inv % P for u in np.asarray(cands).reshape(-1).tolist()
           if u < P]
    return out[:k], len(out)


@pytest.mark.parametrize("case", ["one_lane_late", "round_boundary",
                                  "alpha_across_rounds", "all_accepted"])
def test_sha_lane_selection_matches_the_host_loop(lib, case):
    """The warp's ballot places on crafted candidates equal the host coin's
    loop, which takes the popped u64s of counters 1, 2, .. in order and
    skips those >= p: a round whose only accepted u64s sit in its last
    lanes, k past a round's 128 candidates, alpha's three components
    split over two rounds, and every u64 accepted."""
    rng = np.random.default_rng(5)
    rounds = 3
    cands = rng.integers(0, P, size=(rounds, 32, 4), dtype=np.uint64)
    reject = np.uint64((1 << 64) - 1)
    if case == "one_lane_late":
        cands[0, :30] = reject
        cands[0, 31, 1:3] = np.uint64(P)
        k, ka = 5, 3
    elif case == "round_boundary":
        cands[0, ::3, 2] = reject
        cands[1, 5:9] = np.uint64(P + 7)
        k, ka = 200, 1
    elif case == "alpha_across_rounds":
        cands[0] = reject
        cands[0, 17, 3] = np.uint64(P - 1)
        cands[0, 30, 0] = np.uint64(0)
        k, ka = 3, 3
    else:
        k, ka = 128, 3
    want, accepted = _select_rounds(cands, k)
    draws = np.zeros(k, dtype=np.uint64)
    alpha = np.zeros(3, dtype=np.uint64)
    got = lib.h_coin_sha_select(np.ascontiguousarray(cands).ctypes.data,
                                rounds, k, ka, draws.ctypes.data,
                                alpha.ctypes.data)
    # whole rounds until k are accepted
    took = next(r + 1 for r in range(rounds)
                if _select_rounds(cands[:r + 1], k)[1] >= k)
    assert got == _select_rounds(cands[:took], k)[1] and got >= k
    assert [int(v) for v in draws] == want
    assert [int(v) for v in alpha[:ka]] == want[:ka]


@pytest.mark.parametrize("k, N", [(1, 1), (1, 33), (3, 16), (3, 70)])
def test_alpha_powers_by_prefix_product(lib, k, N):
    """Lane j's alpha^j by the prefix product over the lanes, then alpha^32
    a round: an Fp and an Fq3 alpha against host scalars, within one round
    and past it."""
    draws = [int(v) for v in np.random.default_rng(k * 100 + N).integers(
        0, P, size=k, dtype=np.uint64)]
    pw = np.zeros((k, N), dtype=np.uint64)
    lib.h_alpha_powers(np.array(draws + [0] * (3 - k),
                                dtype=np.uint64).ctypes.data, k, N,
                       pw.ctypes.data)
    assert [[int(v) for v in row] for row in pw] == host_powers(draws, N)
