"""Kernel G's small-batch schedule (csrc/rpo256_lanes.cuh) on the CPU: the
header built by g++ with a host driver that runs every lane of a group as
a thread and emulates the exchange the card does with ``__shfl_sync``
(each lane's values through shared slots between two barriers), and a
block's barrier as a barrier of all its threads.

Both group layouts (E = 1 element a lane, 12 of 16 lanes; E = 3, 4
lanes): the permutation against ``hash_rpo``'s, row digests (one to three
absorbs) against ``hash_rpo.hash_elements``, the grind's leading zeros
against ``hash.leading_zeros`` of ``hash_rpo.merge_with_int``, and trees
built by the tops step (one element a lane) against ``merge_plain`` level
by level, with the wrappers' constants.  Equality is exact.  No JAX is imported here.
"""

import ctypes

import numpy as np
import pytest

P = 0xFFFFFFFF00000001
LAYOUTS = [1, 3]

_HARNESS = r"""
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>
#include "rpo256_lanes.cuh"

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

// a group's exchange: lane l's value e in slot l * E + e, which is the
// element's index, between two barriers (no lane writes its slot again
// before every lane has read)
template <int E>
struct HostEx {
    Barrier* bar;
    uint64_t* slots;
    int lane;
    void operator()(const uint64_t* v, uint64_t* s) const {
        for (int e = 0; e < E; e++) slots[lane * E + e] = v[e];
        bar->wait();
        for (int k = 0; k < RPO_WIDTH; k++) s[k] = slots[k];
        bar->wait();
    }
};

struct HostSync {
    Barrier* bar;
    void operator()() const { bar->wait(); }
};

static const uint64_t* RC = &rpo_rc_host[0][0][0];

// fn(ln, ex) on every lane of one group, each lane a thread
template <int E, class Fn>
static void run_group(Fn fn) {
    constexpr int G = rpo_group_lanes<E>();
    Barrier bar(G);
    std::vector<uint64_t> slots(G * E);
    std::vector<std::thread> lanes;
    for (int l = 0; l < G; l++)
        lanes.emplace_back([&, l] {
            const RpoLane<E> ln(l, RC);
            fn(ln, HostEx<E>{&bar, slots.data(), l});
        });
    for (auto& t : lanes) t.join();
}

template <int E>
static void permute(uint64_t* st, long n) {
    for (long i = 0; i < n; i++) {
        uint64_t* s = st + RPO_WIDTH * i;
        run_group<E>([&](const RpoLane<E>& ln, HostEx<E> ex) {
            uint64_t v[E];
            for (int e = 0; e < E; e++)
                v[e] = ln.elem(e) < RPO_WIDTH ? s[ln.elem(e)] : 0;
            rpo_permute_lanes<E>(ln, v, ex, gl_mul_cc_fn());
            for (int e = 0; e < E; e++)
                if (ln.elem(e) < RPO_WIDTH) s[ln.elem(e)] = v[e];
        });
    }
}

template <int E>
static void hash_rows(const uint64_t* x, long n, long ncols, long rs,
                      long cs, uint64_t* out) {
    for (long i = 0; i < n; i++)
        run_group<E>([&](const RpoLane<E>& ln, HostEx<E> ex) {
            uint64_t v[E];
            rpo_lanes_hash_row<E>(ln, v, x + i * rs, ncols, cs, ex,
                                  gl_mul_cc_fn());
            rpo_lanes_store_digest<E>(ln, v, out + i * RPO_DIGEST);
        });
}

template <int E>
static void grind_lz(const uint64_t* seed, uint64_t start, long n, int* lz) {
    for (long i = 0; i < n; i++)
        run_group<E>([&](const RpoLane<E>& ln, HostEx<E> ex) {
            uint64_t v[E], s[RPO_WIDTH];
            rpo_lanes_load_grind<E>(ln, v, seed, start + (uint64_t)i);
            rpo_permute_lanes<E>(ln, v, ex, gl_mul_cc_fn());
            ex(v, s);
            if (ln.lane == 0) lz[i] = rpo_leading_zeros(s + RPO_CAPACITY);
        });
}

// one block as ms_rpo_tree_tops launches it: a group for each node of the
// first level, one element a lane, whole warps, the block's barrier
// between levels
static void tree_tops(const uint64_t* in, uint64_t* out, long m) {
    constexpr int E = 1;
    constexpr int G = rpo_group_lanes<E>();
    const int threads = (int)((m / 2 * G + 31) / 32 * 32);
    const int groups = threads / G;
    Barrier block(threads);
    std::vector<Barrier*> bars;
    for (int g = 0; g < groups; g++) bars.push_back(new Barrier(G));
    std::vector<uint64_t> slots((size_t)groups * G * E);
    std::vector<std::thread> th;
    for (int t = 0; t < threads; t++)
        th.emplace_back([&, t] {
            const int g = t / G, l = t % G;
            const RpoLane<E> ln(l, RC);
            rpo_lanes_tree_tops<E>(
                ln, in, out, m, g, (t / 32) * (32 / G),
                HostEx<E>{bars[g], slots.data() + (size_t)g * G * E, l},
                HostSync{&block}, gl_mul_cc_fn());
        });
    for (auto& t : th) t.join();
    for (auto* b : bars) delete b;
}

#define BY_E(call1, call3) \
    if (E == 1) { call1; return 0; } \
    if (E == 3) { call3; return 0; } \
    return 1;

extern "C" int h_permute(long E, uint64_t* st, long n) {
    BY_E(permute<1>(st, n), permute<3>(st, n))
}
extern "C" int h_hash_rows(long E, const uint64_t* x, long n, long ncols,
                           long rs, long cs, uint64_t* out) {
    BY_E(hash_rows<1>(x, n, ncols, rs, cs, out),
         hash_rows<3>(x, n, ncols, rs, cs, out))
}
extern "C" int h_grind_lz(long E, const uint64_t* seed, uint64_t start,
                          long n, int* lz) {
    BY_E(grind_lz<1>(seed, start, n, lz), grind_lz<3>(seed, start, n, lz))
}
extern "C" void h_tree_tops(const uint64_t* in, uint64_t* out, long m) {
    tree_tops(in, out, m);
}
extern "C" long h_group_lanes(long E) {
    return E == 1 ? rpo_group_lanes<1>() : rpo_group_lanes<3>();
}
"""

U64P = ctypes.POINTER(ctypes.c_uint64)


@pytest.fixture(scope="module")
def lib():
    from ministark_tpu_torch.ops import build

    lib = build.build_host_library("rpo256_lanes_check", _HARNESS)
    L = ctypes.c_long
    lib.h_permute.argtypes = [L, U64P, L]
    lib.h_hash_rows.argtypes = [L, U64P, L, L, L, L, U64P]
    lib.h_grind_lz.argtypes = [L, U64P, ctypes.c_uint64, L,
                               ctypes.POINTER(ctypes.c_int)]
    lib.h_tree_tops.argtypes = [U64P, U64P, L]
    lib.h_tree_tops.restype = None
    lib.h_group_lanes.restype = L
    return lib


def _p(a):
    return a.ctypes.data_as(U64P)


def _states(seed, n):
    """n numpy-seeded states and the boundary states 0, 1, p - 1,
    2^32 - 1 and 2^32 + 1 in every element: (n + 5, 12) uint64."""
    rng = np.random.default_rng(seed)
    st = rng.integers(0, P, (n, 12), dtype=np.uint64)
    edge = np.array([0, 1, P - 1, (1 << 32) - 1, (1 << 32) + 1], np.uint64)
    return np.concatenate([st, np.repeat(edge[:, None], 12, axis=1)])


@pytest.mark.parametrize("E", LAYOUTS)
def test_group_layout_matches_the_wrappers(lib, E):
    from ministark_tpu_torch.ops import rpo256 as krpo

    assert {krpo.lane_elems(0), krpo.lane_elems(1 << 30)} == set(LAYOUTS)
    assert lib.h_group_lanes(E) * E >= 12
    assert krpo.TOPS_LEAVES // 2 * lib.h_group_lanes(1) <= 512


@pytest.mark.parametrize("E", LAYOUTS)
def test_permutation_matches_hash_rpo(lib, E):
    from ministark_tpu_torch import hash_rpo

    st = _states(40 + E, 8)
    want = [hash_rpo._permute([int(v) for v in row]) for row in st]
    assert lib.h_permute(E, _p(st), st.shape[0]) == 0
    assert st.tolist() == want


@pytest.mark.parametrize("E", LAYOUTS)
@pytest.mark.parametrize("ncols", [1, 8, 9, 17])
def test_row_digests_match_hash_elements(lib, E, ncols):
    """Column-major rows read through strides, as the kernel reads the
    trace; 1, 9 and 17 columns pad."""
    from ministark_tpu_torch import hash_rpo
    from ministark_tpu_torch.fields.scalar import Fp

    n = 3
    m = np.random.default_rng(50 + ncols + E).integers(0, P, (ncols, n),
                                                       dtype=np.uint64)
    out = np.zeros((n, 4), np.uint64)
    assert lib.h_hash_rows(E, _p(m), n, ncols, 1, n, _p(out)) == 0
    for i in range(n):
        want = hash_rpo.hash_elements([Fp(int(v)) for v in m[:, i]])
        assert out[i].tobytes() == want, i


@pytest.mark.parametrize("E", LAYOUTS)
def test_grind_leading_zeros_match_host_coin(lib, E):
    from ministark_tpu_torch import hash as H
    from ministark_tpu_torch import hash_rpo

    seed = bytes(range(32))
    start, n = (1 << 32) - 3, 6
    lz = (ctypes.c_int * n)()
    sd = np.frombuffer(seed, dtype=np.uint64).copy()
    assert lib.h_grind_lz(E, _p(sd), start, n, lz) == 0
    want = [H.leading_zeros(hash_rpo.merge_with_int(seed, start + i))
            for i in range(n)]
    assert list(lz) == want


@pytest.mark.parametrize("m", [2, 8, 64])
def test_tree_tops_match_merge_plain(lib, m):
    """Every level above m leaf digests, written one after the other by
    the tops step with one element a lane (the only layout the kernel
    takes for it), equals merge_plain of the two halves of the level
    below."""
    import torch

    from ministark_tpu_torch.ops import rpo256 as krpo

    leaves = np.random.default_rng(60 + m).integers(0, P, (m, 4),
                                                    dtype=np.uint64)
    out = np.zeros((m - 1, 4), np.uint64)
    lib.h_tree_tops(_p(leaves), _p(out), m)
    # level h against merge_plain of the halves of the level below it as
    # the tops step wrote it (the leaves for the first), all levels in one
    # merge_plain call
    levels = [leaves] + [out[m - 2 * h:m - h] for h in _halves(m)]
    left = np.concatenate([lv[:lv.shape[0] // 2] for lv in levels[:-1]])
    right = np.concatenate([lv[lv.shape[0] // 2:] for lv in levels[:-1]])
    want = krpo.merge_plain(torch.from_numpy(left.view(np.uint8).copy()),
                            torch.from_numpy(right.view(np.uint8).copy()))
    np.testing.assert_array_equal(out.view(np.uint8), want.numpy())


def _halves(m):
    """Node counts of the levels above m leaves: m/2, m/4, .., 1."""
    return [m >> k for k in range(1, m.bit_length())]


def test_tree_levels_merge_every_level_on_the_cpu():
    """On the CPU merkle.tree_levels merges each level through merge_plain,
    the tops launch being the card's, in the layout the tops launch
    writes: level h holds the merges of the two halves of the level
    below."""
    import torch

    from ministark_tpu_torch import hash_rpo, merkle
    from ministark_tpu_torch.ops import rpo256 as krpo

    leaves = torch.from_numpy(np.random.default_rng(7).integers(
        0, P, (8, 4), dtype=np.uint64).view(np.uint8).copy())
    levels = merkle.tree_levels(leaves, hash_rpo)
    assert [lv.shape[0] for lv in levels] == [8, 4, 2, 1]
    assert 8 <= krpo.TOPS_LEAVES
    for lvl in range(1, 4):
        below, h = levels[lvl - 1].numpy(), levels[lvl].shape[0]
        for i in range(h):
            want = hash_rpo.merge(below[i].tobytes(), below[i + h].tobytes())
            assert levels[lvl][i].numpy().tobytes() == want, (lvl, i)
    assert krpo.KERNEL_TREE.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        krpo.tree_tops(leaves)
