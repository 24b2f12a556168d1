"""The multi-pass column NTT's schedule (csrc/ntt_pass.cuh) on the CPU: the
header built by g++ with a host driver that runs each pass one block and
one "thread" at a time, the barriers as phase boundaries, against
``col_ntt_plain``.

Every column length n1 = 2^0 .. 2^16 on a few narrow columns, with and
without the ``pre`` and ``tmat`` tables, at a one-column tile and the
widest tile C allows; the pass plan (which stages each pass runs); and the
exchange slots of every pass length and tile width the kernel takes.
Inputs are numpy draws from a fixed seed; equality is exact.  No JAX is
imported here.
"""

import ctypes

import numpy as np
import pytest

P = 0xFFFFFFFF00000001
MAX_LOG = 16          # the longest column checked here
PASS_MAX_LOG = 8

_HARNESS = r"""
#include <vector>
#include "ntt_pass.cuh"

// the rounds from I on, for every thread of one block; all threads write
// the tile before any reads it (the kernel's barrier)
template <int K, int I, bool UNIT>
static void rounds_from(std::vector<uint64_t>& regs,
                        std::vector<uint64_t>& tile, int threads, int tc,
                        const PassTw& tw) {
    if constexpr (I < ntt_rounds(K)) {
        constexpr int R = 1 << ntt_rl(K);
        if constexpr (I > 0) {
            for (int t = 0; t < threads; t++)
                ntt_write<K, I - 1>(tile.data(), &regs[t * R], t / tc,
                                    t % tc, tc);
            for (int t = 0; t < threads; t++)
                ntt_read<K, I>(tile.data(), &regs[t * R], t / tc, t % tc, tc);
        }
        for (int t = 0; t < threads; t++)
            ntt_round<K, I, UNIT>(&regs[t * R], t / tc, tw);
        rounds_from<K, I + 1, UNIT>(regs, tile, threads, tc, tw);
    }
}

// one pass over every block: (batch, group, column tile)
template <int K, bool FIRST>
static void host_pass(const uint64_t* x, uint64_t* y, const uint64_t* tw,
                      const uint64_t* pre, const uint64_t* tmat, long B,
                      long C, int L, int a, bool last, int tc) {
    constexpr int R = 1 << ntt_rl(K);
    const int threads = (1 << K) / R * tc;
    std::vector<uint64_t> regs((long)threads * R), tile((1L << K) * tc),
        heap(1L << K);
    for (long b = 0; b < B; b++)
        for (uint32_t g = 0; g < (1u << (L - K)); g++)
            for (long c0 = 0; c0 < C; c0 += tc) {
                const long off = (b << L) * C + c0;
                for (int t = 0; t < threads; t++) {
                    const int cc = t % tc;
                    if (FIRST)
                        ntt_pass_gather<K>(&regs[t * R], x + off + cc,
                                           pre ? pre + c0 + cc : nullptr,
                                           t / tc, C, L, g);
                    else
                        ntt_pass_load<K>(&regs[t * R], y + off + cc, t / tc,
                                         C, a, g);
                }
                if constexpr (K > 0) {
                    ntt_pass_heap(heap.data(), tw, K, L, a, g, 1, 1);
                    rounds_from<K, 0, FIRST>(regs, tile, threads, tc,
                                             PassTw{heap.data()});
                }
                for (int t = 0; t < threads; t++)
                    ntt_pass_store<K>(&regs[t * R], y + off + t % tc,
                                      tmat ? tmat + c0 + t % tc : nullptr,
                                      last, t / tc, C, a, g);
            }
}

// every pass, as ms_col_ntt_pass launches them; the tile is the widest
// power of two dividing C, at most tc_cap and the kernel's limit
extern "C" int host_col_ntt_passes(const uint64_t* x, uint64_t* y,
                                   const uint64_t* tw, const uint64_t* pre,
                                   const uint64_t* tmat, long B, long C,
                                   long log_n1, long tc_cap) {
    const int L = (int)log_n1;
    for (int p = 0; p < ntt_passes(L); p++) {
        const int K = ntt_pass_len(L, p), a = ntt_pass_start(L, p);
        const bool last = p == ntt_passes(L) - 1;
        int tc = 1;
        while (2 * tc <= tc_cap && 2 * tc <= ntt_pass_tc_max(K) &&
               C % (2 * tc) == 0)
            tc *= 2;
        switch (K * 2 + (p == 0)) {
#define CASE(k)                                                              \
    case 2 * k + 1:                                                          \
        host_pass<k, true>(x, y, tw, pre, tmat, B, C, L, a, last, tc);      \
        break;                                                               \
    case 2 * k:                                                              \
        host_pass<k, false>(x, y, tw, pre, tmat, B, C, L, a, last, tc);     \
        break;
            CASE(0) CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7)
            CASE(8)
#undef CASE
            default: return 1;
        }
    }
    return 0;
}

// passes, then (first bit, stages) of each pass
extern "C" void host_pass_plan(long L, long* out) {
    out[0] = ntt_passes(L);
    for (int p = 0; p < ntt_passes(L); p++) {
        out[1 + 2 * p] = ntt_pass_start(L, p);
        out[2 + 2 * p] = ntt_pass_len(L, p);
    }
}

extern "C" long host_pass_max_log() { return NTT_PASS_MAX_LOG; }
extern "C" long host_pass_tc_max(long K) { return ntt_pass_tc_max(K); }

// The most slots one bank pair takes among 16 consecutive threads (a
// half-warp's 8-byte accesses) when a round of a K-stage pass meets the
// tile.
template <int K, int I>
static int worst_bank(int tc) {
    constexpr int RL = ntt_rl(K), S = ntt_reg_base(K, I);
    const int threads = (1 << K) / (1 << RL) * tc;
    int worst = 0;
    for (int r = 0; r < (1 << RL); r++)
        for (int t0 = 0; t0 < threads; t0 += 16) {
            int count[16] = {0};
            for (int t = t0; t < t0 + 16 && t < threads; t++) {
                uint32_t slot = ntt_slot(ntt_pos(t / tc, r, S, RL), t % tc,
                                         tc, RL);
                int c = ++count[slot % 16];
                worst = c > worst ? c : worst;
            }
        }
    if constexpr (I + 1 < ntt_rounds(K)) {
        int w = worst_bank<K, I + 1>(tc);
        worst = w > worst ? w : worst;
    }
    return worst;
}

extern "C" int host_bank_worst(long K, long tc) {
    switch (K) {
#define CASE(k) case k: return worst_bank<k, 0>(tc);
        CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    }
    return -1;
}
"""


@pytest.fixture(scope="module")
def lib():
    from ministark_tpu_torch.ops import build

    lib = build.build_host_library("ntt_pass_check", _HARNESS)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.host_col_ntt_passes.restype = ctypes.c_int
    lib.host_col_ntt_passes.argtypes = [u64p] * 5 + [ctypes.c_long] * 4
    lib.host_pass_plan.restype = None
    lib.host_pass_plan.argtypes = [ctypes.c_long,
                                   ctypes.POINTER(ctypes.c_long)]
    for fn in ("host_pass_max_log", "host_pass_tc_max"):
        getattr(lib, fn).restype = ctypes.c_long
    lib.host_bank_worst.restype = ctypes.c_int
    return lib


def _ptr(a):
    if a is None:
        return None
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _plan(lib, L):
    out = (ctypes.c_long * 8)()
    lib.host_pass_plan(L, out)
    return [tuple(out[1 + 2 * p: 3 + 2 * p]) for p in range(out[0])]


@pytest.mark.parametrize("log_n1", range(MAX_LOG + 1))
def test_pass_plan(lib, log_n1):
    """Passes of at most eight stages, as even as they can be, covering
    the stages once and in order, as many as the wrapper launches: two up
    to 2^16 rows."""
    from ministark_tpu_torch.ops import ntt as kntt

    assert kntt.PASS_MAX_LOG == lib.host_pass_max_log() == PASS_MAX_LOG
    plan = _plan(lib, log_n1)
    assert len(plan) == kntt.num_passes(log_n1) == max(
        1, -(-log_n1 // PASS_MAX_LOG))
    lens = [k for _a, k in plan]
    assert sum(lens) == log_n1 and max(lens) <= PASS_MAX_LOG
    assert max(lens) - min(lens) <= 1 and lens == sorted(lens, reverse=True)
    assert [a for a, _k in plan] == [sum(lens[:p]) for p in range(len(plan))]
    expected = {16: [(0, 8), (8, 8)], 15: [(0, 8), (8, 7)],
                12: [(0, 6), (6, 6)], 9: [(0, 5), (5, 4)], 8: [(0, 8)],
                1: [(0, 1)], 0: [(0, 0)]}
    if log_n1 in expected:
        assert plan == expected[log_n1]


@pytest.mark.parametrize("tables", ["none", "pre", "tmat", "pre+tmat"])
@pytest.mark.parametrize("log_n1", range(MAX_LOG + 1))
def test_passes_match_plain(lib, log_n1, tables):
    """The host driver equals col_ntt_plain exactly, for a one-column tile
    and the widest tile C allows, two batches of narrow columns."""
    from ministark_tpu_torch.fields import device as fd
    from ministark_tpu_torch.fields.convert import from_u64_numpy
    from ministark_tpu_torch.fields.scalar import get_root_of_unity
    from ministark_tpu_torch.ops import ntt as kntt

    n1 = 1 << log_n1
    B, C = (2, 4) if log_n1 <= 12 else (1, 2)
    rng = np.random.default_rng(2000 + 4 * log_n1 + len(tables))
    x = rng.integers(0, P, size=(B, n1, C), dtype=np.uint64)
    pre = (rng.integers(0, P, size=(n1, C), dtype=np.uint64)
           if "pre" in tables else None)
    tmat = (rng.integers(0, P, size=(n1, C), dtype=np.uint64)
            if "tmat" in tables else None)
    root = get_root_of_unity(n1).v if n1 > 1 else 1
    tw_t = fd.powers(root, max(n1 // 2, 1), "cpu")
    tw = tw_t.numpy().view(np.uint64).copy()

    def as_t(a):
        return None if a is None else from_u64_numpy(a)

    want = kntt.col_ntt_plain(as_t(x), tw_t[: n1 // 2], as_t(pre),
                              as_t(tmat)).numpy().view(np.uint64)
    for tc in sorted({1, C}):
        y = np.zeros_like(x)
        assert lib.host_col_ntt_passes(_ptr(x), _ptr(y), _ptr(tw), _ptr(pre),
                                       _ptr(tmat), B, C, log_n1, tc) == 0
        np.testing.assert_array_equal(y, want, err_msg=f"tc={tc}")


@pytest.mark.parametrize("K", range(5, PASS_MAX_LOG + 1))
def test_exchange_slots_avoid_bank_conflicts(lib, K):
    """Every pass length that exchanges through the tile (two rounds), at
    each tile width the kernel may take: the 16 threads of a half-warp
    touch 16 distinct bank pairs whenever a round writes or reads the
    tile."""
    tc = 1
    while tc <= lib.host_pass_tc_max(K):
        assert lib.host_bank_worst(K, tc) == 1, tc
        tc *= 2
