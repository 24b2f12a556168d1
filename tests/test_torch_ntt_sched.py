"""Kernel B's schedule (csrc/ntt_sched.cuh) on the CPU: the header built
by g++ with a host driver that runs the kernel's phases one "thread" at a
time, the barriers as phase boundaries, against ``col_ntt_plain``.

Every column length kernel B takes, n1 = 2^0 .. 2^14, with and without the
``pre`` and ``tmat`` tables, at two widths of the block's column tile; and
the round plan (which stages each round runs, which position bits its
registers hold).  Inputs are numpy draws from a fixed seed; equality is
exact.  No JAX is imported here.
"""

import ctypes

import numpy as np
import pytest

P = 0xFFFFFFFF00000001
MAX_LOG = 14
RADIX_LOG = 4

_HARNESS = r"""
#include <vector>
#include "ntt_sched.cuh"

struct HostTw {
    const uint64_t* tw;
    int L;
    uint64_t operator()(int b, uint32_t j) const {
        return tw[(uint64_t)j << (L - 1 - b)];
    }
};

// the rounds from I on, for every thread of one block; all threads write
// the tile before any reads it (the kernel's barrier)
template <int L, int I>
static void rounds_from(std::vector<uint64_t>& regs,
                        std::vector<uint64_t>& tile, int threads, int tc,
                        const HostTw& tw) {
    if constexpr (I < ntt_rounds(L)) {
        constexpr int R = 1 << ntt_rl(L);
        if constexpr (I > 0) {
            for (int t = 0; t < threads; t++)
                ntt_write<L, I - 1>(tile.data(), &regs[t * R], t / tc,
                                    t % tc, tc);
            for (int t = 0; t < threads; t++)
                ntt_read<L, I>(tile.data(), &regs[t * R], t / tc, t % tc, tc);
        }
        for (int t = 0; t < threads; t++)
            ntt_round<L, I>(&regs[t * R], t / tc, tw);
        rounds_from<L, I + 1>(regs, tile, threads, tc, tw);
    }
}

template <int L>
static void host_ntt(const uint64_t* x, uint64_t* y, const uint64_t* tw,
                     const uint64_t* pre, const uint64_t* tmat, long B,
                     long C, int tc) {
    constexpr int N = 1 << L, R = 1 << ntt_rl(L);
    const int threads = N / R * tc;
    std::vector<uint64_t> regs((long)threads * R), tile((long)N * tc);
    const HostTw h{tw, L};
    for (long b = 0; b < B; b++)
        for (long c0 = 0; c0 < C; c0 += tc) {
            const long off = b * N * C + c0;
            for (int t = 0; t < threads; t++)
                ntt_load<L>(&regs[t * R], x + off + t % tc,
                            pre ? pre + c0 + t % tc : nullptr, t / tc, C);
            rounds_from<L, 0>(regs, tile, threads, tc, h);
            for (int t = 0; t < threads; t++)
                ntt_store<L>(&regs[t * R], y + off + t % tc,
                             tmat ? tmat + c0 + t % tc : nullptr, t / tc, C);
        }
}

extern "C" int host_col_ntt(const uint64_t* x, uint64_t* y,
                            const uint64_t* tw, const uint64_t* pre,
                            const uint64_t* tmat, long B, long C, long log_n1,
                            long tc) {
    switch (log_n1) {
#define CASE(l) case l: host_ntt<l>(x, y, tw, pre, tmat, B, C, tc); return 0;
        CASE(0) CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7)
        CASE(8) CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14)
#undef CASE
    }
    return 1;
}

// rounds, then (first bit, stages, lowest register bit) of each round
extern "C" void host_plan(long L, long* out) {
    out[0] = ntt_rounds(L);
    for (int i = 0; i < ntt_rounds(L); i++) {
        out[1 + 3 * i] = ntt_round_start(L, i);
        out[2 + 3 * i] = ntt_round_len(L, i);
        out[3 + 3 * i] = ntt_reg_base(L, i);
    }
}

extern "C" long host_max_log() { return NTT_MAX_LOG; }

// The most slots one bank pair takes among 16 consecutive threads (a
// half-warp's 8-byte accesses) when a round's registers meet the tile.
template <int L, int I>
static int worst_bank(int tc) {
    constexpr int RL = ntt_rl(L), S = ntt_reg_base(L, I);
    const int threads = (1 << L) / (1 << RL) * tc;
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
    if constexpr (I + 1 < ntt_rounds(L)) {
        int w = worst_bank<L, I + 1>(tc);
        worst = w > worst ? w : worst;
    }
    return worst;
}

extern "C" int host_bank_worst(long log_n1, long tc) {
    switch (log_n1) {
#define CASE(l) case l: return worst_bank<l, 0>(tc);
        CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10) CASE(11)
        CASE(12) CASE(13) CASE(14)
#undef CASE
    }
    return -1;
}
"""


@pytest.fixture(scope="module")
def lib():
    from ministark_tpu_torch.ops import build

    lib = build.build_host_library("ntt_sched_check", _HARNESS)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.host_col_ntt.restype = ctypes.c_int
    lib.host_col_ntt.argtypes = [u64p] * 5 + [ctypes.c_long] * 4
    lib.host_plan.restype = None
    lib.host_plan.argtypes = [ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
    return lib


def _ptr(a):
    if a is None:
        return None
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _plan(lib, L):
    out = (ctypes.c_long * (1 + 3 * MAX_LOG))()
    lib.host_plan(L, out)
    return [tuple(out[1 + 3 * i: 4 + 3 * i]) for i in range(out[0])]


def test_header_limits_match_the_wrapper(lib):
    from ministark_tpu_torch.ops import ntt as kntt

    lib.host_max_log.restype = ctypes.c_long
    assert kntt.MAX_N1 == 1 << lib.host_max_log() == 1 << MAX_LOG


@pytest.mark.parametrize("log_n1", range(MAX_LOG + 1))
def test_round_plan(lib, log_n1):
    """Rounds of at most four stages, as even as they can be, covering the
    stages once and in order; each round's register bits hold its stages'
    bits and stay inside the column."""
    plan = _plan(lib, log_n1)
    rl = min(log_n1, RADIX_LOG)
    assert len(plan) == -(-log_n1 // RADIX_LOG)
    lens = [k for _a, k, _s in plan]
    assert sum(lens) == log_n1
    if plan:
        assert max(lens) <= rl and max(lens) - min(lens) <= 1
        assert lens == sorted(lens, reverse=True)
    start = 0
    for a, k, s in plan:
        assert a == start and s == min(a, log_n1 - rl)
        assert s <= a and a + k <= s + rl <= log_n1
        start += k
    expected = {12: [(0, 4, 0), (4, 4, 4), (8, 4, 8)],
                13: [(0, 4, 0), (4, 3, 4), (7, 3, 7), (10, 3, 9)],
                11: [(0, 4, 0), (4, 4, 4), (8, 3, 7)],
                7: [(0, 4, 0), (4, 3, 3)], 4: [(0, 4, 0)], 2: [(0, 2, 0)],
                0: []}
    if log_n1 in expected:
        assert plan == expected[log_n1]


@pytest.mark.parametrize("tables", ["none", "pre", "tmat", "pre+tmat"])
@pytest.mark.parametrize("log_n1", range(MAX_LOG + 1))
def test_schedule_matches_plain(lib, log_n1, tables):
    """The host driver equals col_ntt_plain exactly, for a one-column tile
    and the widest tile C allows (up to 4 columns), two batches."""
    from ministark_tpu_torch.fields import device as fd
    from ministark_tpu_torch.fields.convert import from_u64_numpy
    from ministark_tpu_torch.fields.scalar import get_root_of_unity
    from ministark_tpu_torch.ops import ntt as kntt

    n1 = 1 << log_n1
    B, C = 2, (4 if log_n1 <= 11 else 2)
    rng = np.random.default_rng(1000 + 4 * log_n1 + len(tables))
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
                              as_t(tmat))
    want = want.numpy().view(np.uint64)
    for tc in sorted({1, C}):
        y = np.zeros_like(x)
        assert lib.host_col_ntt(_ptr(x), _ptr(y), _ptr(tw), _ptr(pre),
                                _ptr(tmat), B, C, log_n1, tc) == 0
        np.testing.assert_array_equal(y, want, err_msg=f"tc={tc}")


@pytest.mark.parametrize("log_n1", range(5, MAX_LOG + 1))
def test_exchange_slots_avoid_bank_conflicts(lib, log_n1):
    """Every column length that exchanges through the tile (two rounds or
    more), at each tile width the kernel may take: the 16 threads of a
    half-warp touch 16 distinct bank pairs whenever a round writes or reads
    the tile (so no access waits on another)."""
    lib.host_bank_worst.restype = ctypes.c_int
    for tc in (1, 2, 4, 8, 16):
        if tc << log_n1 <= 8192 or tc == 1:
            assert lib.host_bank_worst(log_n1, tc) == 1, tc
