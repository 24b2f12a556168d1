// The schedule of the multi-pass column NTT (csrc/ntt.cu
// col_ntt_pass_kernel), shared by the CUDA kernel (nvcc, sm_90a) and a host
// driver that runs it one "thread" at a time (g++, the CPU tests).
//
// A column of 2^L points (positions in bit-reversed load order, as in
// ntt_sched.cuh: DIT stage b + 1 pairs positions that differ in bit b)
// runs its L stages in ceil(L / NTT_PASS_MAX_LOG) passes over device
// memory, each of K <= NTT_PASS_MAX_LOG consecutive stages, the passes as
// even as they can be (the first ones one stage longer).  Pass p runs the
// stages of bits [a, a + K).  A block of the pass owns one group g of
// 2^(L - K): the 2^K positions whose bits [a, a + K) vary and whose other
// bits spell g (`ntt_pass_pos`), for tc adjacent columns.  It runs those K
// stages as one 2^K-point column of kernel B's schedule (ntt_sched.cuh:
// R = 16 values a thread, four stages a round in registers, one swizzled
// exchange through shared memory between rounds), with the twiddles of
// the group's positions staged in shared memory.
//
// The first pass gathers its rows bit-reversed from x (times pre): for
// a = 0 the group's position g * 2^K + t reads row bitrev_L of it,
// bitrev_K(t) * 2^(L - K) + bitrev_{L-K}(g), a strided read of whole row
// segments.  Every pass writes its positions in place in y, the last one
// canonical (times tmat); the others leave lazy values (any u64 congruent
// to the value), which the next pass's lazy butterflies take as they are.
#pragma once

#include "ntt_sched.cuh"

#define NTT_PASS_MAX_LOG 8   // stages a pass at most
#define NTT_PASS_TILE 4096   // values a block at most: 32 KB of exchange
#define NTT_PASS_TC 32       // columns a block at most

// -- the pass plan -----------------------------------------------------------

NS_CX int ntt_passes(int L) {
    return L == 0 ? 1 : (L + NTT_PASS_MAX_LOG - 1) / NTT_PASS_MAX_LOG;
}

// stages in pass p
NS_CX int ntt_pass_len(int L, int p) {
    return L / ntt_passes(L) + (p < L % ntt_passes(L) ? 1 : 0);
}

// first bit (stage - 1) of pass p
NS_CX int ntt_pass_start(int L, int p) {
    int a = 0;
    for (int j = 0; j < p; j++) a += ntt_pass_len(L, j);
    return a;
}

// the widest column tile of a K-stage pass (a power of two)
NS_CX int ntt_pass_tc_max(int K) {
    return (NTT_PASS_TILE >> K) < NTT_PASS_TC ? (NTT_PASS_TILE >> K)
                                              : NTT_PASS_TC;
}

// -- index maps ------------------------------------------------------------

// position of the pass's sub-position t (K bits) in group g: t at bits
// [a, a + K), g's low a bits below it and its other bits above
NS_HD uint32_t ntt_pass_pos(uint32_t t, int K, int a, uint32_t g) {
    return ((g >> a) << (a + K)) | (t << a) | (g & ((1u << a) - 1));
}

// the group's twiddle heap: slot (1 << b) + j holds the twiddle of the
// pass's bit b for sub-positions whose low bits are j < 2^b, that is
// tw[((j << a) | lo) << (L - 1 - a - b)] with lo = g's low a bits; slot 0
// is unused.  Slots e = first .. 2^K - 1 in steps of `step` (a block's
// threads share the fill).
NS_HD void ntt_pass_heap(uint64_t* heap, const uint64_t* tw, int K, int L,
                         int a, uint32_t g, int first, int step) {
    const uint32_t lo = g & ((1u << a) - 1);
    for (int e = first; e < (1 << K); e += step) {
        int b = 0;
        while ((2 << b) <= e) b++;
        const uint32_t j = (uint32_t)e - (1u << b);
        heap[e] = tw[((j << a) | lo) << (L - 1 - a - b)];
    }
}

// tw(b, j) of ntt_stage: the heap
struct PassTw {
    const uint64_t* heap;
    GL_FN uint64_t operator()(int b, uint32_t j) const {
        return heap[(1u << b) + j];
    }
};

// -- one thread's part of each phase --------------------------------------
// x, pre, tmat, y point at the block's first column of its batch; rows are
// C apart.  Thread f of the column holds round 0's registers, positions
// ntt_pos(f, r, 0, RL) of the pass.

// the first pass: rows bitrev_L(position) of x (times pre)
template <int K>
NS_HD void ntt_pass_gather(uint64_t* v, const uint64_t* x, const uint64_t* pre,
                           uint32_t f, int64_t C, int L, uint32_t g) {
    constexpr int RL = ntt_rl(K);
#pragma unroll
    for (int r = 0; r < (1 << RL); r++) {
        const uint32_t pos = ntt_pass_pos(ntt_pos(f, r, 0, RL), K, 0, g);
        const int64_t src = (int64_t)ntt_bitrev(pos, L) * C;
        v[r] = pre ? gl_mul_cc(x[src], pre[src]) : x[src];
    }
}

// a later pass: its positions of y
template <int K>
NS_HD void ntt_pass_load(uint64_t* v, const uint64_t* y, uint32_t f,
                         int64_t C, int a, uint32_t g) {
    constexpr int RL = ntt_rl(K);
#pragma unroll
    for (int r = 0; r < (1 << RL); r++)
        v[r] = y[(int64_t)ntt_pass_pos(ntt_pos(f, r, 0, RL), K, a, g) * C];
}

// the last round's registers to their positions of y: canonical (times
// tmat) after the last pass, as they are after the others
template <int K>
NS_HD void ntt_pass_store(const uint64_t* v, uint64_t* y,
                          const uint64_t* tmat, bool last, uint32_t f,
                          int64_t C, int a, uint32_t g) {
    constexpr int RL = ntt_rl(K);
    constexpr int S = K == 0 ? 0 : ntt_reg_base(K, ntt_rounds(K) - 1);
#pragma unroll
    for (int r = 0; r < (1 << RL); r++) {
        const int64_t dst =
            (int64_t)ntt_pass_pos(ntt_pos(f, r, S, RL), K, a, g) * C;
        y[dst] = !last ? v[r]
                 : tmat ? gl_mul_cc(v[r], tmat[dst]) : gl_canon(v[r]);
    }
}
