// The schedule of kernel B (csrc/ntt.cu col_ntt_kernel), shared by the
// CUDA kernel (nvcc, sm_90a) and a host driver that runs it one "thread"
// at a time (g++, the CPU tests).
//
// One column of N = 2^L points (positions in bit-reversed load order, DIT
// stage st = b + 1 pairs positions that differ in bit b) is held by
// T = N / R threads of R = 2^RL values each (RL = min(L, NTT_RADIX_LOG)).
// The L stages run in ceil(L / RL) rounds; round i runs the stages of bits
// [a_i, a_i + k_i) in registers, k_i <= RL, the rounds as even as they can
// be (the first ones one stage longer).  In round i a thread holds the R
// positions whose bits [s_i, s_i + RL) vary, s_i = min(a_i, L - RL), and
// whose other bits spell its index f within the column (`ntt_pos`).
// Between rounds the values cross shared memory once: each thread writes
// its R values at their positions, a barrier, each reads the next round's.
//
// Arithmetic is lazy inside the transform: a value is any u64 that is
// congruent to it (as the TPU kernel keeps it), the twiddle product is
// canonical, so one carry or borrow correction keeps the sum and the
// difference in range; values are made canonical at the store.
#pragma once

#include "goldilocks.cuh"

#ifdef __CUDACC__
#define NS_HD __host__ __device__ __forceinline__
#define NS_CX __host__ __device__ constexpr
#else
#define NS_HD static inline
#define NS_CX constexpr
#endif

#define NTT_RADIX_LOG 4   // R = 16 values a thread
#define NTT_MAX_LOG 14    // columns of up to 16384 points
#define NTT_TILE_ELEMS 8192  // column values a block keeps (but L = 14)

// -- the round plan ---------------------------------------------------------

NS_CX int ntt_rl(int L) { return L < NTT_RADIX_LOG ? L : NTT_RADIX_LOG; }

NS_CX int ntt_rounds(int L) {
    return L == 0 ? 0 : (L + NTT_RADIX_LOG - 1) / NTT_RADIX_LOG;
}

// stages in round i
NS_CX int ntt_round_len(int L, int i) {
    return L / ntt_rounds(L) + (i < L % ntt_rounds(L) ? 1 : 0);
}

// first bit (stage - 1) of round i
NS_CX int ntt_round_start(int L, int i) {
    int a = 0;
    for (int j = 0; j < i; j++) a += ntt_round_len(L, j);
    return a;
}

// lowest register bit of round i
NS_CX int ntt_reg_base(int L, int i) {
    return ntt_round_start(L, i) < L - ntt_rl(L) ? ntt_round_start(L, i)
                                                 : L - ntt_rl(L);
}

// -- field helpers (lazy representatives in [0, 2^64)) ----------------------

// a + t for any a and canonical t: a carry out adds back 2^64 mod p, and
// a + t - 2^64 < t, so that cannot carry again
NS_HD uint64_t gl_add_lazy(uint64_t a, uint64_t t) {
    uint64_t s = a + t;
    return s < t ? s + GL_EPS : s;
}

// a - t for any a and canonical t: a borrow adds p = 2^64 - (2^64 mod p),
// and since t < p the result stays non-negative
NS_HD uint64_t gl_sub_lazy(uint64_t a, uint64_t t) {
    uint64_t d = a - t;
    return a < t ? d - GL_EPS : d;
}

// -- index maps ------------------------------------------------------------

NS_HD uint32_t ntt_bitrev(uint32_t i, int bits) {
#ifdef __CUDA_ARCH__
    return bits == 0 ? 0 : (__brev(i) >> (32 - bits));
#else
    uint32_t r = 0;
    for (int k = 0; k < bits; k++) r |= ((i >> k) & 1u) << (bits - 1 - k);
    return r;
#endif
}

// position of register r of thread f when the register bits start at s
NS_HD uint32_t ntt_pos(uint32_t f, uint32_t r, int s, int rl) {
    return (f & ((1u << s) - 1)) | (r << s) | ((f >> s) << (s + rl));
}

// shared-memory slot of (position, column within the block): the low RL
// bits of the position are XORed with the next RL, so that the threads of
// a half-warp, which differ in the low bits of f, hit distinct banks in
// every round (round 0 writes positions R apart)
NS_HD uint32_t ntt_slot(uint32_t pos, uint32_t cc, int tc, int rl) {
    return ((pos ^ ((pos >> rl) & ((1u << rl) - 1))) * tc) + cc;
}

// -- one thread's part of each phase --------------------------------------
// x, pre, tmat, y point at the block's first column; rows are C apart.

// round 0's registers: positions f * R + r, read from row bitrev(position)
// (times pre)
template <int L>
NS_HD void ntt_load(uint64_t* v, const uint64_t* x, const uint64_t* pre,
                    uint32_t f, int64_t C) {
    constexpr int RL = ntt_rl(L);
#pragma unroll
    for (int r = 0; r < (1 << RL); r++) {
        const int64_t src =
            (int64_t)ntt_bitrev(ntt_pos(f, r, 0, RL), L) * C;
        v[r] = pre ? gl_mul_cc(x[src], pre[src]) : x[src];
    }
}

// the last round's registers to rows = positions, canonical (times tmat)
template <int L>
NS_HD void ntt_store(const uint64_t* v, uint64_t* y, const uint64_t* tmat,
                     uint32_t f, int64_t C) {
    constexpr int RL = ntt_rl(L);
    constexpr int S = ntt_reg_base(L, ntt_rounds(L) - 1);
#pragma unroll
    for (int r = 0; r < (1 << RL); r++) {
        const int64_t dst = (int64_t)ntt_pos(f, r, S, RL) * C;
        y[dst] = tmat ? gl_mul_cc(v[r], tmat[dst]) : gl_canon(v[r]);
    }
}

// round I's registers to and from the shared tile
template <int L, int I>
NS_HD void ntt_write(uint64_t* tile, const uint64_t* v, uint32_t f,
                     uint32_t cc, int tc) {
    constexpr int RL = ntt_rl(L);
    constexpr int S = ntt_reg_base(L, I);
#pragma unroll
    for (int r = 0; r < (1 << RL); r++)
        tile[ntt_slot(ntt_pos(f, r, S, RL), cc, tc, RL)] = v[r];
}

template <int L, int I>
NS_HD void ntt_read(const uint64_t* tile, uint64_t* v, uint32_t f,
                    uint32_t cc, int tc) {
    constexpr int RL = ntt_rl(L);
    constexpr int S = ntt_reg_base(L, I);
#pragma unroll
    for (int r = 0; r < (1 << RL); r++)
        v[r] = tile[ntt_slot(ntt_pos(f, r, S, RL), cc, tc, RL)];
}

// Stage T of round I on the registers.  tw(b, j) is w_{2^(b+1)}^j, the
// twiddle of bit b for the pair whose lower position has low bits j < 2^b:
// tw[j << (L - 1 - b)] in the table tw[k] = w^k.  In round 0 the twiddle
// of register pair 0 is w^0 = 1, known here, so it costs no product
// (UNIT; the multi-pass kernel's later passes, whose positions carry low
// bits from outside the pass, clear it).  (The stage is a template of its
// own so that every loop bound below is a constant and the registers stay
// registers.)
template <int L, int I, int T, bool UNIT = true, class Tw>
NS_HD void ntt_stage(uint64_t* v, uint32_t lo, const Tw& tw) {
    constexpr int RL = ntt_rl(L);
    constexpr int S = ntt_reg_base(L, I);
    constexpr int B = ntt_round_start(L, I) + T;  // the stage's bit
    constexpr int Q = B - S;                      // ... in the registers
#pragma unroll
    for (int rr = 0; rr < (1 << Q); rr++) {
        const bool one = UNIT && S == 0 && rr == 0;
        const uint64_t w = one ? 1 : tw(B, lo | ((uint32_t)rr << S));
#pragma unroll
        for (int h = 0; h < (1 << (RL - Q - 1)); h++) {
            const int r0 = (h << (Q + 1)) | rr, r1 = r0 | (1 << Q);
            const uint64_t u = v[r0];
            const uint64_t p = one ? gl_canon(v[r1]) : gl_mul_cc(v[r1], w);
            v[r0] = gl_add_lazy(u, p);
            v[r1] = gl_sub_lazy(u, p);
        }
    }
    if constexpr (T + 1 < ntt_round_len(L, I))
        ntt_stage<L, I, T + 1, UNIT>(v, lo, tw);
}

// Round I's stages on the registers of thread f.
template <int L, int I, bool UNIT = true, class Tw>
NS_HD void ntt_round(uint64_t* v, uint32_t f, const Tw& tw) {
    ntt_stage<L, I, 0, UNIT>(v, f & ((1u << ntt_reg_base(L, I)) - 1), tw);
}
