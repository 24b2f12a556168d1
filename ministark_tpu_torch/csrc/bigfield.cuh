// Big prime fields (the 128-bit STARK-Anatomy prime, the 252-bit StarkWare
// prime) as L u64 Montgomery limbs: the per-element arithmetic and the
// radix-2 butterfly, shared by the CUDA kernels (csrc/bigfield.cu, nvcc,
// sm_90a) and by host C++ (g++, the CPU tests).  Templated on L, the
// number of 64-bit limbs (2 for Fp128, 4 for Fp252).
//
// Values are in Montgomery form v * R mod p with R = 2^(64 L), below p,
// limb k holding bits 64k .. 64k + 63.  The product is CIOS (Koc, Acar
// and Kaliski's coarsely integrated operand scanning) over u64 words: a
// 64 x 64 -> 128-bit product is __umul64hi and a plain multiply on the
// card, unsigned __int128 on the host.  The running sum t has L + 2
// words; after the last reduction step t < 2p, which for a p above R/2
// (Fp128: 2p > 2^128) can carry into word L, so the final conditional
// subtraction takes that overflow word into account.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define BIG_HD __host__ __device__ __forceinline__
#else
#define BIG_HD static inline
#endif

// the modulus' limbs and n0inv = -p^-1 mod 2^64
template <int L>
struct BigMod {
    uint64_t p[L];
    uint64_t n0inv;
};

// (hi, lo) = a * b
BIG_HD void big_mul_wide(uint64_t a, uint64_t b, uint64_t& lo,
                         uint64_t& hi) {
#ifdef __CUDA_ARCH__
    lo = a * b;
    hi = __umul64hi(a, b);
#else
    const unsigned __int128 p = (unsigned __int128)a * b;
    lo = (uint64_t)p;
    hi = (uint64_t)(p >> 64);
#endif
}

// (carry, t) = t + a * b + carry: the sum is below 2^128
BIG_HD void big_mac(uint64_t& t, uint64_t a, uint64_t b, uint64_t& carry) {
    uint64_t lo, hi;
    big_mul_wide(a, b, lo, hi);
    lo += t;
    hi += lo < t;
    lo += carry;
    hi += lo < carry;
    t = lo;
    carry = hi;
}

// (carry, t) = t + carry
BIG_HD void big_add_carry(uint64_t& t, uint64_t& carry) {
    t += carry;
    carry = t < carry;
}

// out = t - p if (overflow, t) >= p, else t; t below 2p
template <int L>
BIG_HD void big_cond_sub(const uint64_t* t, uint64_t overflow,
                         const BigMod<L>& m, uint64_t* out) {
    uint64_t d[L], borrow = 0;
#pragma unroll
    for (int j = 0; j < L; j++) {
        const uint64_t s = t[j] - m.p[j];
        const uint64_t b1 = t[j] < m.p[j];
        d[j] = s - borrow;
        borrow = b1 | (s < borrow);
    }
    const bool use_d = overflow != 0 || borrow == 0;
#pragma unroll
    for (int j = 0; j < L; j++) out[j] = use_d ? d[j] : t[j];
}

// out = a * b * R^-1 mod p (CIOS); a, b below p; out may alias a or b
template <int L>
BIG_HD void big_mont_mul(const uint64_t* a, const uint64_t* b,
                         const BigMod<L>& m, uint64_t* out) {
    uint64_t t[L + 2];
#pragma unroll
    for (int j = 0; j < L + 2; j++) t[j] = 0;
#pragma unroll
    for (int i = 0; i < L; i++) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < L; j++) big_mac(t[j], a[j], b[i], c);
        big_add_carry(t[L], c);
        t[L + 1] = c;
        const uint64_t q = t[0] * m.n0inv;
        c = 0;
        uint64_t t0 = t[0];
        big_mac(t0, q, m.p[0], c);  // low word becomes 0
#pragma unroll
        for (int j = 1; j < L; j++) {
            big_mac(t[j], q, m.p[j], c);
            t[j - 1] = t[j];
        }
        big_add_carry(t[L], c);
        t[L - 1] = t[L];
        t[L] = t[L + 1] + c;
        t[L + 1] = 0;
    }
    big_cond_sub<L>(t, t[L], m, out);
}

// out = a + b mod p
template <int L>
BIG_HD void big_add(const uint64_t* a, const uint64_t* b, const BigMod<L>& m,
                    uint64_t* out) {
    uint64_t t[L], c = 0;
#pragma unroll
    for (int j = 0; j < L; j++) {
        const uint64_t s = a[j] + b[j];
        const uint64_t c1 = s < a[j];
        t[j] = s + c;
        c = c1 | (t[j] < s);
    }
    big_cond_sub<L>(t, c, m, out);
}

// out = a - b mod p
template <int L>
BIG_HD void big_sub(const uint64_t* a, const uint64_t* b, const BigMod<L>& m,
                    uint64_t* out) {
    uint64_t t[L], borrow = 0;
#pragma unroll
    for (int j = 0; j < L; j++) {
        const uint64_t s = a[j] - b[j];
        const uint64_t b1 = a[j] < b[j];
        t[j] = s - borrow;
        borrow = b1 | (s < borrow);
    }
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < L; j++) {  // add p back where it borrowed
        const uint64_t pj = borrow ? m.p[j] : 0;
        const uint64_t s = t[j] + pj;
        const uint64_t c1 = s < pj;
        out[j] = s + c;
        c = c1 | (out[j] < s);
    }
}

// the radix-2 butterfly: (u, v) -> (u + w v, u - w v)
template <int L>
BIG_HD void big_butterfly(uint64_t* u, uint64_t* v, const uint64_t* w,
                          const BigMod<L>& m) {
    uint64_t t[L], s[L];
    big_mont_mul<L>(w, v, m, t);
    big_add<L>(u, t, m, s);
    big_sub<L>(u, t, m, v);
#pragma unroll
    for (int j = 0; j < L; j++) u[j] = s[j];
}

// element i of an (L, n) limb array: limb k at x[k * n + i]
template <int L>
BIG_HD void big_load(const uint64_t* x, int64_t n, int64_t i, uint64_t* v) {
#pragma unroll
    for (int k = 0; k < L; k++) v[k] = x[k * n + i];
}

template <int L>
BIG_HD void big_store(uint64_t* x, int64_t n, int64_t i, const uint64_t* v) {
#pragma unroll
    for (int k = 0; k < L; k++) x[k * n + i] = v[k];
}

// the modulus from its description: L little-endian limbs, then n0inv
template <int L>
BIG_HD BigMod<L> big_mod_from(const uint64_t* desc) {
    BigMod<L> m;
    for (int k = 0; k < L; k++) m.p[k] = desc[k];
    m.n0inv = desc[L];
    return m;
}

BIG_HD int64_t big_bitrev(int64_t i, int log_n) {
    int64_t r = 0;
    for (int b = 0; b < log_n; b++) r |= ((i >> b) & 1) << (log_n - 1 - b);
    return r;
}

// Butterfly k (0 <= k < n/2) of the radix-2 stage of span m (m = 2, 4,
// .., n) over a natural-order array y: positions i0 = (k / h) m + k % h
// and i1 = i0 + h (h = m / 2), twiddle tw[(k % h) (n / m)], tw holding
// w^j for j < n/2 (w the transform's root of unity).
BIG_HD void big_stage_pair(int64_t k, int64_t m, int64_t n, int64_t& i0,
                           int64_t& i1, int64_t& tw_index) {
    const int64_t h = m / 2;
    const int64_t j = k % h;
    i0 = (k / h) * m + j;
    i1 = i0 + h;
    tw_index = j * (n / m);
}
