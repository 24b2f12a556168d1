// Big prime fields (the 128-bit STARK-Anatomy prime, the 252-bit StarkWare
// prime, and any other odd modulus of 2 or 4 u64 limbs): the Montgomery
// product and sums over 32-bit words, and the schedule of the Stockham NTT
// that csrc/bigfield.cu launches, shared by the CUDA kernels (nvcc,
// sm_90a) and by host C++ (g++, the CPU tests run the same code).
//
// Values live in memory as (L, n) arrays of u64 limbs (limb k of element i
// at k * n + i), in Montgomery form v R mod p with R = 2^(64 L), below p.
// In registers an element is W = 2 L 32-bit words, least significant first.
//
// The product.  Every word product is a PTX multiply-add in a carry chain
// (mad.lo.cc / madc.hi.cc, the carry in the condition code register; on
// the host the big_cc member stands in for it).  a b is a row of W products
// a word of b, each row two chains: its low halves and its high halves.
// The two named primes are 1 mod 2^(32 K) with their other nonzero words
// at K .. W-1 and 2 K >= W (Fp128: K = 3, one top word 407 2^23; Fp252:
// K = 6, top words 17 and 2^27).  For such a p = 1 + x, x^2 = 0 mod R, so
// p^-1 = 1 - x mod R and Montgomery's m = -T p^-1 mod R is -T_lo plus the
// short product of T_lo's low words by the top words; then (T + m p) / R =
// T_hi + (f 2^(32 K) + m x) / R, which takes one row of products a top word
// (big_redc_sparse): 2 W^2 + 2 W (W - K) word products in all where CIOS
// takes 2 W^2 + W.  Any other modulus runs CIOS over 32-bit words with its
// n0inv (BigGeneric), chosen by the launch from the modulus' description.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define BIG_HD __host__ __device__ __forceinline__
#else
#define BIG_HD inline
#endif

// ---------------------------------------------------------------------------
// 32-bit carry chains.  A chain starts with an op that takes no carry (add_cc,
// sub_cc, mad_*_cc) and never mixes additions with subtractions.  On the
// card each op is one PTX instruction (asm volatile keeps a chain in order);
// on the host `c.f` holds the carry (or the borrow).
struct big_cc {
    uint32_t f;
};

#ifdef __CUDA_ARCH__
#define BIG_OP2(name, ins)                                                 \
    BIG_HD uint32_t name(uint32_t a, uint32_t b, big_cc&) {                \
        uint32_t d;                                                        \
        asm volatile(ins " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));       \
        return d;                                                          \
    }
#define BIG_OP3(name, ins)                                                 \
    BIG_HD uint32_t name(uint32_t a, uint32_t b, uint32_t c, big_cc&) {    \
        uint32_t d;                                                        \
        asm volatile(ins " %0, %1, %2, %3;"                                \
                     : "=r"(d) : "r"(a), "r"(b), "r"(c));                  \
        return d;                                                          \
    }
BIG_OP2(big_add_cc, "add.cc.u32")
BIG_OP2(big_addc_cc, "addc.cc.u32")
BIG_OP2(big_addc, "addc.u32")
BIG_OP2(big_sub_cc, "sub.cc.u32")
BIG_OP2(big_subc_cc, "subc.cc.u32")
BIG_OP2(big_subc, "subc.u32")
BIG_OP3(big_mad_lo_cc, "mad.lo.cc.u32")
BIG_OP3(big_madc_lo_cc, "madc.lo.cc.u32")
BIG_OP3(big_mad_hi_cc, "mad.hi.cc.u32")
BIG_OP3(big_madc_hi_cc, "madc.hi.cc.u32")
#undef BIG_OP2
#undef BIG_OP3
#else
BIG_HD uint32_t big_put(big_cc& c, uint64_t s) {
    c.f = (uint32_t)(s >> 32);
    return (uint32_t)s;
}
BIG_HD uint32_t big_add_cc(uint32_t a, uint32_t b, big_cc& c) {
    return big_put(c, (uint64_t)a + b);
}
BIG_HD uint32_t big_addc_cc(uint32_t a, uint32_t b, big_cc& c) {
    return big_put(c, (uint64_t)a + b + c.f);
}
BIG_HD uint32_t big_addc(uint32_t a, uint32_t b, big_cc& c) {
    return a + b + c.f;
}
BIG_HD uint32_t big_sub_cc(uint32_t a, uint32_t b, big_cc& c) {
    c.f = a < b;
    return a - b;
}
BIG_HD uint32_t big_subc_cc(uint32_t a, uint32_t b, big_cc& c) {
    const uint64_t s = (uint64_t)b + c.f;
    c.f = a < s;
    return (uint32_t)(a - s);
}
BIG_HD uint32_t big_subc(uint32_t a, uint32_t b, big_cc& c) {
    return a - b - c.f;
}
BIG_HD uint32_t big_mad_lo_cc(uint32_t a, uint32_t b, uint32_t d, big_cc& c) {
    return big_put(c, (uint64_t)(a * b) + d);
}
BIG_HD uint32_t big_madc_lo_cc(uint32_t a, uint32_t b, uint32_t d,
                               big_cc& c) {
    return big_put(c, (uint64_t)(a * b) + d + c.f);
}
BIG_HD uint32_t big_mad_hi_cc(uint32_t a, uint32_t b, uint32_t d, big_cc& c) {
    return big_put(c, (((uint64_t)a * b) >> 32) + d);
}
BIG_HD uint32_t big_madc_hi_cc(uint32_t a, uint32_t b, uint32_t d,
                               big_cc& c) {
    return big_put(c, (((uint64_t)a * b) >> 32) + d + c.f);
}
#endif

// ---------------------------------------------------------------------------
// Multiword arithmetic over W 32-bit words.

// v[h ..] += m w (m: W words, W even), the carries through v[nv - 1]:
// two chains, m's even words and its odd words, each adding its products'
// low and high halves to neighbouring words (a lo/hi pair of one product
// next to each other in one chain, which ptxas can issue as one wide
// multiply-add)
template <int W>
BIG_HD void big_row_add(uint32_t* v, int h, int nv, const uint32_t* m,
                        uint32_t w) {
    big_cc c;
    v[h] = big_mad_lo_cc(m[0], w, v[h], c);
    v[h + 1] = big_madc_hi_cc(m[0], w, v[h + 1], c);
#pragma unroll
    for (int j = 2; j < W; j += 2) {
        v[h + j] = big_madc_lo_cc(m[j], w, v[h + j], c);
        v[h + j + 1] = big_madc_hi_cc(m[j], w, v[h + j + 1], c);
    }
#pragma unroll
    for (int k = h + W; k < nv; k++) v[k] = big_addc_cc(v[k], 0, c);
    v[h + 1] = big_mad_lo_cc(m[1], w, v[h + 1], c);
    v[h + 2] = big_madc_hi_cc(m[1], w, v[h + 2], c);
#pragma unroll
    for (int j = 3; j < W; j += 2) {
        v[h + j] = big_madc_lo_cc(m[j], w, v[h + j], c);
        v[h + j + 1] = big_madc_hi_cc(m[j], w, v[h + j + 1], c);
    }
#pragma unroll
    for (int k = h + W + 1; k < nv; k++) v[k] = big_addc_cc(v[k], 0, c);
}

// t[0 .. 2W-1] = a b: row i adds a b_i as big_row_add does (its sum fits
// t[0 .. i + W], so the odd chain ends without a carry); row 0's even
// products are plain wide products
template <int W>
BIG_HD void big_mul_wide(const uint32_t* a, const uint32_t* b, uint32_t* t) {
#pragma unroll
    for (int j = 0; j < W; j += 2) {
        const uint64_t p = (uint64_t)a[j] * b[0];
        t[j] = (uint32_t)p;
        t[j + 1] = (uint32_t)(p >> 32);
    }
#pragma unroll
    for (int k = W; k < 2 * W; k++) t[k] = 0;
    {
        big_cc c;
        t[1] = big_mad_lo_cc(a[1], b[0], t[1], c);
        t[2] = big_madc_hi_cc(a[1], b[0], t[2], c);
#pragma unroll
        for (int j = 3; j < W; j += 2) {
            t[j] = big_madc_lo_cc(a[j], b[0], t[j], c);
            t[j + 1] = big_madc_hi_cc(a[j], b[0], t[j + 1], c);
        }
    }
#pragma unroll
    for (int i = 1; i < W; i++) big_row_add<W>(t, i, i + W + 1, a, b[i]);
}

// (overflow, x) = x + y
template <int W>
BIG_HD uint32_t big_add_words(const uint32_t* x, const uint32_t* y,
                              uint32_t* out) {
    big_cc c;
    out[0] = big_add_cc(x[0], y[0], c);
#pragma unroll
    for (int j = 1; j < W; j++) out[j] = big_addc_cc(x[j], y[j], c);
    return big_addc(0, 0, c);
}

// out = x - y; returns 0xFFFFFFFF where it borrowed, else 0
template <int W>
BIG_HD uint32_t big_sub_words(const uint32_t* x, const uint32_t* y,
                              uint32_t* out) {
    big_cc c;
    out[0] = big_sub_cc(x[0], y[0], c);
#pragma unroll
    for (int j = 1; j < W; j++) out[j] = big_subc_cc(x[j], y[j], c);
    return big_subc(0, 0, c);
}

// x = (overflow, x) - p where that is >= 0, else x; (overflow, x) < 2p
template <int W>
BIG_HD void big_cond_sub(uint32_t* x, uint32_t overflow, const uint32_t* p) {
    uint32_t d[W];
    big_cc c;
    d[0] = big_sub_cc(x[0], p[0], c);
#pragma unroll
    for (int j = 1; j < W; j++) d[j] = big_subc_cc(x[j], p[j], c);
    const bool keep = big_subc(overflow, 0, c) != 0;  // borrowed past it
#pragma unroll
    for (int j = 0; j < W; j++) x[j] = keep ? x[j] : d[j];
}

// ---------------------------------------------------------------------------
// The fields.  Each is a small object (the generic one holds its modulus)
// with the canonical product over W words and the modulus' words.

// Fp128 = 1 + 407 2^119: words [1, 0, 0, 0xCB800000]
struct BigP128 {
    static constexpr int W = 4, K = 3;
    static constexpr bool LAZY = false;  // 2p > R: no headroom
    BIG_HD static constexpr uint32_t top(int) { return 0xCB800000u; }
};

// Fp252 = 2^251 + 17 2^192 + 1: words [1, 0, 0, 0, 0, 0, 17, 2^27]
struct BigP252 {
    static constexpr int W = 8, K = 6;
    static constexpr bool LAZY = true;
    BIG_HD static constexpr uint32_t top(int h) {
        return h == 0 ? 17u : 0x08000000u;
    }
};

// out = t R^-1 mod p, below p + t / R (overflow: its bit 32 W; below 2p
// for t < p R), p = 1 + x, x = sum_h top(h) 2^(32 (K + h)):
//   m = -t_lo + f 2^(32 K) mod R, f = t_lo top mod 2^(32 H) (H = W - K),
//   t + m = (t_hi + z) R + f 2^(32 K) (z = [t_lo != 0] less 1 where the sum
//   for m wrapped past R), and (t + m p) / R = t_hi + z + V / 2^(32 H) over
//   V = f + m top, whose low H words come out 0
template <class P>
BIG_HD void big_redc_sparse(const uint32_t* t, uint32_t* out,
                            uint32_t& overflow) {
    constexpr int W = P::W, K = P::K, H = W - K, NV = W + H;
    uint32_t m[W];
    big_cc c;
    m[0] = big_sub_cc(0, t[0], c);
#pragma unroll
    for (int j = 1; j < W; j++) m[j] = big_subc_cc(0, t[j], c);
    const uint32_t z = big_subc(0, 0, c) & 1;  // borrowed: t_lo != 0
    // f = t_lo top mod 2^(32 H), a short schoolbook product
    uint32_t f[H];
#pragma unroll
    for (int h = 0; h < H; h++) f[h] = 0;
#pragma unroll
    for (int i = 0; i < H; i++) {
        uint32_t carry = 0;
#pragma unroll
        for (int j = 0; i + j < H; j++) {
            const uint64_t s = (uint64_t)t[i] * P::top(j) + f[i + j] + carry;
            f[i + j] = (uint32_t)s;
            carry = (uint32_t)(s >> 32);
        }
    }
    m[K] = big_add_cc(m[K], f[0], c);
#pragma unroll
    for (int h = 1; h < H; h++) m[K + h] = big_addc_cc(m[K + h], f[h], c);
    // m wrapped past R (then t_lo != 0): t + m = (t_hi + z - 1) R + f 2^(32 K)
    const uint32_t wrapped = big_addc(0, 0, c);
    uint32_t v[NV];
#pragma unroll
    for (int h = 0; h < H; h++) v[h] = f[h];
    v[H] = z - wrapped;
#pragma unroll
    for (int k = H + 1; k < NV; k++) v[k] = 0;
#pragma unroll
    for (int h = 0; h < H; h++) big_row_add<W>(v, h, NV, m, P::top(h));
    overflow = big_add_words<W>(t + W, v + H, out);
}

// NTT_LAZY: the NTT holds its values below 4p between butterflies (for a
// p with 16 p < R: Fp252, whose p < 2^252)
template <class P>
struct BigSparse {
    static constexpr int W = P::W;
    static constexpr bool SPARSE = true, NTT_LAZY = P::LAZY;
    BIG_HD void pwords(uint32_t* p) const {
#pragma unroll
        for (int j = 0; j < W; j++)
            p[j] = j == 0 ? 1u : j < P::K ? 0u : P::top(j - P::K);
    }
    // out = a b R^-1 mod p; a, b below p; out may alias either
    BIG_HD void mul(const uint32_t* a, const uint32_t* b,
                    uint32_t* out) const {
        uint32_t t[2 * W], p[W], overflow;
        big_mul_wide<W>(a, b, t);
        big_redc_sparse<P>(t, out, overflow);
        pwords(p);
        big_cond_sub<W>(out, overflow, p);
    }
    // the same without the conditional subtraction: below 2p for a b <
    // 16 p^2 (a, b below 4p) where 16 p < R
    BIG_HD void mul_lazy(const uint32_t* a, const uint32_t* b,
                         uint32_t* out) const {
        uint32_t t[2 * W], overflow;
        big_mul_wide<W>(a, b, t);
        big_redc_sparse<P>(t, out, overflow);
    }
};

// any odd modulus of W words: CIOS over 32-bit words (Koc, Acar and
// Kaliski), t below 2p after each step, W + 2 words
template <int L>
struct BigGeneric {
    static constexpr int W = 2 * L;
    static constexpr bool SPARSE = false, NTT_LAZY = false;
    uint32_t p[W];
    uint32_t n0inv;  // -p^-1 mod 2^32
    BIG_HD void pwords(uint32_t* q) const {
#pragma unroll
        for (int j = 0; j < W; j++) q[j] = p[j];
    }
    BIG_HD void mul(const uint32_t* a, const uint32_t* b,
                    uint32_t* out) const {
        uint32_t t[W + 2];
#pragma unroll
        for (int j = 0; j < W + 2; j++) t[j] = 0;
#pragma unroll
        for (int i = 0; i < W; i++) {
            big_row_add<W>(t, 0, W + 2, a, b[i]);
            const uint32_t q = t[0] * n0inv;
            big_row_add<W>(t, 0, W + 2, p, q);  // t[0] becomes 0
#pragma unroll
            for (int j = 0; j < W + 1; j++) t[j] = t[j + 1];
            t[W + 1] = 0;
        }
        uint32_t q[W];
        pwords(q);
#pragma unroll
        for (int j = 0; j < W; j++) out[j] = t[j];
        big_cond_sub<W>(out, t[W], q);
    }
};

// The field a modulus description names (its L little-endian u64 limbs,
// then n0inv = -p^-1 mod 2^64): fn(field) with BigSparse for the two named
// primes, BigGeneric<L> for any other (L = 2 or 4); on the host.
inline bool big_is(const uint64_t* mod, int64_t L, const uint64_t* limbs,
                   int64_t limbs_L) {
    if (L != limbs_L) return false;
    for (int k = 0; k < L; k++)
        if (mod[k] != limbs[k]) return false;
    return true;
}

template <int L>
inline BigGeneric<L> big_generic(const uint64_t* mod) {
    BigGeneric<L> g;
    for (int k = 0; k < L; k++) {
        g.p[2 * k] = (uint32_t)mod[k];
        g.p[2 * k + 1] = (uint32_t)(mod[k] >> 32);
    }
    g.n0inv = (uint32_t)mod[L];
    return g;
}

// generic: take BigGeneric even for a named prime (the tests)
template <class Fn>
inline int big_dispatch(const uint64_t* mod, int64_t L, Fn fn,
                        bool generic = false) {
    static const uint64_t p128[2] = {1, 0xCB80000000000000ULL};
    static const uint64_t p252[4] = {1, 0, 0, 0x0800000000000011ULL};
    if (!generic && big_is(mod, L, p128, 2)) return fn(BigSparse<BigP128>());
    if (!generic && big_is(mod, L, p252, 4)) return fn(BigSparse<BigP252>());
    if (L == 2) return fn(big_generic<2>(mod));
    if (L == 4) return fn(big_generic<4>(mod));
    return -1;
}

// out = a + b mod p, a - b mod p (canonical); out may alias either
template <class F>
BIG_HD void big_add(const F& f, const uint32_t* a, const uint32_t* b,
                    uint32_t* out) {
    uint32_t p[F::W];
    f.pwords(p);
    const uint32_t overflow = big_add_words<F::W>(a, b, out);
    big_cond_sub<F::W>(out, overflow, p);
}

template <class F>
BIG_HD void big_sub(const F& f, const uint32_t* a, const uint32_t* b,
                    uint32_t* out) {
    uint32_t p[F::W];
    f.pwords(p);
    const uint32_t borrow = big_sub_words<F::W>(a, b, out);
#pragma unroll
    for (int j = 0; j < F::W; j++) p[j] &= borrow;  // add p back where it borrowed
    big_add_words<F::W>(out, p, out);
}

// The NTT's arithmetic on the values it holds: canonical, or below 4p for a
// lazy field (Harvey's butterfly: u brought below 2p, w v below 2p without
// its conditional subtraction, then u + w v and u - w v + 2p), made
// canonical where stored.
template <class F>
BIG_HD void big_twice_p(const F& f, uint32_t* p2) {
    f.pwords(p2);
    big_add_words<F::W>(p2, p2, p2);
}

template <class F>
BIG_HD void big_below_2p(const F& f, uint32_t* x) {
    uint32_t p2[F::W], d[F::W];
    big_twice_p(f, p2);
    const uint32_t borrow = big_sub_words<F::W>(x, p2, d);
#pragma unroll
    for (int j = 0; j < F::W; j++) x[j] = borrow ? x[j] : d[j];
}

// a = a w (w canonical)
template <class F>
BIG_HD void big_held_mul(const F& f, uint32_t* a, const uint32_t* w) {
    if constexpr (F::NTT_LAZY)
        f.mul_lazy(a, w, a);
    else
        f.mul(a, w, a);
}

template <class F>
BIG_HD void big_held_canon(const F& f, uint32_t* x) {
    if constexpr (F::NTT_LAZY) {
        uint32_t p[F::W];
        f.pwords(p);
        big_below_2p(f, x);
        big_cond_sub<F::W>(x, 0, p);
    }
}

// (u, v) = (u + w v, u - w v), w canonical
template <class F>
BIG_HD void big_bfly(const F& f, uint32_t* u, uint32_t* v, const uint32_t* w) {
    uint32_t t[F::W];
    if constexpr (F::NTT_LAZY) {
        uint32_t p2[F::W];
        big_below_2p(f, u);
        f.mul_lazy(v, w, t);
        big_twice_p(f, p2);
        big_add_words<F::W>(u, p2, v);
        big_sub_words<F::W>(v, t, v);
        big_add_words<F::W>(u, t, u);
    } else {
        f.mul(v, w, t);
        big_sub(f, u, t, v);
        big_add(f, u, t, u);
    }
}

// (u, v) = (u + v, u - v)
template <class F>
BIG_HD void big_bfly1(const F& f, uint32_t* u, uint32_t* v) {
    uint32_t d[F::W];
    if constexpr (F::NTT_LAZY) {
        uint32_t p2[F::W];
        big_below_2p(f, u);
        big_below_2p(f, v);
        big_twice_p(f, p2);
        big_add_words<F::W>(u, p2, d);
        big_sub_words<F::W>(d, v, d);
        big_add_words<F::W>(u, v, u);
    } else {
        big_sub(f, u, v, d);
        big_add(f, u, v, u);
    }
#pragma unroll
    for (int j = 0; j < F::W; j++) v[j] = d[j];
}

// element i of an (L, n) limb array as W = 2 L words (inputs are read-only:
// through the read-only data cache on the card)
template <int W>
BIG_HD void big_ld(const uint64_t* x, int64_t n, int64_t i, uint32_t* v) {
#pragma unroll
    for (int k = 0; k < W / 2; k++) {
#ifdef __CUDA_ARCH__
        const uint64_t l = __ldg((const unsigned long long*)x + k * n + i);
#else
        const uint64_t l = x[k * n + i];
#endif
        v[2 * k] = (uint32_t)l;
        v[2 * k + 1] = (uint32_t)(l >> 32);
    }
}

template <int W>
BIG_HD void big_st(uint64_t* x, int64_t n, int64_t i, const uint32_t* v) {
#pragma unroll
    for (int k = 0; k < W / 2; k++)
        x[k * n + i] = (uint64_t)v[2 * k] | (uint64_t)v[2 * k + 1] << 32;
}

// ---------------------------------------------------------------------------
// The NTT: y[k] = sum_i x[i] w^(i k) (w the transform's root, tw[j] = w^j),
// natural order in and out, as a Stockham autosort transform of P passes,
// each a launch: pass p takes the n / R groups j of R = 2^log_r points
// x[j + r n/R], multiplies point r by w_(Ns R)^(r (j mod Ns)) (Ns: the
// product of the earlier passes' radices; none in the first pass), runs
// their R-point DFT and writes its point k to y[(j / Ns) Ns R + j mod Ns +
// k Ns].  At most 2^9 points a group: 2^18 points are two passes of 2^9.
// A block takes C neighbouring groups (a warp reads and writes whole 32-byte
// sectors: C >= 4 neighbouring elements of a limb plane); a group's DFT is
// itself Stockham rounds of radix 2 or 4 in registers, BIG_NTT_V = 4 values
// a thread (fewer below 4 points; at 2^18 points the card holds 2^16
// threads, twice as many warps an SM as at 8 values, which the carry
// chains' latency needs), R / V threads a group, the rounds exchanging
// through shared memory.  Every twiddle is read from one table in the
// order the threads read it (coalesced), built from tw once per domain by
// BigDomain from the exponents big_ntt_plan lists.  BIG_NTT_LOG_R: a
// pass's largest radix (the tests also build 5: three passes at 2^11).
#ifndef BIG_NTT_LOG_R
#define BIG_NTT_LOG_R 9
#endif
#define BIG_NTT_V 4
#define BIG_NTT_MAX_PASSES ((62 + BIG_NTT_LOG_R - 1) / BIG_NTT_LOG_R)
#define BIG_NTT_MAX_ROUNDS BIG_NTT_LOG_R  // radix 2 at least

struct BigNttPass {
    int pass, passes;  // this pass, and the transform's passes
    int64_t n;         // the transform's size
    int64_t ns;        // the earlier passes' radices' product, 2^log_ns
    int log_ns;
    int log_r;         // R = 2^log_r points a group
    int v;             // values a thread: min(BIG_NTT_V, n)
    int cols;          // groups a block (the launch sets it)
    int nrounds;       // the group DFT's rounds, each of radix 2^log_rho[b]
    int log_rho[BIG_NTT_MAX_ROUNDS];
    int log_ns_round[BIG_NTT_MAX_ROUNDS];   // the earlier rounds' product
    int64_t off_round[BIG_NTT_MAX_ROUNDS];  // round twiddles (-1: none)
    int64_t off_pass;   // pass twiddles in the table (-1: none)
    int64_t off_roots;  // w_v^k, k < v / 2: the DFT's roots
};

struct BigNttPlan {
    int passes;
    BigNttPass pass[BIG_NTT_MAX_PASSES];
    int64_t table;  // entries of the twiddle table
};

// The passes of a 2^log_n-point transform, and the exponents e of its
// twiddle table's entries w^e (exps may be null): the DFT roots w_v^k; each
// later pass's w_(Ns R)^(r s) at r Ns + s (r < R, s < Ns); each later
// round's w_(rho Ns')^(q s) at q Ns' + s (q < rho, s < Ns').  A pass's
// radices: a smaller round first where log_r is not a multiple of log2 v,
// then rounds of v.
inline void big_ntt_plan(int log_n, BigNttPlan& pl, int64_t* exps) {
    const int64_t n = (int64_t)1 << log_n;
    const int P = log_n == 0 ? 1 : (log_n + BIG_NTT_LOG_R - 1) / BIG_NTT_LOG_R;
    const int v = n < BIG_NTT_V ? (int)n : BIG_NTT_V;
    const int log_v = v == 4 ? 2 : v == 2 ? 1 : 0;
    int64_t off = 0;
    // the entries w^(step a b) at off + a cols + b, a < rows, b < cols
    auto put = [&](int64_t rows, int64_t cols, int64_t step) {
        if (exps)
            for (int64_t a = 0; a < rows; a++)
                for (int64_t b = 0; b < cols; b++)
                    exps[off + a * cols + b] = step * a * b;
        off += rows * cols;
    };
    if (exps)
        for (int k = 0; k < v / 2; k++) exps[k] = k * (n / v);
    off = v / 2;
    pl.passes = P;
    int64_t ns = 1;
    int log_ns = 0;
    for (int q = 0; q < P; q++) {
        BigNttPass& ps = pl.pass[q];
        const int lr = log_n / P + (q < log_n % P ? 1 : 0);
        const int64_t R = (int64_t)1 << lr;
        ps.pass = q;
        ps.passes = P;
        ps.n = n;
        ps.ns = ns;
        ps.log_ns = log_ns;
        ps.log_r = lr;
        ps.v = v;
        ps.cols = 1;
        ps.off_roots = 0;
        ps.off_pass = -1;
        if (ns > 1) {
            ps.off_pass = off;
            put(R, ns, n / (ns * R));
        }
        ps.nrounds = 0;
        int left = lr;
        int64_t ns1 = 1;
        while (left > 0) {
            const int b = ps.nrounds++;
            const int lrho = left % log_v ? left % log_v : log_v;
            const int64_t rho = (int64_t)1 << lrho;
            ps.log_rho[b] = lrho;
            ps.log_ns_round[b] = lr - left;
            ps.off_round[b] = -1;
            if (ns1 > 1) {
                ps.off_round[b] = off;
                put(rho, ns1, n / (rho * ns1));
            }
            ns1 *= rho;
            left -= lrho;
        }
        ns *= R;
        log_ns += lr;
    }
    pl.table = off;
}

// a pass's groups a block: `points` / R of them, at least one, at most all
// (the launch takes BIG_NTT_POINTS; the tests fewer too)
inline int big_ntt_cols(const BigNttPass& ps, int64_t points) {
    const int64_t R = (int64_t)1 << ps.log_r, groups = ps.n / R;
    const int64_t c = points / R < groups ? points / R : groups;
    return (int)(c > 1 ? c : 1);
}

// i's lowest `bits` (at most 2) bits reversed: one expression, so that an
// unrolled loop's register index folds to a constant
BIG_HD constexpr int big_bitrev2(int i, int bits) {
    return bits == 2 ? (i & 1) << 1 | (i >> 1 & 1) : i & (bits == 1 ? 1 : 0);
}

// a shared-memory plane: position pos of group col among C, one padding
// row every 8 positions, so that each exchange's half-warps hit distinct
// banks
BIG_HD int64_t big_slot(int64_t pos, int col, int cols) {
    return (pos + (pos >> 3)) * cols + col;
}

BIG_HD int64_t big_plane(const BigNttPass& ps) {
    const int64_t R = (int64_t)1 << ps.log_r;
    return (R + R / 8) * ps.cols;
}

// A thread t of group j holds the group's points t + (R / V) i, i < V.

// its points from x, times scale_first (first pass), times the pass twiddles
template <class F, int V>
BIG_HD void big_ntt_load(const F& f, const BigNttPass& ps, const uint64_t* x,
                         const uint64_t* sf, const uint64_t* tab, int64_t ntab,
                         int64_t j, int t, uint32_t (*v)[F::W]) {
    constexpr int W = F::W;
    const int64_t R = (int64_t)1 << ps.log_r, tc = R / V, stride = ps.n / R;
#pragma unroll
    for (int i = 0; i < V; i++) {
        const int64_t r = t + tc * i, src = j + r * stride;
        big_ld<W>(x, ps.n, src, v[i]);
        // the first pass has no pass twiddles, a later one no scale_first
        if (sf || ps.off_pass >= 0) {
            uint32_t w[W];
            if (sf)
                big_ld<W>(sf, ps.n, src, w);
            else
                big_ld<W>(tab, ntab,
                          ps.off_pass + r * ps.ns + (j & (ps.ns - 1)), w);
            big_held_mul(f, v[i], w);
        }
    }
}

// the RHO-point DFT of the thread's group u: points v[u + q G], q < RHO
// (G = V / RHO), in and out in natural order, radix-2 DIT over the points in
// bit-reversed order, the roots w_RHO^k = w_V^(k V / RHO) from the table
template <class F, int V, int RHO>
BIG_HD void big_dft(const F& f, uint32_t (*v)[F::W], int u,
                    const uint64_t* tab, int64_t ntab, int64_t off_roots) {
    constexpr int W = F::W, G = V / RHO;
    constexpr int LR = RHO == 2 ? 1 : 2;
#pragma unroll
    for (int s = 1; s <= LR; s++) {
        const int m = 1 << s;
#pragma unroll
        for (int base = 0; base < RHO; base += m) {
#pragma unroll
            for (int k = 0; k < m / 2; k++) {
                uint32_t* a = v[u + big_bitrev2(base + k, LR) * G];
                uint32_t* b = v[u + big_bitrev2(base + k + m / 2, LR) * G];
                if (k == 0) {
                    big_bfly1(f, a, b);
                } else {
                    uint32_t w[W];
                    big_ld<W>(tab, ntab, off_roots + k * (V / m), w);
                    big_bfly(f, a, b, w);
                }
            }
        }
    }
    uint32_t tmp[RHO][W];
#pragma unroll
    for (int k = 0; k < RHO; k++)
#pragma unroll
        for (int j = 0; j < W; j++) tmp[k][j] = v[u + k * G][j];
#pragma unroll
    for (int k = 0; k < RHO; k++)
#pragma unroll
        for (int j = 0; j < W; j++)
            v[u + k * G][j] = tmp[big_bitrev2(k, LR)][j];
}

// round b of radix RHO: for each of the thread's groups g = t + u tc
// (u < V / RHO, tc = R / V) its twiddles w_(RHO Ns')^(q (g mod Ns')), then
// its DFT
template <class F, int V, int RHO>
BIG_HD void big_ntt_round_rho(const F& f, const BigNttPass& ps, int b,
                              const uint64_t* tab, int64_t ntab, int t,
                              uint32_t (*v)[F::W]) {
    constexpr int W = F::W, G = V / RHO;
    const int64_t tc = ((int64_t)1 << ps.log_r) / V,
                  ns1 = (int64_t)1 << ps.log_ns_round[b];
#pragma unroll
    for (int u = 0; u < G; u++) {
        if (ns1 > 1) {
            const int64_t s = (t + u * tc) & (ns1 - 1);
#pragma unroll
            for (int q = 1; q < RHO; q++) {
                uint32_t w[W];
                big_ld<W>(tab, ntab, ps.off_round[b] + q * ns1 + s, w);
                big_held_mul(f, v[u + q * G], w);
            }
        }
        big_dft<F, V, RHO>(f, v, u, tab, ntab, ps.off_roots);
    }
}

template <class F, int V>
BIG_HD void big_ntt_round(const F& f, const BigNttPass& ps, int b,
                          const uint64_t* tab, int64_t ntab, int t,
                          uint32_t (*v)[F::W]) {
    const int lrho = ps.log_rho[b];
    if constexpr (V >= 4)
        if (lrho == 2) big_ntt_round_rho<F, V, 4>(f, ps, b, tab, ntab, t, v);
    if constexpr (V >= 2)
        if (lrho == 1) big_ntt_round_rho<F, V, 2>(f, ps, b, tab, ntab, t, v);
}

// after round b (radix RHO): group g's point q goes to position
// (g / Ns') Ns' RHO + g mod Ns' + q Ns' of the group's shared planes
template <class F, int V, int RHO>
BIG_HD void big_ntt_put_rho(const BigNttPass& ps, int b, uint64_t* sm,
                            int col, int t, uint32_t (*v)[F::W]) {
    constexpr int W = F::W, G = V / RHO;
    const int64_t tc = ((int64_t)1 << ps.log_r) / V,
                  ns1 = (int64_t)1 << ps.log_ns_round[b];
    const int64_t plane = big_plane(ps);
#pragma unroll
    for (int u = 0; u < G; u++) {
        const int64_t g = t + u * tc;
        const int64_t base =
            ((g >> ps.log_ns_round[b]) << ps.log_ns_round[b]) * RHO
            + (g & (ns1 - 1));
#pragma unroll
        for (int q = 0; q < RHO; q++) {
            const int64_t slot = big_slot(base + q * ns1, col, ps.cols);
#pragma unroll
            for (int k = 0; k < W / 2; k++)
                sm[k * plane + slot] = (uint64_t)v[u + q * G][2 * k]
                                       | (uint64_t)v[u + q * G][2 * k + 1] << 32;
        }
    }
}

template <class F, int V>
BIG_HD void big_ntt_put(const BigNttPass& ps, int b, uint64_t* sm, int col,
                        int t, uint32_t (*v)[F::W]) {
    const int lrho = ps.log_rho[b];
    if constexpr (V >= 4)
        if (lrho == 2) big_ntt_put_rho<F, V, 4>(ps, b, sm, col, t, v);
    if constexpr (V >= 2)
        if (lrho == 1) big_ntt_put_rho<F, V, 2>(ps, b, sm, col, t, v);
}

// the thread's points t + tc i back from the shared planes
template <class F, int V>
BIG_HD void big_ntt_get(const BigNttPass& ps, const uint64_t* sm, int col,
                        int t, uint32_t (*v)[F::W]) {
    const int64_t tc = ((int64_t)1 << ps.log_r) / V, plane = big_plane(ps);
#pragma unroll
    for (int i = 0; i < V; i++) {
        const int64_t slot = big_slot(t + tc * i, col, ps.cols);
#pragma unroll
        for (int k = 0; k < F::W / 2; k++) {
            const uint64_t l = sm[k * plane + slot];
            v[i][2 * k] = (uint32_t)l;
            v[i][2 * k + 1] = (uint32_t)(l >> 32);
        }
    }
}

// after the last round the thread holds its group's DFT points t + tc i:
// to y[(j / Ns) Ns R + j mod Ns + k Ns], times scale_last (last pass)
template <class F, int V>
BIG_HD void big_ntt_store(const F& f, const BigNttPass& ps, uint64_t* y,
                          const uint64_t* sl, int64_t j, int t,
                          uint32_t (*v)[F::W]) {
    constexpr int W = F::W;
    const int64_t R = (int64_t)1 << ps.log_r, tc = R / V;
    const int64_t base = ((j >> ps.log_ns) << (ps.log_ns + ps.log_r))
                         + (j & (ps.ns - 1));
#pragma unroll
    for (int i = 0; i < V; i++) {
        const int64_t dst = base + (t + tc * i) * ps.ns;
        if (sl) {
            uint32_t w[W];
            big_ld<W>(sl, ps.n, dst, w);
            big_held_mul(f, v[i], w);
        }
        if (ps.pass + 1 == ps.passes) big_held_canon(f, v[i]);
        big_st<W>(y, ps.n, dst, v[i]);
    }
}
