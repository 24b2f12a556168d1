// Goldilocks field p = 2^64 - 2^32 + 1: per-element arithmetic shared by the
// CUDA kernels (nvcc, sm_90a) and by host C++ (g++, for the CPU tests).
//
// Values are canonical u64 in [0, p).  The 128-bit product comes from
// __umul64hi on the device and unsigned __int128 on the host; the reduction
// uses 2^64 = 2^32 - 1 and 2^96 = -1 (mod p), as native/ministark_native.cpp
// does on the host.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define GL_HD __host__ __device__ __forceinline__
#define GL_FN __host__ __device__ __forceinline__  // member functions
#else
#define GL_HD static inline
#define GL_FN inline
#endif

#define GL_P 0xFFFFFFFF00000001ULL
#define GL_EPS 0xFFFFFFFFULL  // 2^64 mod p

GL_HD uint64_t gl_add(uint64_t a, uint64_t b) {
    uint64_t s = a + b;
    if (s < a || s >= GL_P) s -= GL_P;
    return s;
}

GL_HD uint64_t gl_sub(uint64_t a, uint64_t b) {
    return a >= b ? a - b : a + (GL_P - b);
}

GL_HD uint64_t gl_neg(uint64_t a) { return a == 0 ? 0 : GL_P - a; }

// lo + hi 2^64 mod p, lazy (any u64 congruent): lo - hi_hi (a borrow
// takes 2^64 mod p more off), plus hi_lo (2^32 - 1) (a carry adds 2^64
// mod p back)
GL_HD uint64_t gl_reduce_lazy(uint64_t lo, uint64_t hi) {
    uint64_t hi_hi = hi >> 32;
    uint64_t hi_lo = hi & 0xFFFFFFFFULL;
    uint64_t t = lo - hi_hi;
    if (lo < hi_hi) t -= GL_EPS;               // borrow: -2^64 = -(2^32 - 1)
    uint64_t u = (hi_lo << 32) - hi_lo;        // hi_lo * (2^32 - 1)
    uint64_t r = t + u;
    if (r < t) r += GL_EPS;                    // carry: +2^64 = +(2^32 - 1)
    return r;
}

GL_HD uint64_t gl_reduce128(uint64_t lo, uint64_t hi) {
    const uint64_t r = gl_reduce_lazy(lo, hi);
    return r >= GL_P ? r - GL_P : r;
}

GL_HD uint64_t gl_mul(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
    return gl_reduce128(a * b, __umul64hi(a, b));
#else
    unsigned __int128 p = (unsigned __int128)a * b;
    return gl_reduce128((uint64_t)p, (uint64_t)(p >> 64));
#endif
}

GL_HD uint64_t gl_pow(uint64_t base, uint64_t e) {
    uint64_t acc = 1;
    while (e) {
        if (e & 1) acc = gl_mul(acc, base);
        base = gl_mul(base, base);
        e >>= 1;
    }
    return acc;
}

GL_HD uint64_t gl_canon(uint64_t a) { return a >= GL_P ? a - GL_P : a; }

// a * b for any u64 a and b, as a u64 congruent to it (not always
// canonical): gl_mul's arithmetic, on the card as 32-bit PTX carry chains
// (the 128-bit product, then its reduction), which runs faster than
// gl_mul's C++ in kernels A and B
GL_HD uint64_t gl_mul_cc_lazy(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
    const uint32_t a0 = (uint32_t)a, a1 = (uint32_t)(a >> 32);
    const uint32_t b0 = (uint32_t)b, b1 = (uint32_t)(b >> 32);
    uint32_t r0, r1, r2, r3, s0, s1;
    asm("mul.lo.u32 %0, %4, %6;\n\t"
        "mul.hi.u32 %1, %4, %6;\n\t"
        "mad.lo.cc.u32 %1, %4, %7, %1;\n\t"
        "madc.hi.u32 %2, %4, %7, 0;\n\t"
        "mad.lo.cc.u32 %1, %5, %6, %1;\n\t"
        "madc.hi.cc.u32 %2, %5, %6, %2;\n\t"
        "madc.hi.u32 %3, %5, %7, 0;\n\t"
        "mad.lo.cc.u32 %2, %5, %7, %2;\n\t"
        "addc.u32 %3, %3, 0;"
        : "=&r"(r0), "=&r"(r1), "=&r"(r2), "=&r"(r3)
        : "r"(a0), "r"(a1), "r"(b0), "r"(b1));
    // lo - r3 (a borrow takes 2^64 mod p more off), plus r2 * (2^32 - 1)
    // (a carry adds 2^64 mod p back), as in gl_reduce128
    asm("{\n\t.reg .u32 t0, t1, m, u0, u1, z;\n\t"
        "mov.u32 z, 0;\n\t"
        "sub.cc.u32 t0, %2, %5;\n\t"
        "subc.cc.u32 t1, %3, z;\n\t"
        "subc.u32 m, z, z;\n\t"
        "sub.cc.u32 t0, t0, m;\n\t"
        "subc.u32 t1, t1, z;\n\t"
        "sub.cc.u32 u0, z, %4;\n\t"
        "subc.u32 u1, %4, z;\n\t"
        "add.cc.u32 t0, t0, u0;\n\t"
        "addc.cc.u32 t1, t1, u1;\n\t"
        "addc.u32 m, z, z;\n\t"
        "neg.s32 m, m;\n\t"
        "add.cc.u32 %0, t0, m;\n\t"
        "addc.u32 %1, t1, z;\n\t"
        "}"
        : "=&r"(s0), "=&r"(s1)
        : "r"(r0), "r"(r1), "r"(r2), "r"(r3));
    return ((uint64_t)s1 << 32) | s0;
#else
    return gl_mul(a, b);
#endif
}

// a * b, canonical, for any u64 a and b
GL_HD uint64_t gl_mul_cc(uint64_t a, uint64_t b) {
    return gl_canon(gl_mul_cc_lazy(a, b));
}

// The products as function objects, for routines templated on theirs:
// operator() is canonical, lazy() may leave any u64 congruent to the
// product (an input to further products, not to gl_add or gl_sub), sqr()
// is lazy(a, a).
struct gl_mul_fn {
    GL_FN uint64_t operator()(uint64_t a, uint64_t b) const {
        return gl_mul(a, b);
    }
    GL_FN uint64_t lazy(uint64_t a, uint64_t b) const { return gl_mul(a, b); }
    GL_FN uint64_t sqr(uint64_t a) const { return gl_mul(a, a); }
};
struct gl_mul_cc_fn {
    GL_FN uint64_t operator()(uint64_t a, uint64_t b) const {
        return gl_mul_cc(a, b);
    }
    GL_FN uint64_t lazy(uint64_t a, uint64_t b) const {
        return gl_mul_cc_lazy(a, b);
    }
    GL_FN uint64_t sqr(uint64_t a) const { return gl_mul_cc_lazy(a, a); }
};

// a * b for any u64 a and b, lazy, from four independent 32x32 -> 64
// products and 64-bit adds: a shorter chain of dependent instructions than
// gl_mul_cc_lazy's carry chains, for chains of products (the device
// coin's RPO-256 S-boxes: scripts/coin_single.cu times both)
GL_HD uint64_t gl_mul_wide_lazy(uint64_t a, uint64_t b) {
    const uint32_t a0 = (uint32_t)a, a1 = (uint32_t)(a >> 32);
    const uint32_t b0 = (uint32_t)b, b1 = (uint32_t)(b >> 32);
    const uint64_t p00 = (uint64_t)a0 * b0, p01 = (uint64_t)a0 * b1;
    const uint64_t p10 = (uint64_t)a1 * b0, p11 = (uint64_t)a1 * b1;
    const uint64_t mid = p01 + p10;
    const uint64_t mc = (uint64_t)(mid < p01 ? 1 : 0) << 32;
    const uint64_t lo = p00 + (mid << 32);
    const uint64_t hi = p11 + (mid >> 32) + mc + (lo < p00 ? 1 : 0);
    return gl_reduce_lazy(lo, hi);
}

// a^2 the same way, three products (a0 a1 doubled by the shift)
GL_HD uint64_t gl_sqr_wide_lazy(uint64_t a) {
    const uint32_t a0 = (uint32_t)a, a1 = (uint32_t)(a >> 32);
    const uint64_t p00 = (uint64_t)a0 * a0, p01 = (uint64_t)a0 * a1;
    const uint64_t p11 = (uint64_t)a1 * a1;
    const uint64_t lo = p00 + (p01 << 33);
    const uint64_t hi = p11 + (p01 >> 31) + (lo < p00 ? 1 : 0);
    return gl_reduce_lazy(lo, hi);
}

struct gl_mul_wide_fn {
    GL_FN uint64_t operator()(uint64_t a, uint64_t b) const {
        return gl_canon(gl_mul_wide_lazy(a, b));
    }
    GL_FN uint64_t lazy(uint64_t a, uint64_t b) const {
        return gl_mul_wide_lazy(a, b);
    }
    GL_FN uint64_t sqr(uint64_t a) const { return gl_sqr_wide_lazy(a); }
};

// a^(2^k) by k squarings (lazy)
template <class Mul>
GL_HD uint64_t gl_sqr_n(uint64_t a, int k, Mul mul) {
    for (int i = 0; i < k; i++) a = mul.lazy(a, a);
    return a;
}

// Fermat inverse a^(p-2) by a fixed addition chain, 0 -> 0, lazy (any u64
// congruent to it): x_k = a^(2^k - 1) for k = 2, 4, 8, 16, 24, 28, 30, 31
// (x_{j+k} = x_j^(2^k) x_k), s = x_31^2 = a^(2^32 - 2), x_32 = s a, and
// then s^(2^32) x_32 = a^(2^64 - 2^33 + 2^32 - 1) = a^(p - 2): 63
// squarings and 10 products, against 125 products by square-and-multiply.
template <class Mul>
GL_HD uint64_t gl_inv_chain(uint64_t a, Mul mul) {
    const uint64_t x2 = mul.lazy(mul.lazy(a, a), a);
    const uint64_t x4 = mul.lazy(gl_sqr_n(x2, 2, mul), x2);
    const uint64_t x8 = mul.lazy(gl_sqr_n(x4, 4, mul), x4);
    const uint64_t x16 = mul.lazy(gl_sqr_n(x8, 8, mul), x8);
    const uint64_t x24 = mul.lazy(gl_sqr_n(x16, 8, mul), x8);
    const uint64_t x28 = mul.lazy(gl_sqr_n(x24, 4, mul), x4);
    const uint64_t x30 = mul.lazy(gl_sqr_n(x28, 2, mul), x2);
    const uint64_t x31 = mul.lazy(mul.lazy(x30, x30), a);
    const uint64_t s = mul.lazy(x31, x31);
    return mul.lazy(gl_sqr_n(s, 32, mul), mul.lazy(s, a));
}

GL_HD uint64_t gl_inv(uint64_t a) {
    return gl_canon(gl_inv_chain(a, gl_mul_fn()));
}

// -- cubic extension Fq3 = Fp[u]/(u^3 - 2) ----------------------------------
// In memory an Fq3 array keeps its components in three planes of the same
// length (fields/device.py: shape (..., 3, n)); gl3_load/gl3_store address
// element i of planes that lie `stride` elements apart.

struct gl3 {
    uint64_t c0, c1, c2;
};

GL_HD gl3 gl3_make(uint64_t c0, uint64_t c1, uint64_t c2) {
    gl3 r;
    r.c0 = c0; r.c1 = c1; r.c2 = c2;
    return r;
}

GL_HD gl3 gl3_from_base(uint64_t a) { return gl3_make(a, 0, 0); }

GL_HD gl3 gl3_load(const uint64_t* p, int64_t i, int64_t stride) {
    return gl3_make(p[i], p[stride + i], p[2 * stride + i]);
}

GL_HD void gl3_store(uint64_t* p, int64_t i, int64_t stride, gl3 a) {
    p[i] = a.c0; p[stride + i] = a.c1; p[2 * stride + i] = a.c2;
}

GL_HD gl3 gl3_add(gl3 a, gl3 b) {
    return gl3_make(gl_add(a.c0, b.c0), gl_add(a.c1, b.c1), gl_add(a.c2, b.c2));
}

GL_HD gl3 gl3_sub(gl3 a, gl3 b) {
    return gl3_make(gl_sub(a.c0, b.c0), gl_sub(a.c1, b.c1), gl_sub(a.c2, b.c2));
}

GL_HD gl3 gl3_neg(gl3 a) {
    return gl3_make(gl_neg(a.c0), gl_neg(a.c1), gl_neg(a.c2));
}

// Fq3 + Fp and Fq3 * Fp: the Fp operand is promoted to (b, 0, 0).
GL_HD gl3 gl3_add_base(gl3 a, uint64_t b) {
    return gl3_make(gl_add(a.c0, b), a.c1, a.c2);
}

GL_HD gl3 gl3_sub_base(gl3 a, uint64_t b) {
    return gl3_make(gl_sub(a.c0, b), a.c1, a.c2);
}

GL_HD gl3 gl3_mul_base(gl3 a, uint64_t b) {
    return gl3_make(gl_mul(a.c0, b), gl_mul(a.c1, b), gl_mul(a.c2, b));
}

// Karatsuba with u^3 = 2: six base products.
GL_HD gl3 gl3_mul(gl3 a, gl3 b) {
    uint64_t v0 = gl_mul(a.c0, b.c0), v1 = gl_mul(a.c1, b.c1),
             v2 = gl_mul(a.c2, b.c2);
    uint64_t t0 = gl_sub(gl_sub(gl_mul(gl_add(a.c1, a.c2), gl_add(b.c1, b.c2)),
                                v1), v2);
    uint64_t t1 = gl_sub(gl_sub(gl_mul(gl_add(a.c0, a.c1), gl_add(b.c0, b.c1)),
                                v0), v1);
    uint64_t t2 = gl_sub(gl_sub(gl_mul(gl_add(a.c0, a.c2), gl_add(b.c0, b.c2)),
                                v0), v2);
    return gl3_make(gl_add(v0, gl_add(t0, t0)), gl_add(t1, gl_add(v2, v2)),
                    gl_add(t2, v1));
}

// gl3_mul and gl3_mul_base on the carry-chain product (gl_mul_cc)
GL_HD gl3 gl3_mul_cc(gl3 a, gl3 b) {
    const uint64_t v0 = gl_mul_cc(a.c0, b.c0), v1 = gl_mul_cc(a.c1, b.c1),
                   v2 = gl_mul_cc(a.c2, b.c2);
    const uint64_t t0 = gl_sub(
        gl_sub(gl_mul_cc(gl_add(a.c1, a.c2), gl_add(b.c1, b.c2)), v1), v2);
    const uint64_t t1 = gl_sub(
        gl_sub(gl_mul_cc(gl_add(a.c0, a.c1), gl_add(b.c0, b.c1)), v0), v1);
    const uint64_t t2 = gl_sub(
        gl_sub(gl_mul_cc(gl_add(a.c0, a.c2), gl_add(b.c0, b.c2)), v0), v2);
    return gl3_make(gl_add(v0, gl_add(t0, t0)), gl_add(t1, gl_add(v2, v2)),
                    gl_add(t2, v1));
}

GL_HD gl3 gl3_mul_base_cc(gl3 a, uint64_t b) {
    return gl3_make(gl_mul_cc(a.c0, b), gl_mul_cc(a.c1, b), gl_mul_cc(a.c2, b));
}

GL_HD gl3 gl3_pow(gl3 base, uint64_t e) {
    gl3 acc = gl3_from_base(1);
    while (e) {
        if (e & 1) acc = gl3_mul(acc, base);
        base = gl3_mul(base, base);
        e >>= 1;
    }
    return acc;
}

// The norm map: v = gl3_adj(a) is the product of a's two conjugates (six
// products), N(a) = a * v = gl3_norm(a, v) lies in Fp (three more), and
// a^-1 = v / N(a).  N(a) = 0 only for a = 0.
template <class Mul>
GL_HD gl3 gl3_adj(gl3 a, Mul mul) {
    const uint64_t c12 = mul(a.c1, a.c2), c22 = mul(a.c2, a.c2);
    return gl3_make(gl_sub(mul(a.c0, a.c0), gl_add(c12, c12)),
                    gl_sub(gl_add(c22, c22), mul(a.c0, a.c1)),
                    gl_sub(mul(a.c1, a.c1), mul(a.c0, a.c2)));
}

template <class Mul>
GL_HD uint64_t gl3_norm(gl3 a, gl3 v, Mul mul) {
    const uint64_t s = gl_add(mul(a.c2, v.c1), mul(a.c1, v.c2));
    return gl_add(mul(a.c0, v.c0), gl_add(s, s));
}

// Norm-map inverse, one Fp inverse per element; 0 maps to 0.
GL_HD gl3 gl3_inv(gl3 a) {
    const gl3 v = gl3_adj(a, gl_mul_fn());
    return gl3_mul_base(v, gl_inv(gl3_norm(a, v, gl_mul_fn())));
}
