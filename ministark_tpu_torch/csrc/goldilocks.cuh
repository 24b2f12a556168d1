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
#else
#define GL_HD static inline
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

GL_HD uint64_t gl_reduce128(uint64_t lo, uint64_t hi) {
    uint64_t hi_hi = hi >> 32;
    uint64_t hi_lo = hi & 0xFFFFFFFFULL;
    uint64_t t = lo - hi_hi;
    if (lo < hi_hi) t -= GL_EPS;               // borrow: -2^64 = -(2^32 - 1)
    uint64_t u = (hi_lo << 32) - hi_lo;        // hi_lo * (2^32 - 1)
    uint64_t r = t + u;
    if (r < t) r += GL_EPS;                    // carry: +2^64 = +(2^32 - 1)
    if (r >= GL_P) r -= GL_P;
    return r;
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

// Fermat inverse a^(p-2); 0 maps to 0.
GL_HD uint64_t gl_inv(uint64_t a) { return gl_pow(a, GL_P - 2); }

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

GL_HD gl3 gl3_pow(gl3 base, uint64_t e) {
    gl3 acc = gl3_from_base(1);
    while (e) {
        if (e & 1) acc = gl3_mul(acc, base);
        base = gl3_mul(base, base);
        e >>= 1;
    }
    return acc;
}

// Norm-map inverse: v = the product of a's two conjugates, N(a) = a * v is
// in Fp, a^-1 = v / N(a).  One Fp inverse per element; 0 maps to 0.
GL_HD gl3 gl3_inv(gl3 a) {
    uint64_t v0 = gl_sub(gl_mul(a.c0, a.c0), gl_add(gl_mul(a.c1, a.c2),
                                                    gl_mul(a.c1, a.c2)));
    uint64_t c22 = gl_mul(a.c2, a.c2);
    uint64_t v1 = gl_sub(gl_add(c22, c22), gl_mul(a.c0, a.c1));
    uint64_t v2 = gl_sub(gl_mul(a.c1, a.c1), gl_mul(a.c0, a.c2));
    uint64_t s = gl_add(gl_mul(a.c2, v1), gl_mul(a.c1, v2));
    uint64_t norm = gl_add(gl_mul(a.c0, v0), gl_add(s, s));
    return gl3_mul_base(gl3_make(v0, v1, v2), gl_inv(norm));
}
