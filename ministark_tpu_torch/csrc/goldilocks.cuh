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
