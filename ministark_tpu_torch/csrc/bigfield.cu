// Big prime field vectors on the card: the elementwise Montgomery product
// and the radix-2 coset NTT over the 128- and 252-bit primes, as (L, n)
// arrays of u64 limbs (L = 2 or 4; limb k of element i at k * n + i).
// The math is bigfield.cuh's.
//
// Replaces ministark_tpu/fields/bigvec.py `BigField.mul` (bigvec.py:155,
// CIOS over 16-bit limbs in uint32, XLA) and `BigDomain._transform`
// (bigvec.py:283, one XLA program a stage), which the JAX package runs as
// plain jnp; on Hopper 64-bit limbs take the place of the TPU's 16-bit
// split, with the same R = 2^(64 L) = 2^(16 L16), so the Montgomery
// values are the same.
//
// Bound on the card: integer operations.  A product is 2 L^2 + L word
// products (CIOS) and a conditional subtraction; an NTT of n points is
// (n/2) log2 n butterflies, each a product, an add and a sub, against
// 16 L n bytes in and out.  Design, simple first: big_mul is one element
// a thread, its second operand of stride 0 or 1 (a scalar or a vector);
// big_ntt's first launch gathers a tile of NTT_TILE points in
// bit-reversed order (times the coset's powers for a forward coset
// transform) into shared memory and runs the stages whose span fits the
// tile there, then one launch a remaining stage does one butterfly a
// thread in place; the inverse's offset^-i n^-1 is folded into the
// launch that runs the last stage.
#include "bigfield.cuh"
#include "launch.cuh"

#define BIG_THREADS 256
#define NTT_TILE 1024  // points a block of the first launch takes

template <int L>
__global__ void __launch_bounds__(BIG_THREADS)
big_mul_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
               uint64_t* __restrict__ out, int64_t n, int64_t b_stride,
               const __grid_constant__ BigMod<L> m) {
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        uint64_t x[L], y[L], z[L];
        big_load<L>(a, n, i, x);
        const int64_t bn = b_stride ? n : 1;
        big_load<L>(b, bn, i * b_stride, y);
        big_mont_mul<L>(x, y, m, z);
        big_store<L>(out, n, i, z);
    }
}

// One block a tile of T points (T = min(n, NTT_TILE), T/2 threads, one
// butterfly a thread and stage): y[i] = x[bitrev(i)] (times
// scale_first[bitrev(i)] where given), the stages of span 2 .. T, then
// times scale_last[i] where given (when they were the last stages).
template <int L>
__global__ void __launch_bounds__(NTT_TILE / 2)
big_ntt_tile_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                    const uint64_t* __restrict__ tw,
                    const uint64_t* __restrict__ scale_first,
                    const uint64_t* __restrict__ scale_last, int64_t n,
                    int log_n, int64_t T, const __grid_constant__ BigMod<L> m) {
    __shared__ uint64_t sm[NTT_TILE][L];
    const int64_t base = blockIdx.x * T;
    const int64_t half = T / 2 > 0 ? T / 2 : 1;
    for (int64_t idx = threadIdx.x; idx < T; idx += half) {
        const int64_t src = big_bitrev(base + idx, log_n);
        uint64_t v[L];
        big_load<L>(x, n, src, v);
        if (scale_first) {
            uint64_t s[L];
            big_load<L>(scale_first, n, src, s);
            big_mont_mul<L>(v, s, m, v);
        }
#pragma unroll
        for (int k = 0; k < L; k++) sm[idx][k] = v[k];
    }
    __syncthreads();
    for (int64_t span = 2; span <= T; span *= 2) {
        int64_t i0, i1, ti;
        big_stage_pair(threadIdx.x, span, n, i0, i1, ti);
        uint64_t w[L];
        big_load<L>(tw, n / 2, ti, w);
        big_butterfly<L>(sm[i0], sm[i1], w, m);
        __syncthreads();
    }
    for (int64_t idx = threadIdx.x; idx < T; idx += half) {
        uint64_t v[L];
#pragma unroll
        for (int k = 0; k < L; k++) v[k] = sm[idx][k];
        if (scale_last) {
            uint64_t s[L];
            big_load<L>(scale_last, n, base + idx, s);
            big_mont_mul<L>(v, s, m, v);
        }
        big_store<L>(y, n, base + idx, v);
    }
}

// One stage of span m > NTT_TILE in place on y, one butterfly a thread;
// times scale_last at both outputs where given (the last stage).
template <int L>
__global__ void __launch_bounds__(BIG_THREADS)
big_ntt_stage_kernel(uint64_t* __restrict__ y, const uint64_t* __restrict__ tw,
                     const uint64_t* __restrict__ scale_last, int64_t n,
                     int64_t span, const __grid_constant__ BigMod<L> m) {
    for (int64_t k = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
         k < n / 2; k += (int64_t)gridDim.x * blockDim.x) {
        int64_t i0, i1, ti;
        big_stage_pair(k, span, n, i0, i1, ti);
        uint64_t u[L], v[L], w[L];
        big_load<L>(y, n, i0, u);
        big_load<L>(y, n, i1, v);
        big_load<L>(tw, n / 2, ti, w);
        big_butterfly<L>(u, v, w, m);
        if (scale_last) {
            uint64_t s[L];
            big_load<L>(scale_last, n, i0, s);
            big_mont_mul<L>(u, s, m, u);
            big_load<L>(scale_last, n, i1, s);
            big_mont_mul<L>(v, s, m, v);
        }
        big_store<L>(y, n, i0, u);
        big_store<L>(y, n, i1, v);
    }
}

template <int L>
static int big_mul_launch(const uint64_t* a, const uint64_t* b, uint64_t* out,
                          int64_t n, int64_t b_stride, const uint64_t* mod,
                          cudaStream_t stream) {
    if (n > 0)
        big_mul_kernel<L><<<ms_blocks(n, BIG_THREADS), BIG_THREADS, 0,
                            stream>>>(a, b, out, n, b_stride,
                                      big_mod_from<L>(mod));
    return ms_last_error();
}

template <int L>
static int big_ntt_launch(const uint64_t* x, uint64_t* y, const uint64_t* tw,
                          const uint64_t* scale_first,
                          const uint64_t* scale_last, int64_t n,
                          const uint64_t* mod, cudaStream_t stream) {
    int log_n = 0;
    while ((int64_t)1 << log_n < n) log_n++;
    const BigMod<L> m = big_mod_from<L>(mod);
    const int64_t T = n < NTT_TILE ? n : NTT_TILE;
    const bool tile_last = T == n;
    big_ntt_tile_kernel<L><<<(unsigned)(n / T), (unsigned)(T > 1 ? T / 2 : 1),
                             0, stream>>>(x, y, tw, scale_first,
                                          tile_last ? scale_last : nullptr,
                                          n, log_n, T, m);
    for (int64_t span = 2 * T; span <= n; span *= 2) {
        const int rc = ms_last_error();
        if (rc) return rc;
        big_ntt_stage_kernel<L><<<ms_blocks(n / 2, BIG_THREADS), BIG_THREADS,
                                  0, stream>>>(
            y, tw, span == n ? scale_last : nullptr, n, span, m);
    }
    return ms_last_error();
}

// out = a * b * R^-1 elementwise over (L, n) limb arrays; b is (L, n)
// (b_stride 1) or one element (b_stride 0); mod: the modulus' L limbs and
// n0inv, on the host
MS_API int ms_big_mul(const uint64_t* a, const uint64_t* b, uint64_t* out,
                      int64_t n, int64_t b_stride, const uint64_t* mod,
                      int64_t L, cudaStream_t stream) {
    if (L == 2) return big_mul_launch<2>(a, b, out, n, b_stride, mod, stream);
    if (L == 4) return big_mul_launch<4>(a, b, out, n, b_stride, mod, stream);
    return (int)cudaErrorInvalidValue;
}

// y = the radix-2 transform of x (n a power of two, (L, n) limb arrays,
// natural order in and out) with twiddles tw = w^j, j < n/2 ((L, n/2));
// scale_first (forward coset: offset^i) multiplies x first, scale_last
// (inverse: offset^-i n^-1) the result; either may be null
MS_API int ms_big_ntt(const uint64_t* x, uint64_t* y, const uint64_t* tw,
                      const uint64_t* scale_first,
                      const uint64_t* scale_last, int64_t n,
                      const uint64_t* mod, int64_t L, cudaStream_t stream) {
    if (n < 1 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
    if (L == 2)
        return big_ntt_launch<2>(x, y, tw, scale_first, scale_last, n, mod,
                                 stream);
    if (L == 4)
        return big_ntt_launch<4>(x, y, tw, scale_first, scale_last, n, mod,
                                 stream);
    return (int)cudaErrorInvalidValue;
}
