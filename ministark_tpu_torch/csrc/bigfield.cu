// Big prime field vectors on the card: the elementwise Montgomery product
// and the coset NTT over the 128- and 252-bit primes (and any other odd
// modulus of 2 or 4 u64 limbs), as (L, n) arrays of u64 limbs (L = 2 or 4;
// limb k of element i at k * n + i).  The math and the NTT's schedule are
// bigfield.cuh's.
//
// Replaces ministark_tpu/fields/bigvec.py `BigField.mul` (bigvec.py:155,
// CIOS over 16-bit limbs in uint32, XLA) and `BigDomain._transform`
// (bigvec.py:283, one XLA program a stage), which the JAX package runs as
// plain jnp; R = 2^(64 L) = 2^(16 L16) as there, so the Montgomery values
// are the same.
//
// Bound on the card: integer operations (a product is 2 W^2 word products
// and one row a top word of the prime; an NTT of n points (n/2) log2 n
// butterflies, each a product, a sum and a difference) against 16 L n
// bytes in and out.  Design:
//  - the product runs over 32-bit words in PTX carry chains, specialised to
//    each named prime's nonzero words at compile time (BigSparse), CIOS for
//    any other modulus (BigGeneric); the launch picks by the modulus'
//    description;
//  - big_mul: two neighbouring elements a thread through 16-byte loads and
//    stores of each limb plane (n even, planes 16-byte aligned), else one;
//    the second operand of stride 0 or 1 (a scalar or a vector);
//  - big_ntt: a Stockham transform of passes of up to 2^9 points a group
//    (2^18 points: two launches), a block C >= 4 neighbouring groups so each
//    warp reads and writes whole sectors, the groups' DFTs in registers
//    (radix-2 and -4 rounds, 4 values a thread: 2^16 threads at 2^18
//    points, as many warps as the carry chains' latency wants) exchanging
//    through shared memory; Fp252's values held below 4p between
//    butterflies;
//    coset powers folded into the first pass, offset^-i n^-1 into the last;
//    twiddles from one table read in the threads' order (BigDomain builds
//    it from tw once per domain and device: ms_big_ntt_table lists its
//    exponents).
#include "bigfield.cuh"
#include "launch.cuh"

#define BIG_THREADS 256
#define BIG_NTT_POINTS 2048  // a block's points: 2048 / R groups of R
#define BIG_NTT_THREADS (BIG_NTT_POINTS / BIG_NTT_V)

template <class F, bool PAIR>
__global__ void __launch_bounds__(BIG_THREADS)
big_mul_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
               uint64_t* __restrict__ out, int64_t n, int64_t b_stride,
               const __grid_constant__ F f) {
    constexpr int W = F::W, L = W / 2;
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (PAIR) {
        uint32_t y[2][W];
        if (!b_stride) {
            big_ld<W>(b, 1, 0, y[0]);
#pragma unroll
            for (int j = 0; j < W; j++) y[1][j] = y[0][j];
        }
        for (; e < n / 2; e += step) {
            uint32_t x[2][W];
#pragma unroll
            for (int k = 0; k < L; k++) {
                const ulonglong2 p = __ldg((const ulonglong2*)(a + k * n) + e);
                x[0][2 * k] = (uint32_t)p.x;
                x[0][2 * k + 1] = (uint32_t)(p.x >> 32);
                x[1][2 * k] = (uint32_t)p.y;
                x[1][2 * k + 1] = (uint32_t)(p.y >> 32);
                if (b_stride) {
                    const ulonglong2 q =
                        __ldg((const ulonglong2*)(b + k * n) + e);
                    y[0][2 * k] = (uint32_t)q.x;
                    y[0][2 * k + 1] = (uint32_t)(q.x >> 32);
                    y[1][2 * k] = (uint32_t)q.y;
                    y[1][2 * k + 1] = (uint32_t)(q.y >> 32);
                }
            }
            f.mul(x[0], y[0], x[0]);
            f.mul(x[1], y[1], x[1]);
#pragma unroll
            for (int k = 0; k < L; k++) {
                ulonglong2 p;
                p.x = (uint64_t)x[0][2 * k] | (uint64_t)x[0][2 * k + 1] << 32;
                p.y = (uint64_t)x[1][2 * k] | (uint64_t)x[1][2 * k + 1] << 32;
                ((ulonglong2*)(out + k * n))[e] = p;
            }
        }
    } else {
        for (; e < n; e += step) {
            uint32_t x[W], y[W];
            big_ld<W>(a, n, e, x);
            big_ld<W>(b, b_stride ? n : 1, e * b_stride, y);
            f.mul(x, y, x);
            big_st<W>(out, n, e, x);
        }
    }
}

// one pass of the transform (bigfield.cuh's schedule): a block C groups,
// R / V threads a group; at least one block an SM, so a thread may take 128
// registers (left to itself ptxas gives Fp252's 84, and 6% more time)
template <class F, int V>
__global__ void __launch_bounds__(BIG_NTT_THREADS, 1)
big_ntt_pass_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                    const uint64_t* __restrict__ tab, int64_t ntab,
                    const uint64_t* __restrict__ sf,
                    const uint64_t* __restrict__ sl,
                    const __grid_constant__ BigNttPass ps,
                    const __grid_constant__ F f) {
    extern __shared__ uint64_t sm[];
    const int col = threadIdx.x % ps.cols, t = threadIdx.x / ps.cols;
    const int64_t j = (int64_t)blockIdx.x * ps.cols + col;
    uint32_t v[V][F::W];
    big_ntt_load<F, V>(f, ps, x, sf, tab, ntab, j, t, v);
    for (int b = 0; b < ps.nrounds; b++) {
        if (b > 0) {
            if (b > 1) __syncthreads();  // the last round's reads are done
            big_ntt_put<F, V>(ps, b - 1, sm, col, t, v);
            __syncthreads();
            big_ntt_get<F, V>(ps, sm, col, t, v);
        }
        big_ntt_round<F, V>(f, ps, b, tab, ntab, t, v);
    }
    big_ntt_store<F, V>(f, ps, y, sl, j, t, v);
}

// 2^(log_n + 1) > n >= 2^log_n
static int big_log2(int64_t n) {
    int log_n = 0;
    while (((int64_t)1 << (log_n + 1)) <= n) log_n++;
    return log_n;
}

template <class F, int V>
static int big_ntt_run(const F& f, const BigNttPlan& pl, const uint64_t* x,
                       uint64_t* y, uint64_t* tmp, const uint64_t* tab,
                       int64_t ntab, const uint64_t* sf, const uint64_t* sl,
                       cudaStream_t stream) {
    constexpr int L = F::W / 2;
    constexpr size_t max_smem =
        (size_t)L * 8 * (BIG_NTT_POINTS + BIG_NTT_POINTS / 8);
    static bool smem_set[MS_MAX_DEVICES];
    const int rc = ms_smem_limit(big_ntt_pass_kernel<F, V>, max_smem,
                                 smem_set);
    if (rc) return rc;
    const uint64_t* in = x;
    for (int q = 0; q < pl.passes; q++) {
        BigNttPass ps = pl.pass[q];
        const int64_t R = (int64_t)1 << ps.log_r, groups = ps.n / R;
        const int64_t cols = big_ntt_cols(ps, BIG_NTT_POINTS);
        ps.cols = (int)cols;
        const size_t smem = (size_t)L * 8 * big_plane(ps);
        uint64_t* out = (pl.passes - 1 - q) % 2 == 0 ? y : tmp;
        big_ntt_pass_kernel<F, V>
            <<<(unsigned)(groups / cols), (unsigned)(cols * (R / V)), smem,
               stream>>>(in, out, tab, ntab, q == 0 ? sf : nullptr,
                         q == pl.passes - 1 ? sl : nullptr, ps, f);
        const int rc = ms_last_error();
        if (rc) return rc;
        in = out;
    }
    return 0;
}

template <class F>
static int big_ntt_field(const F& f, const uint64_t* x, uint64_t* y,
                         uint64_t* tmp, const uint64_t* tab, int64_t ntab,
                         const uint64_t* sf, const uint64_t* sl, int64_t n,
                         cudaStream_t stream) {
    BigNttPlan pl;
    big_ntt_plan(big_log2(n), pl, nullptr);
    if (ntab != pl.table || (pl.passes > 1 && !tmp))
        return (int)cudaErrorInvalidValue;
    switch (pl.pass[0].v) {
        case 4: return big_ntt_run<F, 4>(f, pl, x, y, tmp, tab, ntab, sf, sl, stream);
        case 2: return big_ntt_run<F, 2>(f, pl, x, y, tmp, tab, ntab, sf, sl, stream);
        default: return big_ntt_run<F, 1>(f, pl, x, y, tmp, tab, ntab, sf, sl, stream);
    }
}

template <class F>
static int big_mul_field(const F& f, const uint64_t* a, const uint64_t* b,
                         uint64_t* out, int64_t n, int64_t b_stride,
                         cudaStream_t stream) {
    const uintptr_t align = (uintptr_t)a | (uintptr_t)out
                            | (b_stride ? (uintptr_t)b : 0);
    if (n % 2 == 0 && align % 16 == 0)
        big_mul_kernel<F, true><<<ms_blocks(n / 2, BIG_THREADS), BIG_THREADS,
                                  0, stream>>>(a, b, out, n, b_stride, f);
    else
        big_mul_kernel<F, false><<<ms_blocks(n, BIG_THREADS), BIG_THREADS, 0,
                                   stream>>>(a, b, out, n, b_stride, f);
    return ms_last_error();
}

// out = a * b * R^-1 elementwise over (L, n) limb arrays; b is (L, n)
// (b_stride 1) or one element (b_stride 0); mod: the modulus' L limbs and
// n0inv, on the host
MS_API int ms_big_mul(const uint64_t* a, const uint64_t* b, uint64_t* out,
                      int64_t n, int64_t b_stride, const uint64_t* mod,
                      int64_t L, cudaStream_t stream) {
    if (n <= 0) return 0;
    const int rc = big_dispatch(mod, L, [&](auto f) {
        return big_mul_field(f, a, b, out, n, b_stride, stream);
    });
    return rc < 0 ? (int)cudaErrorInvalidValue : rc;
}

// y = the transform of x (n a power of two, (L, n) limb arrays, natural
// order in and out) with the twiddle table tab ((L, ntab): the entries
// ms_big_ntt_table lists, from tw = w^j); tmp: (L, n) scratch where the
// transform takes more than one pass (ms_big_ntt_passes); scale_first
// (forward coset: offset^i) multiplies x first, scale_last (inverse:
// offset^-i n^-1) the result; either may be null
MS_API int ms_big_ntt(const uint64_t* x, uint64_t* y, uint64_t* tmp,
                      const uint64_t* tab, int64_t ntab,
                      const uint64_t* scale_first, const uint64_t* scale_last,
                      int64_t n, const uint64_t* mod, int64_t L,
                      cudaStream_t stream) {
    if (n < 1 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
    const int rc = big_dispatch(mod, L, [&](auto f) {
        return big_ntt_field(f, x, y, tmp, tab, ntab, scale_first, scale_last,
                             n, stream);
    });
    return rc < 0 ? (int)cudaErrorInvalidValue : rc;
}

// the exponents e of the twiddle table's entries w^e for a 2^log_n-point
// transform, written to exps where it is not null; returns their count
MS_API int64_t ms_big_ntt_table(int64_t log_n, int64_t* exps) {
    BigNttPlan pl;
    big_ntt_plan((int)log_n, pl, exps);
    return pl.table;
}

MS_API int64_t ms_big_ntt_passes(int64_t log_n) {
    BigNttPlan pl;
    big_ntt_plan((int)log_n, pl, nullptr);
    return pl.passes;
}
