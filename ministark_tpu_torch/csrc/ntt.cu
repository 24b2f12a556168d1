// Kernel B: batched column NTTs in shared memory (the six-step building
// block).
//
// Replaces ministark_tpu/ops/ntt_pallas.py `_col_ntt_kernel_unrolled`
// (called through `col_ntt` from ntt.py's six-step pipeline).
//
// Computes, for each batch b and column c of x viewed as (B, n1, C):
//   load rows in bit-reversed order (optionally times pre[row, c]),
//   run all log2(n1) radix-2 DIT stages with twiddles tw[k] = w^k, k < n1/2,
//   store canonical values (optionally times tmat[row, c]).
// `pre` and `tmat` are (n1, C) tables shared by every batch: the coset
// scale before the first pass, the six-step twiddle matrix after it, and
// the inverse transform's 1/n * offset^-i after the second pass.
//
// Bound on the card: integer operations, narrowly.  A transform of n points
// does ~n/2 log2(n) Goldilocks multiplies against 16n bytes of device
// traffic for each pass, a few operations per byte (chip_smoke.py's model:
// 1.7 ms of operations against 0.6 ms of traffic for the 8-column
// 2^23-point LDE).  Design: a block owns TC
// contiguous columns for all n1 rows, so the data crosses device memory once
// per pass, every stage runs in shared memory, and each row load is a
// contiguous TC * 8-byte segment.  TC is chosen so the tile fills up to
// 128 KB of shared memory; n1 above 16384 raises in the wrapper.
#include "goldilocks.cuh"
#include "launch.cuh"

static __device__ __forceinline__ uint32_t bitrev(uint32_t i, int bits) {
    return bits == 0 ? 0 : (__brev(i) >> (32 - bits));
}

__global__ void col_ntt_kernel(const uint64_t* __restrict__ x,
                               uint64_t* __restrict__ y,
                               const uint64_t* __restrict__ tw,
                               const uint64_t* __restrict__ pre,
                               const uint64_t* __restrict__ tmat,
                               int64_t n1, int64_t C, int log_n1, int TC) {
    extern __shared__ uint64_t s[];
    const int64_t b = blockIdx.y;
    const int64_t c0 = (int64_t)blockIdx.x * TC;
    const uint64_t* xb = x + b * n1 * C;
    uint64_t* yb = y + b * n1 * C;
    const int64_t tile = n1 * TC;

    for (int64_t k = threadIdx.x; k < tile; k += blockDim.x) {
        int64_t r = k / TC, cc = k % TC;
        int64_t src = bitrev((uint32_t)r, log_n1);
        uint64_t v = xb[src * C + c0 + cc];
        if (pre) v = gl_mul(v, pre[src * C + c0 + cc]);
        s[k] = v;
    }
    __syncthreads();

    for (int st = 1; st <= log_n1; st++) {
        const int64_t half = 1LL << (st - 1);
        const int64_t tstride = n1 >> st;
        for (int64_t k = threadIdx.x; k < (n1 >> 1) * TC; k += blockDim.x) {
            int64_t bf = k / TC, cc = k % TC;
            int64_t j = bf & (half - 1);
            int64_t i0 = ((bf - j) << 1) + j;
            uint64_t w = tw[j * tstride];
            uint64_t u = s[i0 * TC + cc];
            uint64_t v = gl_mul(s[(i0 + half) * TC + cc], w);
            s[i0 * TC + cc] = gl_add(u, v);
            s[(i0 + half) * TC + cc] = gl_sub(u, v);
        }
        __syncthreads();
    }

    for (int64_t k = threadIdx.x; k < tile; k += blockDim.x) {
        int64_t r = k / TC, cc = k % TC;
        uint64_t v = s[k];
        if (tmat) v = gl_mul(v, tmat[r * C + c0 + cc]);
        yb[r * C + c0 + cc] = v;
    }
}

MS_API int ms_col_ntt(const uint64_t* x, uint64_t* y, const uint64_t* tw,
                      const uint64_t* pre, const uint64_t* tmat, int64_t B,
                      int64_t n1, int64_t C, int64_t log_n1, int64_t TC,
                      cudaStream_t stream) {
    size_t smem = (size_t)(n1 * TC) * sizeof(uint64_t);
    cudaError_t e = cudaFuncSetAttribute(
        col_ntt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((unsigned)(C / TC), (unsigned)B);
    col_ntt_kernel<<<grid, 256, smem, stream>>>(x, y, tw, pre, tmat, n1, C,
                                                (int)log_n1, (int)TC);
    return ms_last_error();
}
