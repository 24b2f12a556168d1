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
// 128 KB of shared memory.
//
// Columns longer than 16384 rows do not fit shared memory; they take the
// multi-pass variant `ms_col_ntt_stage` at the end of this file.
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

// The multi-pass column NTT for n1 above the shared-memory tile (transforms
// of more than 2^28 points): one launch per pass over device memory.
//
// Replaces ministark_tpu/ops/ntt_pallas.py `_col_ntt_kernel`, which runs
// one butterfly stage per grid step.  Same function as col_ntt_kernel:
// stage 0 gathers x's rows bit-reversed into y (times pre), stages
// 1..log2(n1) each run one radix-2 DIT stage in place on y with twiddle
// tw[j * (n1 >> stage)], and the last stage multiplies by tmat.
//
// Bound on the card: integer operations for the least work (a multiply and
// two adds per butterfly, log2(n1) stages, against one read and one write
// of every element), but this kernel makes log2(n1) + 1 passes over device
// memory at 16 bytes an element each, so its passes, not its arithmetic,
// set its time.  Design: one thread per butterfly, the column index
// fastest, so a warp's loads are contiguous row segments; simple and right
// first (a later kernel can keep several stages in shared memory per pass).
__global__ void col_ntt_stage_kernel(const uint64_t* __restrict__ x,
                                     uint64_t* __restrict__ y,
                                     const uint64_t* __restrict__ tw,
                                     const uint64_t* __restrict__ pre,
                                     const uint64_t* __restrict__ tmat,
                                     int64_t B, int64_t n1, int64_t C,
                                     int log_n1, int stage) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (stage == 0) {
        for (; k < B * n1 * C; k += stride) {
            int64_t q = k / C, c = k - q * C;
            int64_t r = q & (n1 - 1), b = q >> log_n1;
            int64_t src = bitrev((uint32_t)r, log_n1);
            uint64_t v = x[(b * n1 + src) * C + c];
            if (pre) v = gl_mul(v, pre[src * C + c]);
            if (log_n1 == 0 && tmat) v = gl_mul(v, tmat[c]);
            y[k] = v;
        }
        return;
    }
    const int64_t half = 1LL << (stage - 1);
    const int64_t tstride = n1 >> stage;
    const bool last = stage == log_n1 && tmat != nullptr;
    for (; k < B * (n1 >> 1) * C; k += stride) {
        int64_t q = k / C, c = k - q * C;
        int64_t bf = q & ((n1 >> 1) - 1), b = q >> (log_n1 - 1);
        int64_t j = bf & (half - 1);
        int64_t i0 = ((bf - j) << 1) + j, i1 = i0 + half;
        uint64_t* yb = y + b * n1 * C;
        uint64_t u = yb[i0 * C + c];
        uint64_t v = gl_mul(yb[i1 * C + c], tw[j * tstride]);
        uint64_t lo = gl_add(u, v), hi = gl_sub(u, v);
        if (last) {
            lo = gl_mul(lo, tmat[i0 * C + c]);
            hi = gl_mul(hi, tmat[i1 * C + c]);
        }
        yb[i0 * C + c] = lo;
        yb[i1 * C + c] = hi;
    }
}

MS_API int ms_col_ntt_stage(const uint64_t* x, uint64_t* y,
                            const uint64_t* tw, const uint64_t* pre,
                            const uint64_t* tmat, int64_t B, int64_t n1,
                            int64_t C, int64_t log_n1, int64_t stage,
                            cudaStream_t stream) {
    int64_t work = stage == 0 ? B * n1 * C : B * (n1 >> 1) * C;
    col_ntt_stage_kernel<<<ms_blocks(work, 256), 256, 0, stream>>>(
        x, y, tw, pre, tmat, B, n1, C, (int)log_n1, (int)stage);
    return ms_last_error();
}
