// Kernel C: batched tiled transpose of u64, (B, R, C) -> (B, C, R).
//
// Replaces ministark_tpu/ops/transpose_pallas.py `_tr2_kernel` (called
// through `transpose_mid` from ntt.py): the six-step NTT's move
// x[b, n1, n2] -> x[b, n2, n1] between its two column passes.
//
// Bound on the card: memory traffic, 16 bytes per element and no
// arithmetic.  Design: 32 x 32 tiles staged through shared memory with one
// column of padding (no bank conflicts on the transposed read), so both the
// load and the store are row-contiguous across a warp.  Edges of R and C
// that are not multiples of 32 are masked.
#include "goldilocks.cuh"
#include "launch.cuh"

#define TDIM 32
#define TROWS 8

__global__ void transpose_kernel(const uint64_t* __restrict__ x,
                                 uint64_t* __restrict__ y, int64_t R,
                                 int64_t C) {
    __shared__ uint64_t tile[TDIM][TDIM + 1];
    const int64_t b = blockIdx.z;
    const uint64_t* xb = x + b * R * C;
    uint64_t* yb = y + b * R * C;
    int64_t c = (int64_t)blockIdx.x * TDIM + threadIdx.x;
    int64_t r0 = (int64_t)blockIdx.y * TDIM;
    for (int k = threadIdx.y; k < TDIM; k += TROWS) {
        int64_t r = r0 + k;
        if (r < R && c < C) tile[k][threadIdx.x] = xb[r * C + c];
    }
    __syncthreads();
    int64_t r = r0 + threadIdx.x;
    int64_t c0 = (int64_t)blockIdx.x * TDIM;
    for (int k = threadIdx.y; k < TDIM; k += TROWS) {
        int64_t cc = c0 + k;
        if (cc < C && r < R) yb[cc * R + r] = tile[threadIdx.x][k];
    }
}

MS_API int ms_transpose(const uint64_t* x, uint64_t* y, int64_t B, int64_t R,
                        int64_t C, cudaStream_t stream) {
    dim3 grid((unsigned)((C + TDIM - 1) / TDIM),
              (unsigned)((R + TDIM - 1) / TDIM), (unsigned)B);
    dim3 block(TDIM, TROWS);
    if (B > 0 && R > 0 && C > 0)
        transpose_kernel<<<grid, block, 0, stream>>>(x, y, R, C);
    return ms_last_error();
}
