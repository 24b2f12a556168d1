// Kernel C: batched tiled transpose of u64, (B, R, C) -> (B, C, R).
//
// Replaces ministark_tpu/ops/transpose_pallas.py `_tr2_kernel` (called
// through `transpose_mid` from ntt.py): the six-step NTT's move
// x[b, n1, n2] -> x[b, n2, n1] between its two column passes.
//
// Bound on the card: memory traffic, 16 bytes per element and no
// arithmetic.  At the small transforms of a short trace (2^15 points) the
// whole move is a few MB, so what counts there is how few instructions and
// round trips each block needs.  Design, for R a multiple of 32 and C of 64
// (every six-step shape of at least 2^11 points):
//  - 32 x 64 tiles (rows x columns of x), 128 threads; every global access
//    is 16 bytes (`ulonglong2`): a warp loads 512 contiguous bytes of a row
//    (two adjacent columns a thread), and a half-warp stores 256 contiguous
//    bytes of a column (two adjacent rows a thread);
//  - each thread loads the 2 x 2 block of rows 2p, 2p+1 and columns c, c+1
//    and keeps it in shared memory as two 16-byte pairs, (x[2p][c],
//    x[2p+1][c]) in slot [c][p], so the store phase reads one 16-byte pair
//    per output access; the slot index p is XORed with (c / 2) mod 8, which
//    keeps both phases free of bank conflicts;
//  - no masks: full tiles only; the batch, the row tiles and the column
//    tiles are one grid dimension, so no grid limit caps B or R.
// Of the tile shapes tried on an H100 (64 x 64 with 256 or 512 threads,
// 32 x 64 with 256, streaming stores), this one was the fastest at the
// large shapes.
// Other shapes (ragged R or C, or an input not 16-byte aligned) take the
// 32 x 32 tile kernel below, masked at the edges, with the same
// one-dimensional grid.
#include "goldilocks.cuh"
#include "launch.cuh"

#define TR 32     // tile rows of the 16-byte path
#define TC 64     // tile columns of the 16-byte path
#define TDIM 32   // tile edge of the masked path
#define TROWS 8

__global__ void __launch_bounds__(128)
transpose_tiles_kernel(const ulonglong2* __restrict__ x,
                       ulonglong2* __restrict__ y, int64_t R, int64_t C,
                       unsigned tiles_c, unsigned tiles_r) {
    __shared__ ulonglong2 tile[TC][TR / 2];
    const unsigned tc = blockIdx.x % tiles_c, rest = blockIdx.x / tiles_c;
    const unsigned tr = rest % tiles_r, b = rest / tiles_r;
    const int64_t r0 = (int64_t)tr * TR, c0 = (int64_t)tc * TC;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // in 16-byte units: row r of x starts at r * C / 2, row c of y at
    // c * R / 2
    const ulonglong2* xb = x + (int64_t)b * R * C / 2;
    ulonglong2* yb = y + (int64_t)b * R * C / 2;

    ulonglong2 a[4], d[4];  // row pairs warp, warp + 4, ... of the tile
#pragma unroll
    for (int i = 0; i < 4; i++) {
        const int64_t r = r0 + 2 * (warp + 4 * i);
        a[i] = xb[(r * C + c0) / 2 + lane];
        d[i] = xb[((r + 1) * C + c0) / 2 + lane];
    }
#pragma unroll
    for (int i = 0; i < 4; i++) {
        const int p = (warp + 4 * i) ^ (lane & 7);
        tile[2 * lane][p] = make_ulonglong2(a[i].x, d[i].x);
        tile[2 * lane + 1][p] = make_ulonglong2(a[i].y, d[i].y);
    }
    __syncthreads();
    const int p = lane & 15;  // a half-warp per column
#pragma unroll
    for (int i = 0; i < 8; i++) {
        const int c = 2 * (warp + 4 * i) + (lane >> 4);
        yb[((c0 + c) * R + r0) / 2 + p] = tile[c][p ^ ((c >> 1) & 7)];
    }
}

__global__ void transpose_kernel(const uint64_t* __restrict__ x,
                                 uint64_t* __restrict__ y, int64_t R,
                                 int64_t C, unsigned tiles_c,
                                 unsigned tiles_r) {
    __shared__ uint64_t tile[TDIM][TDIM + 1];
    const unsigned tc = blockIdx.x % tiles_c, rest = blockIdx.x / tiles_c;
    const unsigned tr = rest % tiles_r, b = rest / tiles_r;
    const uint64_t* xb = x + (int64_t)b * R * C;
    uint64_t* yb = y + (int64_t)b * R * C;
    int64_t c = (int64_t)tc * TDIM + threadIdx.x;
    int64_t r0 = (int64_t)tr * TDIM;
    for (int k = threadIdx.y; k < TDIM; k += TROWS) {
        int64_t r = r0 + k;
        if (r < R && c < C) tile[k][threadIdx.x] = xb[r * C + c];
    }
    __syncthreads();
    int64_t r = r0 + threadIdx.x;
    int64_t c0 = (int64_t)tc * TDIM;
    for (int k = threadIdx.y; k < TDIM; k += TROWS) {
        int64_t cc = c0 + k;
        if (cc < C && r < R) yb[cc * R + r] = tile[threadIdx.x][k];
    }
}

MS_API int ms_transpose(const uint64_t* x, uint64_t* y, int64_t B, int64_t R,
                        int64_t C, cudaStream_t stream) {
    if (B <= 0 || R <= 0 || C <= 0) return ms_last_error();
    const bool full = R % TR == 0 && C % TC == 0 &&
                      ((uintptr_t)x | (uintptr_t)y) % 16 == 0;
    const int64_t tiles_c = full ? C / TC : (C + TDIM - 1) / TDIM;
    const int64_t tiles_r = full ? R / TR : (R + TDIM - 1) / TDIM;
    const int64_t blocks = B * tiles_r * tiles_c;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
    if (full)
        transpose_tiles_kernel<<<(unsigned)blocks, 128, 0, stream>>>(
            (const ulonglong2*)x, (ulonglong2*)y, R, C, (unsigned)tiles_c,
            (unsigned)tiles_r);
    else
        transpose_kernel<<<(unsigned)blocks, dim3(TDIM, TROWS), 0, stream>>>(
            x, y, R, C, (unsigned)tiles_c, (unsigned)tiles_r);
    return ms_last_error();
}
