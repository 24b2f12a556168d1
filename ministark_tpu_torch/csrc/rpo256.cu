// Kernel G: batched RPO-256 permutations, Merkle row hashes and merges, and
// the proof-of-work grind of RPO-coin configurations.
//
// Replaces ministark_tpu/ops/rpo256_pallas.py `_rpo_kernel` (through
// `permute_lanes`, `hash_columns_lanes`, `merge_lanes` and
// `tree_levels_lanes_br`) and its use by ops/pow.py `_grind_rpo_batch`.
//
// Bound on the card: integer operations.  A permutation is 7 rounds of 12
// x (4 + 72) Goldilocks products (the x^7 S-box and the x^(1/7) chain) and
// two MDS layers of 144 small-constant multiply-adds, about 140,000 32-bit
// operations against at most 96 bytes of state in and 32 bytes out, so
// device memory is never the limit.  Design: one thread per hash instance,
// the 12-element state in registers as 12 u64 values (rpo256.cuh), the
// round constants in __constant__ memory (every thread of a warp reads the
// same one), no shared memory.  Inputs are read in place through
// (row, column) strides: the column-major trace (C, n) and an Fq3 matrix
// (C, 3, n) with row stride 1, FRI layer rows (n/N, N) with column stride
// 1, so neither is copied.  Digests are (n, 4) u64, state[4..8].
#include "launch.cuh"
#include "rpo256.cuh"

#define RPO_THREADS 128

// absorb C elements per row, RATE at a time (hash_rpo.hash_elements): when
// C % 8 != 0 the input is padded with one 1 and zeros, and capacity[0] = 1
__global__ void rpo_hash_rows_kernel(const uint64_t* __restrict__ x,
                                     uint64_t* __restrict__ out, int64_t n,
                                     int64_t ncols, int64_t rs, int64_t cs) {
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        uint64_t s[RPO_WIDTH];
#pragma unroll
        for (int k = 0; k < RPO_WIDTH; k++) s[k] = 0;
        s[0] = (ncols % RPO_RATE) ? 1 : 0;
        const uint64_t* row = x + i * rs;
        for (int64_t c0 = 0; c0 < ncols; c0 += RPO_RATE) {
#pragma unroll
            for (int k = 0; k < RPO_RATE; k++) {
                int64_t c = c0 + k;
                s[RPO_CAPACITY + k] = c < ncols ? row[c * cs]
                                    : (c == ncols ? 1 : 0);
            }
            rpo_permute(s);
        }
#pragma unroll
        for (int k = 0; k < RPO_DIGEST; k++)
            out[i * RPO_DIGEST + k] = s[RPO_CAPACITY + k];
    }
}

// Merkle merges: digest i of the next level absorbs left[i] || right[i]
__global__ void rpo_merge_kernel(const uint64_t* __restrict__ left,
                                 const uint64_t* __restrict__ right,
                                 uint64_t* __restrict__ out, int64_t n) {
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        uint64_t s[RPO_WIDTH];
#pragma unroll
        for (int k = 0; k < RPO_DIGEST; k++) {
            s[k] = 0;
            s[RPO_CAPACITY + k] = left[i * RPO_DIGEST + k];
            s[RPO_CAPACITY + RPO_DIGEST + k] = right[i * RPO_DIGEST + k];
        }
        rpo_permute(s);
#pragma unroll
        for (int k = 0; k < RPO_DIGEST; k++)
            out[i * RPO_DIGEST + k] = s[RPO_CAPACITY + k];
    }
}

// Proof of work: thread i tests nonce start + i, hashing
// [1, 0, 0, 0 | seed | lo32, hi32, 1, 0] (hash_rpo.merge_with_int), and
// atomicMins its index into *best when the digest has >= bits leading
// zeros.  lz, when given, receives every nonce's count (for the checks).
__global__ void rpo_grind_kernel(const uint64_t* __restrict__ seed,
                                 uint64_t start, int64_t n, int bits,
                                 int* __restrict__ best,
                                 int* __restrict__ lz) {
    uint64_t sd[RPO_DIGEST];
#pragma unroll
    for (int k = 0; k < RPO_DIGEST; k++) sd[k] = seed[k];
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        uint64_t nonce = start + (uint64_t)i;
        uint64_t s[RPO_WIDTH] = {1, 0, 0, 0, sd[0], sd[1], sd[2], sd[3],
                                 nonce & 0xFFFFFFFFULL, nonce >> 32, 1, 0};
        rpo_permute(s);
        int z = rpo_leading_zeros(s + RPO_CAPACITY);
        if (lz) lz[i] = z;
        if (z >= bits) atomicMin(best, (int)i);
    }
}

MS_API int ms_rpo_hash_rows(const uint64_t* x, uint64_t* out, int64_t n,
                            int64_t ncols, int64_t rs, int64_t cs,
                            cudaStream_t stream) {
    rpo_hash_rows_kernel<<<ms_blocks(n, RPO_THREADS), RPO_THREADS, 0,
                           stream>>>(x, out, n, ncols, rs, cs);
    return ms_last_error();
}

MS_API int ms_rpo_merge(const uint64_t* left, const uint64_t* right,
                        uint64_t* out, int64_t n, cudaStream_t stream) {
    rpo_merge_kernel<<<ms_blocks(n, RPO_THREADS), RPO_THREADS, 0, stream>>>(
        left, right, out, n);
    return ms_last_error();
}

MS_API int ms_rpo_grind(const uint64_t* seed, int64_t start, int64_t n,
                        int64_t bits, int* best, int* lz,
                        cudaStream_t stream) {
    rpo_grind_kernel<<<ms_blocks(n, RPO_THREADS), RPO_THREADS, 0, stream>>>(
        seed, (uint64_t)start, n, (int)bits, best, lz);
    return ms_last_error();
}
