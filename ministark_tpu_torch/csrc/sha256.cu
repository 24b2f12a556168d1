// Kernel D: batched SHA-256, one message per thread: Merkle row digests of
// Goldilocks rows, 64-byte Merkle merges, the levels of a tree near its
// root in one launch, and the proof-of-work grind of SHA-256 coins.
//
// Replaces ministark_tpu/ops/sha256_pallas.py `_sha_kernel` (wrappers
// `hash_rows_fp_lanes` and `merge_lanes`), through ops/sha256.py
// `hash_rows_ext3` the wrapper `hash_rows_ext3_lanes` (sha256_pallas.py:171):
// a (C, 3, n) Fq3 matrix read with row stride 1 and element stride n is a
// row of 3C elements, each Fq3 value serialized as c0 || c1 || c2; the
// tree loop `build_tree_levels_lanes` (sha256_pallas.py:190) for the levels
// of at most 512 nodes (`ms_sha_tree_tops`); and the JAX package's device
// grind, ministark_tpu/ops/pow.py `_grind_batch` over ops/sha256.py
// `merge_with_int_words` (XLA there, `ms_sha_grind` here).
//
// Row digests follow hash.py `hash_elements`: the message is the row's
// elements, 8 little-endian bytes each, in column order; SHA's big-endian
// words are byte swaps of each element's 32-bit halves.  Element (i, c)
// lives at m[i * row_stride + c * col_stride], so one kernel reads both a
// column-major trace matrix (row_stride 1: neighbouring threads read
// neighbouring addresses) and row-major FRI rows.  Digests are written as
// their 32 standard bytes.
//
// Bound on the card: integer throughput (64 rounds of ~14 three-input
// 32-bit instructions and 48 schedule words of ~10 per 64-byte block;
// device memory moves at most 16 bytes an element).  Design: the math is
// sha256.cuh's; the schedule is a rolling 16-word window held in
// registers (fully unrolled), padding words are generated in place, and a
// block that is wholly padding (a merge's second block, the last of a row
// of 8k elements) runs on K + W computed once a launch on the host and
// passed as a __grid_constant__ parameter, read from the constant bank:
// 64 rounds and no schedule.  The grind starts every nonce from the state
// after rounds 0-7 (the seed's words; computed once a launch), runs one
// nonce a thread, atomicMins the index of a hit, and a block whose first
// nonce lies above a hit already found stops (unless every nonce's count
// is asked for).  The tree tops are one block of m/2 threads that keep
// each level's digests in shared memory, word-major (no bank conflicts),
// a barrier between levels.
#include "launch.cuh"
#include "sha256.cuh"

#define SHA_THREADS 128
#define SHA_TOPS_MAX 1024  // leaves of the largest level the tops launch takes

struct BlockSync {
    __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

__global__ void __launch_bounds__(SHA_THREADS)
hash_rows_kernel(const uint64_t* __restrict__ m, uint8_t* __restrict__ out,
                 int64_t n, int64_t ncols, int64_t row_stride,
                 int64_t col_stride, const __grid_constant__ Sha256KW pad) {
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        const uint64_t* row = m + i * row_stride;
        uint32_t st[8];
        sha256_message([&](int64_t t) {
            uint64_t v = row[(t >> 1) * col_stride];
            return sha256_bswap((t & 1) ? (uint32_t)(v >> 32) : (uint32_t)v);
        }, 2 * ncols, pad.kw, st);
        sha256_store_digest(out + 32 * i, st);
    }
}

__global__ void __launch_bounds__(SHA_THREADS)
merge_kernel(const uint8_t* __restrict__ left,
             const uint8_t* __restrict__ right, uint8_t* __restrict__ out,
             int64_t n, const __grid_constant__ Sha256KW pad) {
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        uint32_t w[16], st[8];
        sha256_load_digest(left + 32 * i, w);
        sha256_load_digest(right + 32 * i, w + 8);
        sha256_merge_words(w, pad.kw, st);
        sha256_store_digest(out + 32 * i, st);
    }
}

__global__ void __launch_bounds__(SHA_TOPS_MAX / 2)
tree_tops_kernel(const uint8_t* __restrict__ in, uint8_t* out, int64_t m,
                 const __grid_constant__ Sha256KW pad) {
    __shared__ uint32_t sm[2 * 8 * (SHA_TOPS_MAX / 2)];
    sha256_tree_tops(in, out, m, threadIdx.x, sm, pad.kw, BlockSync());
}

__global__ void __launch_bounds__(SHA_THREADS)
grind_kernel(const __grid_constant__ Sha256GrindSeed seed, uint64_t start,
             int64_t n, int bits, int* best, int* __restrict__ lz) {
    for (int64_t b = blockIdx.x * (int64_t)blockDim.x; b < n;
         b += (int64_t)gridDim.x * blockDim.x) {
        // a valid nonce below this block's first is already known
        if (lz == nullptr && *(volatile int*)best < b) return;
        const int64_t i = b + threadIdx.x;
        if (i < n) {
            uint32_t st[8];
            sha256_grind_digest(seed, start + (uint64_t)i, st);
            const int z = sha256_leading_zeros(st);
            if (lz) lz[i] = z;
            if (z >= bits) atomicMin(best, (int)i);
        }
    }
}

MS_API int ms_hash_rows(const uint64_t* m, uint8_t* out, int64_t n,
                        int64_t ncols, int64_t row_stride, int64_t col_stride,
                        cudaStream_t stream) {
    if (n > 0)
        hash_rows_kernel<<<ms_blocks(n, SHA_THREADS), SHA_THREADS, 0,
                           stream>>>(m, out, n, ncols, row_stride, col_stride,
                                     sha256_pad_kw(2 * ncols));
    return ms_last_error();
}

MS_API int ms_merge(const uint8_t* left, const uint8_t* right, uint8_t* out,
                    int64_t n, cudaStream_t stream) {
    if (n > 0)
        merge_kernel<<<ms_blocks(n, SHA_THREADS), SHA_THREADS, 0, stream>>>(
            left, right, out, n, sha256_pad_kw(16));
    return ms_last_error();
}

// every level above `in` (m digests, m a power of two, 2 <= m <= 1024)
// into out ((m - 1) digests, the levels in order)
MS_API int ms_sha_tree_tops(const uint8_t* in, uint8_t* out, int64_t m,
                            cudaStream_t stream) {
    if (m < 2 || (m & (m - 1)) || m > SHA_TOPS_MAX)
        return (int)cudaErrorInvalidValue;
    tree_tops_kernel<<<1, (unsigned)(m / 2), 0, stream>>>(in, out, m,
                                                          sha256_pad_kw(16));
    return ms_last_error();
}

// Proof of work: thread i hashes seed || (start + i) as 8 big-endian bytes
// (native pow_grind's message) and atomicMins i into *best when the digest
// has >= bits leading zero bits; lz, when given, receives every nonce's
// count (for the checks), and then no block stops early.  `seed` is the
// coin's 32-byte seed in host memory.
MS_API int ms_sha_grind(const uint8_t* seed, int64_t start, int64_t n,
                        int64_t bits, int* best, int* lz,
                        cudaStream_t stream) {
    if (n > 0)
        grind_kernel<<<ms_blocks(n, SHA_THREADS), SHA_THREADS, 0, stream>>>(
            sha256_grind_seed(seed), (uint64_t)start, n, (int)bits, best, lz);
    return ms_last_error();
}
