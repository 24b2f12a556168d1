// Kernel G: batched RPO-256 Merkle row hashes and merges, the levels of a
// tree near its root, and the proof-of-work grind of RPO-coin
// configurations.
//
// Replaces ministark_tpu/ops/rpo256_pallas.py `_rpo_kernel` (through
// `permute_lanes`, `hash_columns_lanes`, `merge_lanes` and
// `tree_levels_lanes_br`) and its use by ops/pow.py `_grind_rpo_batch`.
//
// Bound on the card: integer operations.  A permutation is 7 rounds of 12
// x (4 + 72) Goldilocks products (the x^7 S-box and the x^(1/7) chain) and
// two MDS layers of 144 small-constant multiply-adds, about 140,000 32-bit
// operations against at most 96 bytes of state in and 32 bytes out, so
// device memory is never the limit.
//
// Design: each state is spread over a group of lanes (rpo256_lanes.cuh:
// E = 1 element a lane on 16 lanes, or 3 on 4, the whole state gathered by
// __shfl_sync before each MDS layer), the round constants copied to shared
// memory, the products PTX carry chains and lazy inside the S-boxes.  One
// state a thread ran a round's twelve x^(1/7) chains one after another
// (ptxas gives each element's squaring runs their own loop), so a launch
// of fewer states than the card holds threads took a whole permutation's
// latency, about 0.48 ms on an H100 whatever the count; a group cuts that
// by its width (E = 1: 0.035 ms), and with the PTX product the lanes also
// did more permutations a second than one state a thread at every size
// measured, 1 to 2^23 states (ops/rpo256.py has the numbers).  The wrapper
// takes E = 1 for small launches and 3 for large ones.  Inputs are read in
// place through (row, column) strides: the column-major trace (C, n) and
// an Fq3 matrix (C, 3, n) with row stride 1, FRI layer rows (n/N, N) with
// column stride 1, so neither is copied.  Digests are (n, 4) u64,
// state[4..8].  `ms_rpo_tree_tops` builds every level of a Merkle tree
// above a level of at most 64 nodes in one launch: one block, a group a
// node (one element a lane), a barrier between levels.
#include "launch.cuh"
#include "rpo256.cuh"
#include "rpo256_lanes.cuh"

#define RPO_LANE_THREADS 128

struct BlockSync {
    __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// A grid-stride loop over n states, a group of G lanes each, in which a
// warp's groups move together (the shuffles need every lane of the warp):
// state base + offset is this group's, and a group past the last state
// runs a copy of it and stores nothing.
template <int G>
struct LaneLoop {
    int64_t base, offset, stride;
    __device__ __forceinline__ LaneLoop() {
        const int64_t gid =
            ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
        offset = (threadIdx.x % 32) / G;
        base = gid - offset;  // the warp's first group
        stride = (int64_t)gridDim.x * blockDim.x / G;
    }
};

template <int E>
__global__ void __launch_bounds__(RPO_LANE_THREADS)
rpo_hash_rows_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ out,
                     int64_t n, int64_t ncols, int64_t rs, int64_t cs) {
    constexpr int G = rpo_group_lanes<E>();
    __shared__ uint64_t rc[2 * RPO_ROUNDS * RPO_WIDTH];
    const RpoLane<E> ln(threadIdx.x % G, rc_to_shared(rc));
    const LaneLoop<G> lp;
    for (int64_t b = lp.base; b < n; b += lp.stride) {
        const int64_t i = b + lp.offset < n ? b + lp.offset : n - 1;
        uint64_t v[E];
        rpo_lanes_hash_row<E>(ln, v, x + i * rs, ncols, cs, ShflEx<E>(),
                              gl_mul_cc_fn());
        if (b + lp.offset < n)
            rpo_lanes_store_digest<E>(ln, v, out + i * RPO_DIGEST);
    }
}

template <int E>
__global__ void __launch_bounds__(RPO_LANE_THREADS)
rpo_merge_kernel(const uint64_t* __restrict__ left,
                 const uint64_t* __restrict__ right,
                 uint64_t* __restrict__ out, int64_t n) {
    constexpr int G = rpo_group_lanes<E>();
    __shared__ uint64_t rc[2 * RPO_ROUNDS * RPO_WIDTH];
    const RpoLane<E> ln(threadIdx.x % G, rc_to_shared(rc));
    const LaneLoop<G> lp;
    for (int64_t b = lp.base; b < n; b += lp.stride) {
        const int64_t i = b + lp.offset < n ? b + lp.offset : n - 1;
        uint64_t v[E];
        rpo_lanes_load_merge<E>(ln, v, left + i * RPO_DIGEST,
                                right + i * RPO_DIGEST);
        rpo_permute_lanes<E>(ln, v, ShflEx<E>(), gl_mul_cc_fn());
        if (b + lp.offset < n)
            rpo_lanes_store_digest<E>(ln, v, out + i * RPO_DIGEST);
    }
}

template <int E>
__global__ void __launch_bounds__(RPO_LANE_THREADS)
rpo_grind_kernel(const uint64_t* __restrict__ seed, uint64_t start, int64_t n,
                 int bits, int* __restrict__ best, int* __restrict__ lz) {
    constexpr int G = rpo_group_lanes<E>();
    __shared__ uint64_t rc[2 * RPO_ROUNDS * RPO_WIDTH];
    const RpoLane<E> ln(threadIdx.x % G, rc_to_shared(rc));
    uint64_t sd[RPO_DIGEST];
#pragma unroll
    for (int k = 0; k < RPO_DIGEST; k++) sd[k] = seed[k];
    const LaneLoop<G> lp;
    for (int64_t b = lp.base; b < n; b += lp.stride) {
        const int64_t i = b + lp.offset < n ? b + lp.offset : n - 1;
        uint64_t v[E], s[RPO_WIDTH];
        rpo_lanes_load_grind<E>(ln, v, sd, start + (uint64_t)i);
        rpo_permute_lanes<E>(ln, v, ShflEx<E>(), gl_mul_cc_fn());
        ShflEx<E>()(v, s);
        if (ln.lane == 0 && b + lp.offset < n) {
            const int z = rpo_leading_zeros(s + RPO_CAPACITY);
            if (lz) lz[i] = z;
            if (z >= bits) atomicMin(best, (int)i);
        }
    }
}

// one block: a group of 16 lanes (one element a lane, the shortest
// permutation) for each node of the first level, at least a warp
__global__ void __launch_bounds__(512)
rpo_tree_tops_kernel(const uint64_t* __restrict__ in, uint64_t* out,
                     int64_t m) {
    constexpr int G = rpo_group_lanes<1>();
    __shared__ uint64_t rc[2 * RPO_ROUNDS * RPO_WIDTH];
    const RpoLane<1> ln(threadIdx.x % G, rc_to_shared(rc));
    rpo_lanes_tree_tops<1>(ln, in, out, m, threadIdx.x / G,
                           (threadIdx.x / 32) * (32 / G), ShflEx<1>(),
                           BlockSync(), gl_mul_cc_fn());
}

template <int E>
static unsigned lane_blocks(int64_t n) {
    return ms_blocks(n * rpo_group_lanes<E>(), RPO_LANE_THREADS);
}

// Each entry point but the tree tops takes e, the elements of a state a
// lane (1 or 3).
// Row digests: row i's ncols elements at x[i * rs + c * cs].
MS_API int ms_rpo_hash_rows(const uint64_t* x, uint64_t* out, int64_t n,
                            int64_t ncols, int64_t rs, int64_t cs, int64_t e,
                            cudaStream_t stream) {
    if (n <= 0) return ms_last_error();
    if (e == 1)
        rpo_hash_rows_kernel<1><<<lane_blocks<1>(n), RPO_LANE_THREADS, 0,
                                  stream>>>(x, out, n, ncols, rs, cs);
    else if (e == 3)
        rpo_hash_rows_kernel<3><<<lane_blocks<3>(n), RPO_LANE_THREADS, 0,
                                  stream>>>(x, out, n, ncols, rs, cs);
    else
        return (int)cudaErrorInvalidValue;
    return ms_last_error();
}

// Merkle merges: digest i of the next level absorbs left[i] || right[i].
MS_API int ms_rpo_merge(const uint64_t* left, const uint64_t* right,
                        uint64_t* out, int64_t n, int64_t e,
                        cudaStream_t stream) {
    if (n <= 0) return ms_last_error();
    if (e == 1)
        rpo_merge_kernel<1><<<lane_blocks<1>(n), RPO_LANE_THREADS, 0,
                              stream>>>(left, right, out, n);
    else if (e == 3)
        rpo_merge_kernel<3><<<lane_blocks<3>(n), RPO_LANE_THREADS, 0,
                              stream>>>(left, right, out, n);
    else
        return (int)cudaErrorInvalidValue;
    return ms_last_error();
}

// Proof of work: the group of nonce start + i hashes [1, 0, 0, 0 | seed |
// lo32, hi32, 1, 0] (hash_rpo.merge_with_int) and atomicMins i into *best
// when the digest has >= bits leading zeros; lz, when given, receives
// every nonce's count (for the checks).
MS_API int ms_rpo_grind(const uint64_t* seed, int64_t start, int64_t n,
                        int64_t bits, int* best, int* lz, int64_t e,
                        cudaStream_t stream) {
    if (n <= 0) return ms_last_error();
    if (e == 1)
        rpo_grind_kernel<1><<<lane_blocks<1>(n), RPO_LANE_THREADS, 0,
                              stream>>>(seed, (uint64_t)start, n, (int)bits,
                                        best, lz);
    else if (e == 3)
        rpo_grind_kernel<3><<<lane_blocks<3>(n), RPO_LANE_THREADS, 0,
                              stream>>>(seed, (uint64_t)start, n, (int)bits,
                                        best, lz);
    else
        return (int)cudaErrorInvalidValue;
    return ms_last_error();
}

// every level above `in` (m digests, m a power of two, 2 <= m <= 64) into
// out ((m - 1) digests, the levels in order)
MS_API int ms_rpo_tree_tops(const uint64_t* in, uint64_t* out, int64_t m,
                            cudaStream_t stream) {
    const int G = rpo_group_lanes<1>();
    if (m < 2 || (m & (m - 1)) || m / 2 * G > 512)
        return (int)cudaErrorInvalidValue;
    const int threads = (int)((m / 2 * G + 31) / 32 * 32);
    rpo_tree_tops_kernel<<<1, threads, 0, stream>>>(in, out, m);
    return ms_last_error();
}
