// The device Fiat-Shamir coin: one launch per FRI layer reseeds the coin
// with the layer's Merkle root and makes the k draws the next fold needs
// (k = 1 for Fp, 3 for an Fq3 alpha) and the fold's N powers of alpha, so
// no root has to reach the host between two layers.  The math is
// coin.cuh's.
//
// Replaces ministark_tpu/ops/coin.py `reseed` + `draw_fps` (SHA-256,
// coin.py:35-64) and `rpo_reseed` + `rpo_draw_fps` (RPO-256,
// coin.py:102-131), XLA inside ministark_tpu/fri.py
// `_fri_pipeline_program`.  Unlike `draw_fps`, which picks from a fixed
// eight candidates, the SHA-256 draw is the host coin's rejection loop.
//
// Bound on the card: latency.  A step is a few dependent hashes (SHA-256:
// two compressions for the reseed and one a digest of four candidates;
// RPO-256: one permutation for the reseed and one a digest of four
// draws) and the N powers of alpha, some 10^4-10^5 integer operations on
// 64 bytes, far below what fills a card; what a step costs is the chain of
// dependent rounds.  The powers are here because the fold's plain torch
// products of a one-element alpha cost a few hundred launches an Fq3
// power, which made W's FRI phase slower than the host coin's (PERF.md).
// Design (both steps one warp, coin.cuh): the SHA-256 step's reseed is one
// chain of two compressions, unrolled on constant indices so that the
// state and schedule stay in registers (no stack frame); lane c then
// hashes counter 32 r + c + 1 and a ballot a popped position places the
// accepted u64s in the host coin's order, 32 digests a round.  The
// RPO-256 step runs two groups of 16 lanes, one state element a lane
// (rpo256_lanes.cuh, its S-box chains on gl_mul_wide_lazy and
// gl_sqr_wide_lazy), both reseeding and then group g taking counter 1 + g;
// the state stays spread over the lanes from the reseed to the draws (no
// exchange of the whole state), and the lanes that hold alpha's elements
// hand them out by shuffles.  Either way lane j makes alpha^j by a prefix
// product over the lanes (five steps, run as a loop: a lone warp fetches
// code that it runs once cold).  The step this replaced (one thread for
// SHA-256, the same lanes but the whole state handed to every lane after
// each permutation, N - 1 products in a row for the powers) is
// scripts/coin_single.cu, timed against this one by scripts/ab_kernels.py
// --coin, with the RPO-256 step's parts stamped (the two permutations in a
// row are its floor: about 24 us each on an H100).
#include "coin.cuh"
#include "launch.cuh"

// a warp's collectives (coin.cuh's Warp), the whole warp taking part
struct CoinWarp {
    __device__ __forceinline__ uint32_t ballot(bool p) const {
        return __ballot_sync(0xFFFFFFFFu, p);
    }
    __device__ __forceinline__ uint64_t shfl(uint64_t v, int lane) const {
        return __shfl_sync(0xFFFFFFFFu, (unsigned long long)v, lane);
    }
    __device__ __forceinline__ uint64_t shfl_up(uint64_t v, int d) const {
        return __shfl_up_sync(0xFFFFFFFFu, (unsigned long long)v, d);
    }
};

__global__ void __launch_bounds__(COIN_LANES)
coin_sha_kernel(const uint8_t* seed, const uint8_t* root, int64_t k,
                int64_t N, uint8_t* seed_out, uint64_t* draws, uint64_t* pw) {
    CoinWarp w;
    coin_sha_warp(seed, root, k, N, threadIdx.x, w, seed_out, draws, pw);
}

__global__ void __launch_bounds__(COIN_LANES)
coin_rpo_kernel(const uint8_t* seed, const uint8_t* root, int64_t k,
                int64_t N, uint8_t* seed_out, uint64_t* draws, uint64_t* pw) {
    __shared__ uint64_t rc[2 * RPO_ROUNDS * RPO_WIDTH];
    const RpoLane<1> ln(threadIdx.x % rpo_group_lanes<1>(), rc_to_shared(rc));
    CoinWarp w;
    coin_rpo_warp(seed, root, k, N, threadIdx.x,
                  CoinRpoPerm<ShflEx<1>, gl_mul_wide_fn>{ln, ShflEx<1>()}, w,
                  seed_out, draws, pw);
}

// N > 0 asks for alpha's powers, of an Fp (k = 1) or Fq3 (k = 3) alpha
static bool coin_args_ok(int64_t k, int64_t N) {
    return k >= 1 && N >= 0 && (N == 0 || k == 1 || k == 3);
}

// seed_out = sha256(seed || root); draws[0..k) the first k canonical Fp
// draws after it; pw (k x N) alpha^j for j < N, component-major.  seed,
// root, seed_out: 32 bytes on the card.
MS_API int ms_coin_sha(const uint8_t* seed, const uint8_t* root, int64_t k,
                       int64_t N, uint8_t* seed_out, uint64_t* draws,
                       uint64_t* pw, cudaStream_t stream) {
    if (!coin_args_ok(k, N)) return (int)cudaErrorInvalidValue;
    coin_sha_kernel<<<1, COIN_LANES, 0, stream>>>(seed, root, k, N, seed_out,
                                                  draws, pw);
    return ms_last_error();
}

// seed_out = hash_rpo.merge(seed, root); draws[0..k) the first k canonical
// Fp draws after it (digest elements e3, e2, e1, e0 of counters 1, 2, ..);
// pw as ms_coin_sha's
MS_API int ms_coin_rpo(const uint8_t* seed, const uint8_t* root, int64_t k,
                       int64_t N, uint8_t* seed_out, uint64_t* draws,
                       uint64_t* pw, cudaStream_t stream) {
    if (!coin_args_ok(k, N)) return (int)cudaErrorInvalidValue;
    coin_rpo_kernel<<<1, COIN_LANES, 0, stream>>>(seed, root, k, N, seed_out,
                                                  draws, pw);
    return ms_last_error();
}
