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
// draws) and N - 1 products for the powers, some 10^4-10^5 integer
// operations on 64 bytes, far below what fills a card; what a step costs
// is the chain of dependent rounds.  The powers are here because the
// fold's plain torch products of a one-element alpha cost a few hundred
// launches an Fq3 power, which made W's FRI phase slower than the host
// coin's (PERF.md).
// Design: the SHA-256 step runs on one thread (its rounds are one chain);
// the RPO-256 step on one warp, two groups of 16 lanes with one element
// of the state a lane (rpo256_lanes.cuh, the schedule with the shortest
// permutation), both groups reseeding and then group g computing the
// digest of counter 1 + g, so k <= 8 draws take two permutations in a row;
// the thread that stores alpha also computes its powers.
#include "coin.cuh"
#include "launch.cuh"

#define COIN_RPO_THREADS 32  // one warp: two groups of 16 lanes

__global__ void coin_sha_kernel(const uint8_t* seed, const uint8_t* root,
                                int64_t k, int64_t N, uint8_t* seed_out,
                                uint64_t* draws, uint64_t* pw) {
    coin_sha_step(seed, root, k, N, seed_out, draws, pw);
}

__global__ void __launch_bounds__(COIN_RPO_THREADS)
coin_rpo_kernel(const uint8_t* seed, const uint8_t* root, int64_t k,
                int64_t N, uint8_t* seed_out, uint64_t* draws, uint64_t* pw) {
    constexpr int G = rpo_group_lanes<1>();
    __shared__ uint64_t rc[2 * RPO_ROUNDS * RPO_WIDTH];
    const RpoLane<1> ln(threadIdx.x % G, rc_to_shared(rc));
    const CoinRpoGroupPerm<ShflEx<1>, gl_mul_cc_fn> perm{ln, ShflEx<1>(),
                                                          gl_mul_cc_fn()};
    coin_rpo_step(seed, root, k, N, threadIdx.x / G, COIN_RPO_THREADS / G,
                  ln.lane == 0, seed_out, draws, pw, perm);
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
    coin_sha_kernel<<<1, 1, 0, stream>>>(seed, root, k, N, seed_out, draws,
                                         pw);
    return ms_last_error();
}

// seed_out = hash_rpo.merge(seed, root); draws[0..k) the first k canonical
// Fp draws after it (digest elements e3, e2, e1, e0 of counters 1, 2, ..);
// pw as ms_coin_sha's
MS_API int ms_coin_rpo(const uint8_t* seed, const uint8_t* root, int64_t k,
                       int64_t N, uint8_t* seed_out, uint64_t* draws,
                       uint64_t* pw, cudaStream_t stream) {
    if (!coin_args_ok(k, N)) return (int)cudaErrorInvalidValue;
    coin_rpo_kernel<<<1, COIN_RPO_THREADS, 0, stream>>>(seed, root, k, N,
                                                        seed_out, draws, pw);
    return ms_last_error();
}
