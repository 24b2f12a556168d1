// The device coin step as csrc/coin.cu shipped it before the warp-wide
// design, kept for scripts/ab_kernels.py --coin to time against the one it
// ships (entry points ab_old_coin_sha, ab_old_coin_rpo, the same arguments
// as ms_coin_sha, ms_coin_rpo), and both RPO-256 steps with clock64() and
// %globaltimer stamps at their parts (ab_rpo_parts_old, ab_rpo_parts_new:
// the start, after the reseed permutation and seed' store, after the
// digest permutations and draw stores, after alpha's powers).  Built by
// ab_kernels.py with the port's nvcc flags and csrc/ on the include path.
//
// Beside them, latency probes of one thread's chain of dependent Goldilocks
// products (ab_mul_latency: clock64() cycles a product for each form of
// the product and the squaring), and the new RPO-256 step stamped in three
// more forms: on the carry-chain products (gl_mul_cc_fn) in place of the
// wide ones it ships with (ab_rpo_parts_cc), and with the permutation's
// rounds or its runs of squarings as loops that are not unrolled
// (ab_rpo_parts_rounds, ab_rpo_parts_squarings).
//
// The old SHA-256 step runs on one thread: the reseed, the digests of
// counters 1, 2, .. one after another until k draws are accepted, then
// alpha's N powers as N - 1 products in a row.  The old RPO-256 step runs
// one warp, two groups of 16 lanes, one state element a lane, and hands
// every lane the whole state after each permutation; one lane of group 0
// makes the powers.
#include "coin.cuh"
#include "launch.cuh"

// the draws one digest (words d) gives, in pop order, appended to
// draws[got..k): an accepted u64 (u < p) as u R^-1, a rejected one skipped
GL_HD void old_coin_sha_take(const uint32_t d[8], int64_t k, int64_t& got,
                         uint64_t* draws) {
    for (int i = 0; i < 4 && got < k; i++) {
        const uint64_t u = coin_sha_popped(d, i);
        if (u < GL_P) draws[got++] = gl_mul(u, COIN_R_INV);
    }
}

// alpha^j for j < N, alpha = a[0] (k = 1) or (a[0], a[1], a[2]) (k = 3),
// component-major: pw[c * N + j]
GL_HD void old_coin_alpha_powers(const uint64_t* a, int64_t k, int64_t N,
                             uint64_t* pw) {
    if (k == 1) {
        uint64_t p = 1;
        for (int64_t j = 0; j < N; j++) {
            pw[j] = p;
            p = gl_mul(p, a[0]);
        }
        return;
    }
    const gl3 alpha = gl3_make(a[0], a[1], a[2]);
    gl3 p = gl3_from_base(1);
    for (int64_t j = 0; j < N; j++) {
        gl3_store(pw, j, N, p);
        p = gl3_mul(p, alpha);
    }
}

// The SHA-256 coin step: seed_out = sha256(seed || root), then draws[0..k)
// the first k accepted draws after it (canonical Fp values), and alpha's
// first N powers into pw.
GL_HD void old_coin_sha_step(const uint8_t* seed, const uint8_t* root, int64_t k,
                         int64_t N, uint8_t* seed_out, uint64_t* draws,
                         uint64_t* pw) {
    uint32_t w[16], st[8];
    coin_load_words(seed, w);
    coin_load_words(root, w + 8);
    const Sha256KW pad = sha256_pad_kw(16);
    sha256_merge_words(w, pad.kw, st);
    coin_store_words(seed_out, st);
    // the digests sha256(seed' || counter) share rounds 0-7: the grind's
    // message layout (seed || 8-byte big-endian nonce)
    Sha256GrindSeed g;
    for (int j = 0; j < 8; j++) g.w[j] = st[j];
    sha256_init(g.mid);
    for (int t = 0; t < 8; t++) sha256_round(g.mid, sha256_k(t) + g.w[t]);
    int64_t got = 0;
    for (uint64_t counter = 1; got < k; counter++) {
        uint32_t d[8];
        sha256_grind_digest(g, counter, d);
        old_coin_sha_take(d, k, got, draws);
    }
    if (N > 0) old_coin_alpha_powers(draws, k, N, pw);
}

// The RPO-256 coin step, run by `groups` groups at once, this one group
// `group`: seed_out = merge(seed, root), then draws[0..k) the first k
// draws after it, and alpha's first N powers into pw (k = 1 or 3: group
// 0's first digest holds alpha).  perm(s) permutes the whole 12-element state s in place
// (every lane of a group holds all of it).  Group g computes the digests
// of counters 1 + g, 1 + g + groups, ..; every group runs the same number
// of permutations (a group's lanes exchange with shuffles), and `writer`
// marks the one lane of each group that stores.
// no marks (the ab_rpo_parts_* kernels below pass clock64() stamps)
struct OldNoMark {
    GL_FN void operator()(int) const {}
};

template <class Perm, class Mark = OldNoMark>
GL_HD void old_coin_rpo_step(const uint8_t* seed, const uint8_t* root, int64_t k,
                         int64_t N, int group, int groups, bool writer,
                         uint8_t* seed_out, uint64_t* draws, uint64_t* pw,
                         Perm perm, Mark mark = Mark()) {
    uint64_t s[RPO_WIDTH], sd[RPO_DIGEST];
    for (int j = 0; j < RPO_CAPACITY; j++) s[j] = 0;
    coin_load_elems(seed, s + RPO_CAPACITY);
    coin_load_elems(root, s + RPO_CAPACITY + RPO_DIGEST);
    perm(s);
    for (int j = 0; j < RPO_DIGEST; j++) sd[j] = s[RPO_CAPACITY + j];
    if (writer && group == 0) coin_store_elems(seed_out, sd);
    mark(0);
    const int64_t digests = (k + RPO_DIGEST - 1) / RPO_DIGEST;
    for (int64_t r = 0; r * groups < digests; r++) {
        const uint64_t counter = 1 + (uint64_t)(r * groups + group);
        coin_rpo_draw_state(s, sd, counter);
        perm(s);
        if (!writer) continue;
        for (int i = 0; i < RPO_DIGEST; i++) {
            const int64_t j = (int64_t)(counter - 1) * RPO_DIGEST + i;
            if (j < k)
                draws[j] = gl_mul(s[RPO_CAPACITY + RPO_DIGEST - 1 - i],
                                  COIN_R_INV);
        }
    }
    mark(1);
    if (N > 0 && writer && group == 0) old_coin_alpha_powers(draws, k, N, pw);
    mark(2);
}

// perm for old_coin_rpo_step on one thread: the whole permutation
struct old_CoinRpoPerm {
    GL_FN void operator()(uint64_t* s) const { rpo_permute(s); }
};

// perm for old_coin_rpo_step on a group of lanes, one element a lane
// (rpo256_lanes.cuh): each lane takes its element of s, the group runs the
// permutation, and the exchange hands every lane the whole state again.
// ex(v, s) is the group's exchange (__shfl_sync on the card).
template <class Ex, class Mul>
struct old_CoinRpoGroupPerm {
    RpoLane<1> ln;
    Ex ex;
    Mul mul;
    GL_FN void operator()(uint64_t* s) const {
        uint64_t v[1] = {ln.elem(0) < RPO_WIDTH ? s[ln.elem(0)] : 0};
        rpo_permute_lanes<1>(ln, v, ex, mul);
        ex(v, s);
    }
};

#define old_COIN_RPO_THREADS 32  // one warp: two groups of 16 lanes

__global__ void old_coin_sha_kernel(const uint8_t* seed, const uint8_t* root,
                                int64_t k, int64_t N, uint8_t* seed_out,
                                uint64_t* draws, uint64_t* pw) {
    old_coin_sha_step(seed, root, k, N, seed_out, draws, pw);
}

__global__ void __launch_bounds__(old_COIN_RPO_THREADS)
old_coin_rpo_kernel(const uint8_t* seed, const uint8_t* root, int64_t k,
                int64_t N, uint8_t* seed_out, uint64_t* draws, uint64_t* pw) {
    constexpr int G = rpo_group_lanes<1>();
    __shared__ uint64_t rc[2 * RPO_ROUNDS * RPO_WIDTH];
    const RpoLane<1> ln(threadIdx.x % G, rc_to_shared(rc));
    const old_CoinRpoGroupPerm<ShflEx<1>, gl_mul_cc_fn> perm{ln, ShflEx<1>(),
                                                          gl_mul_cc_fn()};
    old_coin_rpo_step(seed, root, k, N, threadIdx.x / G, old_COIN_RPO_THREADS / G,
                  ln.lane == 0, seed_out, draws, pw, perm);
}

// N > 0 asks for alpha's powers, of an Fp (k = 1) or Fq3 (k = 3) alpha
static bool old_coin_args_ok(int64_t k, int64_t N) {
    return k >= 1 && N >= 0 && (N == 0 || k == 1 || k == 3);
}

// seed_out = sha256(seed || root); draws[0..k) the first k canonical Fp
// draws after it; pw (k x N) alpha^j for j < N, component-major.  seed,
// root, seed_out: 32 bytes on the card.
MS_API int ab_old_coin_sha(const uint8_t* seed, const uint8_t* root, int64_t k,
                       int64_t N, uint8_t* seed_out, uint64_t* draws,
                       uint64_t* pw, cudaStream_t stream) {
    if (!old_coin_args_ok(k, N)) return (int)cudaErrorInvalidValue;
    old_coin_sha_kernel<<<1, 1, 0, stream>>>(seed, root, k, N, seed_out, draws,
                                         pw);
    return ms_last_error();
}

// seed_out = hash_rpo.merge(seed, root); draws[0..k) the first k canonical
// Fp draws after it (digest elements e3, e2, e1, e0 of counters 1, 2, ..);
// pw as ms_coin_sha's
MS_API int ab_old_coin_rpo(const uint8_t* seed, const uint8_t* root, int64_t k,
                       int64_t N, uint8_t* seed_out, uint64_t* draws,
                       uint64_t* pw, cudaStream_t stream) {
    if (!old_coin_args_ok(k, N)) return (int)cudaErrorInvalidValue;
    old_coin_rpo_kernel<<<1, old_COIN_RPO_THREADS, 0, stream>>>(seed, root, k, N,
                                                        seed_out, draws, pw);
    return ms_last_error();
}

// -- the parts of a step, stamped ---------------------------------------------

// lane 0 of the warp writes (clock64, %globaltimer) at mark i into
// out[2 (i + 1)], out[2 (i + 1) + 1]; the kernel writes the start at 0, 1
struct ClockMark {
    long long* out;
    int lane;
    __device__ __forceinline__ void operator()(int i) const {
        __syncwarp();
        if (lane == 0) stamp(out + 2 * (i + 1));
    }
    __device__ __forceinline__ static void stamp(long long* o) {
        unsigned long long g;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
        o[0] = clock64();
        o[1] = (long long)g;
    }
};

// coin.cuh's coin_rpo_warp with its three parts stamped apart
template <class Perm, class Warp>
__device__ __forceinline__ void stamped_rpo_warp(
    const uint8_t* seed, const uint8_t* root, int64_t k, int64_t N, int lane,
    Perm perm, Warp& w, uint8_t* seed_out, uint64_t* draws, uint64_t* pw,
    ClockMark mark) {
    const uint64_t sd = coin_rpo_reseed(seed, root, lane, perm, seed_out);
    mark(0);
    const gl3 alpha = coin_rpo_draws(sd, k, N, lane, perm, w, draws);
    mark(1);
    if (N > 0) coin_alpha_powers_warp(alpha, k, N, lane, w, pw);
    mark(2);
}

struct StampWarp {
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

__global__ void __launch_bounds__(32)
ab_rpo_parts_old_kernel(const uint8_t* seed, const uint8_t* root, int64_t k,
                        int64_t N, uint8_t* seed_out, uint64_t* draws,
                        uint64_t* pw, long long* stamps) {
    constexpr int G = rpo_group_lanes<1>();
    __shared__ uint64_t rc[2 * RPO_ROUNDS * RPO_WIDTH];
    const RpoLane<1> ln(threadIdx.x % G, rc_to_shared(rc));
    if (threadIdx.x == 0) ClockMark::stamp(stamps);
    const old_CoinRpoGroupPerm<ShflEx<1>, gl_mul_cc_fn> perm{ln, ShflEx<1>(),
                                                              gl_mul_cc_fn()};
    old_coin_rpo_step(seed, root, k, N, threadIdx.x / G, 32 / G,
                      ln.lane == 0, seed_out, draws, pw, perm,
                      ClockMark{stamps, (int)threadIdx.x});
}

template <class Mul>
__device__ __forceinline__ void ab_rpo_parts(const uint8_t* seed,
                                             const uint8_t* root, int64_t k,
                                             int64_t N, uint8_t* seed_out,
                                             uint64_t* draws, uint64_t* pw,
                                             long long* stamps) {
    __shared__ uint64_t rc[2 * RPO_ROUNDS * RPO_WIDTH];
    const RpoLane<1> ln(threadIdx.x % rpo_group_lanes<1>(), rc_to_shared(rc));
    if (threadIdx.x == 0) ClockMark::stamp(stamps);
    StampWarp w;
    stamped_rpo_warp(seed, root, k, N, threadIdx.x,
                     CoinRpoPerm<ShflEx<1>, Mul>{ln, ShflEx<1>()}, w,
                     seed_out, draws, pw, ClockMark{stamps, (int)threadIdx.x});
}

__global__ void __launch_bounds__(32)
ab_rpo_parts_new_kernel(const uint8_t* seed, const uint8_t* root, int64_t k,
                        int64_t N, uint8_t* seed_out, uint64_t* draws,
                        uint64_t* pw, long long* stamps) {
    ab_rpo_parts<gl_mul_wide_fn>(seed, root, k, N, seed_out, draws, pw,
                                 stamps);
}

// stamps: 8 long longs, (clock64, ns) at the start and after each part
MS_API int ab_rpo_parts_old(const uint8_t* seed, const uint8_t* root,
                            int64_t k, int64_t N, uint8_t* seed_out,
                            uint64_t* draws, uint64_t* pw, long long* stamps,
                            cudaStream_t stream) {
    ab_rpo_parts_old_kernel<<<1, 32, 0, stream>>>(seed, root, k, N, seed_out,
                                                  draws, pw, stamps);
    return ms_last_error();
}

MS_API int ab_rpo_parts_new(const uint8_t* seed, const uint8_t* root,
                            int64_t k, int64_t N, uint8_t* seed_out,
                            uint64_t* draws, uint64_t* pw, long long* stamps,
                            cudaStream_t stream) {
    ab_rpo_parts_new_kernel<<<1, 32, 0, stream>>>(seed, root, k, N, seed_out,
                                                  draws, pw, stamps);
    return ms_last_error();
}

// -- the product's latency --------------------------------------------------------

// one thread's chain of `reps` dependent products of form F: 0
// gl_mul_cc_lazy(x, x), 1 gl_mul_cc_lazy(x, y), 2 gl_mul(x, x) (C++,
// canonical), 3 gl_mul_wide_lazy(x, x), 4 gl_sqr_wide_lazy(x), 5
// gl_mul_wide_lazy(x, y); clock64() cycles a product into cycles[F]
template <int F>
__global__ void ab_mul_latency_kernel(uint64_t x0, int reps,
                                      long long* cycles, uint64_t* out) {
    uint64_t x = x0 + F;
    const uint64_t y = x0 ^ 0x5555;
    const long long t0 = clock64();
#pragma unroll 8
    for (int k = 0; k < reps; k++) {
        if (F == 0) x = gl_mul_cc_lazy(x, x);
        if (F == 1) x = gl_mul_cc_lazy(x, y);
        if (F == 2) x = gl_mul(x, x);
        if (F == 3) x = gl_mul_wide_lazy(x, x);
        if (F == 4) x = gl_sqr_wide_lazy(x);
        if (F == 5) x = gl_mul_wide_lazy(x, y);
    }
    cycles[F] = (clock64() - t0) / reps;
    out[F] = gl_canon(x);
}

MS_API int ab_mul_latency(uint64_t x0, long long* cycles, uint64_t* out,
                          cudaStream_t stream) {
    ab_mul_latency_kernel<0><<<1, 1, 0, stream>>>(x0, 4096, cycles, out);
    ab_mul_latency_kernel<1><<<1, 1, 0, stream>>>(x0, 4096, cycles, out);
    ab_mul_latency_kernel<2><<<1, 1, 0, stream>>>(x0, 4096, cycles, out);
    ab_mul_latency_kernel<3><<<1, 1, 0, stream>>>(x0, 4096, cycles, out);
    ab_mul_latency_kernel<4><<<1, 1, 0, stream>>>(x0, 4096, cycles, out);
    ab_mul_latency_kernel<5><<<1, 1, 0, stream>>>(x0, 4096, cycles, out);
    return ms_last_error();
}

// the new step on gl_mul_cc_fn's products (the carry chains) in place of
// the wide ones
__global__ void __launch_bounds__(32)
ab_rpo_parts_cc_kernel(const uint8_t* seed, const uint8_t* root, int64_t k,
                       int64_t N, uint8_t* seed_out, uint64_t* draws,
                       uint64_t* pw, long long* stamps) {
    ab_rpo_parts<gl_mul_cc_fn>(seed, root, k, N, seed_out, draws, pw, stamps);
}

MS_API int ab_rpo_parts_cc(const uint8_t* seed, const uint8_t* root,
                           int64_t k, int64_t N, uint8_t* seed_out,
                           uint64_t* draws, uint64_t* pw, long long* stamps,
                           cudaStream_t stream) {
    ab_rpo_parts_cc_kernel<<<1, 32, 0, stream>>>(seed, root, k, N, seed_out,
                                                 draws, pw, stamps);
    return ms_last_error();
}

// -- the permutation's loops ----------------------------------------------------

// rpo_permute_lanes<1> with its rounds (RR) and its runs of squarings
// (RS) as loops that are not unrolled, or unrolled; products Mul
template <bool RR, bool RS, class Mul>
__device__ __forceinline__ uint64_t ab_sqr_n(uint64_t x, int k, Mul mul) {
    if (RS) {
#pragma unroll 1
        for (int i = 0; i < k; i++) x = mul.sqr(x);
    } else {
#pragma unroll
        for (int i = 0; i < k; i++) x = mul.sqr(x);
    }
    return x;
}

template <bool RR, bool RS, class Mul>
__device__ __forceinline__ uint64_t ab_pow_inv7(uint64_t x, Mul mul) {
    const uint64_t t1 = mul.sqr(x), t2 = mul.sqr(t1);
    const uint64_t t3 = mul.lazy(ab_sqr_n<RR, RS>(t2, 3, mul), t2);
    const uint64_t t4 = mul.lazy(ab_sqr_n<RR, RS>(t3, 6, mul), t3);
    const uint64_t t5 = mul.lazy(ab_sqr_n<RR, RS>(t4, 12, mul), t4);
    const uint64_t t6 = mul.lazy(ab_sqr_n<RR, RS>(t5, 6, mul), t3);
    uint64_t a = mul.lazy(ab_sqr_n<RR, RS>(t6, 31, mul), t6);
    a = mul.lazy(mul.sqr(a), t6);
    return mul.lazy(ab_sqr_n<RR, RS>(a, 2, mul), mul.lazy(mul.lazy(t1, t2),
                                                          x));
}

template <bool RR, bool RS, class Mul>
struct AbLoopPerm {
    RpoLane<1> ln;
    __device__ __forceinline__ uint64_t round(uint64_t* x, uint64_t* s,
                                              int r) const {
        Mul mul;
        ShflEx<1>()(x, s);
        rpo_lane_mds<1>(ln, s, x, 0, r);
        rpo_pow7_lanes<1>(x, mul);
        ShflEx<1>()(x, s);
        rpo_lane_mds<1>(ln, s, x, 1, r);
        x[0] = ab_pow_inv7<RR, RS>(x[0], mul);
        return x[0];
    }
    __device__ __forceinline__ uint64_t operator()(uint64_t v) const {
        uint64_t s[RPO_WIDTH], x[1] = {v};
        if (RR) {
#pragma unroll 1
            for (int r = 0; r < RPO_ROUNDS; r++) round(x, s, r);
        } else {
#pragma unroll
            for (int r = 0; r < RPO_ROUNDS; r++) round(x, s, r);
        }
        return gl_canon(x[0]);
    }
};

template <bool RR, bool RS>
__global__ void __launch_bounds__(32)
ab_rpo_parts_loops_kernel(const uint8_t* seed, const uint8_t* root,
                          int64_t k, int64_t N, uint8_t* seed_out,
                          uint64_t* draws, uint64_t* pw, long long* stamps) {
    __shared__ uint64_t rc[2 * RPO_ROUNDS * RPO_WIDTH];
    const RpoLane<1> ln(threadIdx.x % rpo_group_lanes<1>(), rc_to_shared(rc));
    if (threadIdx.x == 0) ClockMark::stamp(stamps);
    StampWarp w;
    stamped_rpo_warp(seed, root, k, N, threadIdx.x,
                     AbLoopPerm<RR, RS, gl_mul_wide_fn>{ln}, w, seed_out,
                     draws, pw, ClockMark{stamps, (int)threadIdx.x});
}

// the new step with the permutation's rounds as a loop (rounds), or its
// runs of squarings (squarings)
MS_API int ab_rpo_parts_rounds(const uint8_t* seed, const uint8_t* root,
                               int64_t k, int64_t N, uint8_t* seed_out,
                               uint64_t* draws, uint64_t* pw,
                               long long* stamps, cudaStream_t stream) {
    ab_rpo_parts_loops_kernel<true, false><<<1, 32, 0, stream>>>(
        seed, root, k, N, seed_out, draws, pw, stamps);
    return ms_last_error();
}

MS_API int ab_rpo_parts_squarings(const uint8_t* seed, const uint8_t* root,
                                  int64_t k, int64_t N, uint8_t* seed_out,
                                  uint64_t* draws, uint64_t* pw,
                                  long long* stamps, cudaStream_t stream) {
    ab_rpo_parts_loops_kernel<false, true><<<1, 32, 0, stream>>>(
        seed, root, k, N, seed_out, draws, pw, stamps);
    return ms_last_error();
}
