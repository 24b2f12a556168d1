// RPO-256 with one state spread over a group of lanes: the schedule of
// kernel G (csrc/rpo256.cu: row hashes, merges, the tree tops, the grind),
// shared by the CUDA kernels (nvcc, sm_90a) and by host C++ (g++, the CPU
// tests), which runs each lane as a thread and emulates the exchange.
//
// Why: one state a thread (rpo_permute in rpo256.cuh) runs each round's
// twelve x^(1/7) chains of 72 dependent products in one thread, so a
// launch with fewer states than the card holds threads takes a whole
// permutation's latency.  Here lane l of a group of G owns the E state elements l * E .. l * E +
// E - 1 (E = 1: 12 of 16 lanes, 4 idle; E = 3: 4 lanes), runs their
// S-boxes (the E chains interleaved, so a lane has E independent
// products in flight), and gathers the whole state from its group before
// each MDS layer (the exchange: `__shfl_sync` within the group on the
// card), of which it computes its own E rows.  A permutation's critical
// path is then E chains, not twelve.
//
// Each lane keeps its MDS rows as coefficients in registers (row m of the
// circulant at element n is row[(n - m) % 12]), so the state is always
// indexed by constants, and reads its round constants from a table the
// caller passes (shared memory on the card), since lanes read different
// ones.  Products are lazy (any u64 congruent to the value, gl_mul_cc_lazy
// on the card) inside the S-boxes; the MDS takes any u64 and returns
// canonical values, and the state leaves the permutation canonical.
#pragma once

#include "rpo256.cuh"

#ifdef __CUDACC__
#define RPO_CX __host__ __device__ constexpr
#else
#define RPO_CX constexpr
#endif

// lanes of a group for E elements a lane (E = 1 or 3)
template <int E>
RPO_CX int rpo_group_lanes() {
    return E == 1 ? 16 : 4;
}

// The constants one lane needs: its E rows of the MDS matrix (zero rows
// for the elements an idle lane stands for) and the round constants
// rc[which][round][m] of the whole state.
template <int E>
struct RpoLane {
    uint32_t coef[E][RPO_WIDTH];
    const uint64_t* rc;  // 2 x RPO_ROUNDS x RPO_WIDTH canonical values
    int lane;

    GL_FN RpoLane(int lane_, const uint64_t* rc_) : rc(rc_), lane(lane_) {
#pragma unroll
        for (int e = 0; e < E; e++) {
            const int m = lane * E + e;
#pragma unroll
            for (int n = 0; n < RPO_WIDTH; n++)
                coef[e][n] = m < RPO_WIDTH
                                 ? rpo_mds_row((n - m + RPO_WIDTH) % RPO_WIDTH)
                                 : 0;
        }
    }

    // element index of the lane's e-th value (>= 12 for an idle lane)
    GL_FN int elem(int e) const { return lane * E + e; }
};

// v[e] = (MDS s)[m] + rc[which][round][m] for the lane's elements m, from
// the whole state s (any u64 values), canonical
template <int E>
GL_HD void rpo_lane_mds(const RpoLane<E>& ln, const uint64_t* s, uint64_t* v,
                        int which, int round) {
#pragma unroll
    for (int e = 0; e < E; e++) {
        uint64_t lo = 0, hi = 0;  // each < 12 * 26 * 2^32 < 2^41
#pragma unroll
        for (int n = 0; n < RPO_WIDTH; n++) {
            lo += (uint64_t)ln.coef[e][n] * (uint32_t)s[n];
            hi += (uint64_t)ln.coef[e][n] * (uint32_t)(s[n] >> 32);
        }
        const uint64_t l = lo + (hi << 32);
        const uint64_t h = (hi >> 32) + (l < lo ? 1 : 0);
        const int m = ln.elem(e) < RPO_WIDTH ? ln.elem(e) : 0;
        v[e] = gl_add(gl_reduce128(l, h),
                      ln.rc[(which * RPO_ROUNDS + round) * RPO_WIDTH + m]);
    }
}

// x^(2^k) for E values at once (lazy)
template <int E, class Mul>
GL_HD void rpo_sqr_n_lanes(uint64_t* x, int k, Mul mul) {
    for (int i = 0; i < k; i++) {
#pragma unroll
        for (int e = 0; e < E; e++) x[e] = mul.sqr(x[e]);
    }
}

// x^7 of E values (lazy)
template <int E, class Mul>
GL_HD void rpo_pow7_lanes(uint64_t* x, Mul mul) {
#pragma unroll
    for (int e = 0; e < E; e++) {
        const uint64_t x3 = mul.lazy(mul.sqr(x[e]), x[e]);
        x[e] = mul.lazy(mul.sqr(x3), x[e]);
    }
}

// x^(1/7) of E values (lazy): rpo_pow_inv7's chain, the E chains step by
// step side by side
template <int E, class Mul>
GL_HD void rpo_pow_inv7_lanes(uint64_t* x, Mul mul) {
    uint64_t t1[E], t2[E], t3[E], t4[E], t6[E], a[E];
#pragma unroll
    for (int e = 0; e < E; e++) {
        t1[e] = mul.sqr(x[e]);                             // x^2
        a[e] = t2[e] = mul.sqr(t1[e]);                     // x^4
    }
    rpo_sqr_n_lanes<E>(a, 3, mul);
#pragma unroll
    for (int e = 0; e < E; e++) a[e] = t3[e] = mul.lazy(a[e], t2[e]);
    rpo_sqr_n_lanes<E>(a, 6, mul);
#pragma unroll
    for (int e = 0; e < E; e++) a[e] = t4[e] = mul.lazy(a[e], t3[e]);
    rpo_sqr_n_lanes<E>(a, 12, mul);
#pragma unroll
    for (int e = 0; e < E; e++) a[e] = mul.lazy(a[e], t4[e]);   // t5
    rpo_sqr_n_lanes<E>(a, 6, mul);
#pragma unroll
    for (int e = 0; e < E; e++) a[e] = t6[e] = mul.lazy(a[e], t3[e]);
    rpo_sqr_n_lanes<E>(a, 31, mul);
#pragma unroll
    for (int e = 0; e < E; e++) {
        a[e] = mul.lazy(a[e], t6[e]);                      // t7
        a[e] = mul.lazy(mul.sqr(a[e]), t6[e]);
    }
    rpo_sqr_n_lanes<E>(a, 2, mul);
#pragma unroll
    for (int e = 0; e < E; e++)
        x[e] = mul.lazy(a[e], mul.lazy(mul.lazy(t1[e], t2[e]), x[e]));
}

// The permutation of the group's state, lane `ln.lane`'s E values v in
// place (canonical in, canonical out).  ex(v, s) is the exchange: every
// lane of the group hands in its v and receives the whole state s, in
// element order; every lane must call it at the same point.
template <int E, class Ex, class Mul>
GL_HD void rpo_permute_lanes(const RpoLane<E>& ln, uint64_t* v, Ex ex,
                             Mul mul) {
    uint64_t s[RPO_WIDTH];
    for (int r = 0; r < RPO_ROUNDS; r++) {
        ex(v, s);
        rpo_lane_mds<E>(ln, s, v, 0, r);
        rpo_pow7_lanes<E>(v, mul);
        ex(v, s);
        rpo_lane_mds<E>(ln, s, v, 1, r);
        rpo_pow_inv7_lanes<E>(v, mul);
    }
#pragma unroll
    for (int e = 0; e < E; e++) v[e] = gl_canon(v[e]);
}

#ifdef __CUDACC__
// a group's exchange on the card: 64-bit shuffles within its G lanes
template <int E>
struct ShflEx {
    __device__ __forceinline__ void operator()(const uint64_t* v,
                                               uint64_t* s) const {
        constexpr int G = rpo_group_lanes<E>();
#pragma unroll
        for (int k = 0; k < RPO_WIDTH; k++)
            s[k] = __shfl_sync(0xFFFFFFFFu, (unsigned long long)v[k % E],
                               k / E, G);
    }
};

// the round constants copied to shared memory: the lanes of a group read
// different ones, which __constant__ memory would serialise
__device__ __forceinline__ const uint64_t* rc_to_shared(uint64_t* sm) {
    const uint64_t* rc = &rpo_rc_dev[0][0][0];
    for (int i = threadIdx.x; i < 2 * RPO_ROUNDS * RPO_WIDTH; i += blockDim.x)
        sm[i] = rc[i];
    __syncthreads();
    return sm;
}
#endif

// -- the group's part of each entry point ------------------------------------

// a merge's state [0, 0, 0, 0 | left | right] (two 4-element digests)
template <int E>
GL_HD void rpo_lanes_load_merge(const RpoLane<E>& ln, uint64_t* v,
                                const uint64_t* left,
                                const uint64_t* right) {
#pragma unroll
    for (int e = 0; e < E; e++) {
        const int k = ln.elem(e);
        v[e] = k < RPO_CAPACITY ? 0
             : k < RPO_CAPACITY + RPO_DIGEST ? left[k - RPO_CAPACITY]
             : k < RPO_WIDTH ? right[k - RPO_CAPACITY - RPO_DIGEST] : 0;
    }
}

// the digest, state[4..8], to out[0..4)
template <int E>
GL_HD void rpo_lanes_store_digest(const RpoLane<E>& ln, const uint64_t* v,
                                  uint64_t* out) {
#pragma unroll
    for (int e = 0; e < E; e++) {
        const int k = ln.elem(e);
        if (k >= RPO_CAPACITY && k < RPO_CAPACITY + RPO_DIGEST)
            out[k - RPO_CAPACITY] = v[e];
    }
}

// one row's digest (hash_rpo.hash_elements, as rpo_hash_rows_kernel) into
// the lane's v: ncols elements row[c * cs] absorbed RATE at a time, padded
// with one 1 and zeros when ncols % 8 != 0 (and then capacity[0] = 1)
template <int E, class Ex, class Mul>
GL_HD void rpo_lanes_hash_row(const RpoLane<E>& ln, uint64_t* v,
                              const uint64_t* row, int64_t ncols, int64_t cs,
                              Ex ex, Mul mul) {
#pragma unroll
    for (int e = 0; e < E; e++)
        v[e] = ln.elem(e) == 0 && (ncols % RPO_RATE) ? 1 : 0;
    for (int64_t c0 = 0; c0 < ncols; c0 += RPO_RATE) {
#pragma unroll
        for (int e = 0; e < E; e++) {
            const int k = ln.elem(e);
            if (k >= RPO_CAPACITY && k < RPO_WIDTH) {
                const int64_t c = c0 + k - RPO_CAPACITY;
                v[e] = c < ncols ? row[c * cs] : (c == ncols ? 1 : 0);
            }
        }
        rpo_permute_lanes<E>(ln, v, ex, mul);
    }
}

// a proof-of-work state [1, 0, 0, 0 | seed | lo32, hi32, 1, 0]
// (hash_rpo.merge_with_int, as rpo_grind_kernel)
template <int E>
GL_HD void rpo_lanes_load_grind(const RpoLane<E>& ln, uint64_t* v,
                                const uint64_t* seed, uint64_t nonce) {
#pragma unroll
    for (int e = 0; e < E; e++) {
        const int k = ln.elem(e);
        v[e] = k == 0 || k == 10 ? 1
             : k >= RPO_CAPACITY && k < RPO_CAPACITY + RPO_DIGEST
                 ? seed[k - RPO_CAPACITY]
             : k == 8 ? nonce & 0xFFFFFFFFULL : k == 9 ? nonce >> 32 : 0;
    }
}

// Every level above a tree level of m digests (m a power of two, >= 2),
// built by one block: level h (h = m/2, m/4, .., 1 nodes) merges the two
// halves of the level below, node i = merge(below[i], below[i + h]), and
// is written to out after the levels above m's before it, so out holds
// m - 1 digests.  Group `group` of the block merges node `group` of each
// level whose nodes reach its warp (`warp_first`: the warp's first group;
// a warp's groups run together, the ones past the level's end on a copy
// of its last node, stored nowhere); sync() is the block's barrier
// between levels.
template <int E, class Ex, class Sync, class Mul>
GL_HD void rpo_lanes_tree_tops(const RpoLane<E>& ln, const uint64_t* in,
                               uint64_t* out, int64_t m, int64_t group,
                               int64_t warp_first, Ex ex, Sync sync,
                               Mul mul) {
    const uint64_t* below = in;
    for (int64_t h = m / 2; h >= 1; h /= 2) {
        if (warp_first < h) {
            const int64_t i = group < h ? group : h - 1;
            uint64_t v[E];
            rpo_lanes_load_merge<E>(ln, v, below + i * RPO_DIGEST,
                                    below + (i + h) * RPO_DIGEST);
            rpo_permute_lanes<E>(ln, v, ex, mul);
            if (group < h)
                rpo_lanes_store_digest<E>(ln, v, out + i * RPO_DIGEST);
        }
        sync();
        below = out;
        out += h * RPO_DIGEST;
    }
}
