// The Fiat-Shamir coin step between two FRI layers, on the device: reseed
// with a layer's Merkle root, then the first k field draws after it, and
// the powers of the drawn alpha that the next fold weighs its
// coefficients by.
// Shared by the CUDA kernels (csrc/coin.cu, nvcc, sm_90a) and by host C++
// (g++, the CPU tests, which run each lane of the warp as a thread).  The
// host coin (random.py `PublicCoin`) is the source of truth; these replay
// its two operations:
//
// SHA-256 coin (hash.py):
//   seed' = sha256(seed || root), the root's 32 bytes as they are;
//   digest c (c = 1, 2, ..) = sha256(seed' || c as 8 big-endian bytes),
//   whose bytes the coin pops from the END, 8 at a time, each u64
//   assembled big-endian: the u64 is the little-endian value of digest
//   bytes 24..31, then 16..23, 8..15, 0..7.  A u64 >= p is rejected (ark's
//   `Fp::rand`), and an accepted one is a Montgomery limb, so the draw is
//   u * R^-1 mod p (R = 2^64).  The loop runs until k draws are accepted,
//   as the host coin does.
// RPO-256 coin (hash_rpo.py):
//   seed' = merge(seed, root): the state [0, 0, 0, 0 | seed | root], no
//   padding flag;
//   digest c = merge_with_int(seed', c): [1, 0, 0, 0 | seed' | c mod 2^32,
//   c >> 32, 1, 0];
//   a digest is four canonical elements, stored little-endian, so the
//   popped u64s are the elements e3, e2, e1, e0: never rejected; the draw
//   is e * R^-1 mod p.
//
// Both steps run on one warp of 32 lanes.  SHA-256: every lane runs the
// reseed (one chain of two compressions), then lane c hashes counter
// 32 r + c + 1 in round r, and a ballot a popped position hands each
// accepted u64 its place in the host coin's pop order, round after round
// until k are accepted: the host loop, run 32 digests wide.  RPO-256: two
// groups of 16 lanes, one state element a lane (rpo256_lanes.cuh), both
// reseeding and group g then taking counter 1 + g; the state stays spread
// over the lanes from the reseed to the draws.  The powers alpha^0 ..
// alpha^(N-1) of an Fp alpha (k = 1, draws[0]) or an Fq3 alpha (k = 3,
// the components draws[0..3)), when N > 0, come from a prefix product over
// the lanes (lane j holds alpha^j after five steps) and are written
// component-major, pw[c * N + j].
//
// Seeds and roots are 32 digest bytes, read byte by byte (any alignment).
// A warp's collectives come in as `Warp` (coin.cu's CoinWarp on the card;
// the CPU tests emulate them): ballot(pred) -> the mask of the lanes whose
// pred holds, shfl(v, lane) -> lane's v, shfl_up(v, d) -> the v of lane
// this - d (this lane's own where that is below 0); every lane calls each
// at the same point.
#pragma once

#include "goldilocks.cuh"
#include "rpo256.cuh"
#include "rpo256_lanes.cuh"
#include "sha256.cuh"

#define COIN_LANES 32

// loops on constant bounds unrolled on the card, so that their arrays stay
// in registers
#ifdef __CUDA_ARCH__
#define COIN_UNROLL _Pragma("unroll")
#else
#define COIN_UNROLL
#endif
#define COIN_R_INV 0xFFFFFFFE00000001ULL  // (2^64 mod p)^-1 mod p

// u64 i (i = 0..3) of a digest's popped byte stream: digest bytes
// 31 - 8i .. 24 - 8i, big-endian, the little-endian value of bytes
// 24 - 8i .. 31 - 8i; from its eight big-endian words st
GL_HD uint64_t coin_sha_popped(const uint32_t st[8], int i) {
    return (uint64_t)sha256_bswap(st[7 - 2 * i]) << 32
           | sha256_bswap(st[6 - 2 * i]);
}

GL_HD void coin_load_words(const uint8_t* p, uint32_t* w) {
    COIN_UNROLL
    for (int k = 0; k < 8; k++)
        w[k] = (uint32_t)p[4 * k] << 24 | (uint32_t)p[4 * k + 1] << 16
               | (uint32_t)p[4 * k + 2] << 8 | p[4 * k + 3];
}

GL_HD void coin_store_words(uint8_t* p, const uint32_t* w) {
    COIN_UNROLL
    for (int k = 0; k < 8; k++)
        for (int b = 0; b < 4; b++)
            p[4 * k + b] = (uint8_t)(w[k] >> (24 - 8 * b));
}

// 32 digest bytes <-> the four little-endian u64 elements of an RPO digest
GL_HD void coin_load_elems(const uint8_t* p, uint64_t* e) {
    for (int k = 0; k < 4; k++) {
        uint64_t v = 0;
        for (int b = 7; b >= 0; b--) v = v << 8 | p[8 * k + b];
        e[k] = v;
    }
}

GL_HD void coin_store_elems(uint8_t* p, const uint64_t* e) {
    for (int k = 0; k < 4; k++)
        for (int b = 0; b < 8; b++) p[8 * k + b] = (uint8_t)(e[k] >> (8 * b));
}

// the state of merge_with_int(seed, counter): [1, 0, 0, 0 | seed |
// counter mod 2^32, counter >> 32, 1, 0]
GL_HD void coin_rpo_draw_state(uint64_t* s, const uint64_t* seed,
                               uint64_t counter) {
    s[0] = 1;
    s[1] = s[2] = s[3] = 0;
    for (int j = 0; j < RPO_DIGEST; j++) s[RPO_CAPACITY + j] = seed[j];
    s[8] = counter & 0xFFFFFFFFULL;
    s[9] = counter >> 32;
    s[10] = 1;
    s[11] = 0;
}

GL_HD int coin_popc(uint32_t m) {
#ifdef __CUDA_ARCH__
    return __popc(m);
#else
    return __builtin_popcount(m);
#endif
}

GL_HD int coin_ffs(uint32_t m) {
#ifdef __CUDA_ARCH__
    return __ffs(m);
#else
    return __builtin_ffs(m);
#endif
}

// Fp or Fq3 alpha as three words (c1 = c2 = 0 for Fp)
GL_HD gl3 coin_alpha_mul(gl3 a, gl3 b, int64_t k) {
    return k == 1 ? gl3_from_base(gl_mul_cc(a.c0, b.c0)) : gl3_mul_cc(a, b);
}

template <class Warp>
GL_HD gl3 coin_shfl3(Warp& w, gl3 v, int lane) {
    return gl3_make(w.shfl(v.c0, lane), w.shfl(v.c1, lane),
                    w.shfl(v.c2, lane));
}

// alpha^j for j < N (alpha = a, k = 1 or 3 words), component-major
// pw[c * N + j]: lane j's alpha^j by a prefix product over the lanes
// ([1, alpha, alpha, ..] in five steps), then alpha^32 a round of 32
template <class Warp>
GL_HD void coin_alpha_powers_warp(gl3 a, int64_t k, int64_t N, int lane,
                                  Warp& w, uint64_t* pw) {
    gl3 v = lane == 0 ? gl3_from_base(1) : a;
    // a loop, not unrolled: the warp runs this code once a launch, and
    // unrolled it is fetched cold step by step
#ifdef __CUDA_ARCH__
#pragma unroll 1
#endif
    for (int d = 1; d < COIN_LANES; d *= 2) {
        const gl3 u = gl3_make(w.shfl_up(v.c0, d), w.shfl_up(v.c1, d),
                               w.shfl_up(v.c2, d));
        if (lane >= d) v = coin_alpha_mul(v, u, k);
    }
    // alpha^32, where N asks for more than a round
    const gl3 a32 = N > COIN_LANES
        ? coin_shfl3(w, coin_alpha_mul(v, a, k), COIN_LANES - 1) : a;
    for (int64_t j = lane; j < N; j += COIN_LANES) {
        pw[j] = v.c0;
        if (k == 3) {
            pw[N + j] = v.c1;
            pw[2 * N + j] = v.c2;
        }
        if (j + COIN_LANES < N) v = coin_alpha_mul(v, a32, k);
    }
}

// The SHA-256 draws of one round, in this lane the four popped u64s u of
// its digest (counter 32 r + lane + 1): each accepted u (u < p) takes the
// place got + (accepted u64s of the lanes below) + (of this lane's before
// it), and the draw u R^-1 goes to draws[place] where place < k; alpha's
// components (places below ka) are handed to every lane.  Returns got
// plus the round's accepted u64s (the same in every lane).
template <class Warp>
GL_HD int64_t coin_sha_select(const uint64_t u[4], int lane, int64_t got,
                              int64_t k, int64_t ka, Warp& w,
                              uint64_t* draws, gl3& alpha) {
    uint32_t bal[4];
    bool ok[4];
    COIN_UNROLL
    for (int i = 0; i < 4; i++) {
        ok[i] = u[i] < GL_P;
        bal[i] = w.ballot(ok[i]);
    }
    const uint32_t below = (1u << lane) - 1;
    int64_t place = got, total = got;
    COIN_UNROLL
    for (int i = 0; i < 4; i++) {
        place += coin_popc(bal[i] & below);
        total += coin_popc(bal[i]);
    }
    int64_t at[4];
    uint64_t val[4];
    COIN_UNROLL
    for (int i = 0; i < 4; i++) {
        at[i] = ok[i] ? place++ : -1;
        val[i] = ok[i] ? gl_mul(u[i], COIN_R_INV) : 0;
        if (ok[i] && at[i] < k) draws[at[i]] = val[i];
    }
    COIN_UNROLL
    for (int c = 0; c < 3; c++) {
        if (c >= ka) break;
        uint64_t mine = 0;
        bool own = false;
        COIN_UNROLL
        for (int i = 0; i < 4; i++)
            if (at[i] == c) {
                mine = val[i];
                own = true;
            }
        const uint32_t m = w.ballot(own);
        if (m) {
            const uint64_t x = w.shfl(mine, coin_ffs(m) - 1);
            if (c == 0) alpha.c0 = x;
            else if (c == 1) alpha.c1 = x;
            else alpha.c2 = x;
        }
    }
    return total;
}

// The SHA-256 coin step, lane `lane` of the warp: seed_out = sha256(seed
// || root), draws[0..k) the first k canonical Fp draws after it, alpha's
// first N powers into pw.  The compressions are unrolled on constant
// indices: the state and schedule stay in registers.
template <class Warp>
GL_HD void coin_sha_warp(const uint8_t* seed, const uint8_t* root, int64_t k,
                         int64_t N, int lane, Warp& w, uint8_t* seed_out,
                         uint64_t* draws, uint64_t* pw) {
    uint32_t m[16], st[8];
    coin_load_words(seed, m);
    coin_load_words(root, m + 8);
    sha256_init(st);
    sha256_compress(st, m);
    // the second block, padding alone: 0x80000000, zeros, the bit length
    uint32_t pad[16] = {0x80000000u, 0, 0, 0, 0, 0, 0, 0,
                        0, 0, 0, 0, 0, 0, 0, 512};
    sha256_compress(st, pad);
    if (lane == 0) coin_store_words(seed_out, st);
    // the digests sha256(seed' || counter) share rounds 0-7: the grind's
    // message layout (seed || 8-byte big-endian nonce)
    Sha256GrindSeed g;
    COIN_UNROLL
    for (int j = 0; j < 8; j++) g.w[j] = st[j];
    sha256_init(g.mid);
    COIN_UNROLL
    for (int t = 0; t < 8; t++) sha256_round(g.mid, sha256_k(t) + g.w[t]);
    const int64_t ka = N > 0 ? k : 0;
    gl3 alpha = gl3_from_base(0);
    int64_t got = 0;
    for (uint64_t base = 1; got < k; base += COIN_LANES) {
        uint32_t d[8];
        sha256_grind_digest(g, base + lane, d);
        uint64_t u[4];
        COIN_UNROLL
        for (int i = 0; i < 4; i++) u[i] = coin_sha_popped(d, i);
        got = coin_sha_select(u, lane, got, k, ka, w, draws, alpha);
    }
    if (N > 0) coin_alpha_powers_warp(alpha, k, N, lane, w, pw);
}

// perm for coin_rpo_warp: the permutation of the group's state, this lane's
// element v (rpo256_lanes.cuh, one element a lane), ex the group's
// exchange (__shfl_sync on the card), products Mul
template <class Ex, class Mul>
struct CoinRpoPerm {
    RpoLane<1> ln;
    Ex ex;
    GL_FN uint64_t operator()(uint64_t v) const {
        uint64_t x[1] = {v};
        rpo_permute_lanes<1>(ln, x, ex, Mul());
        return x[0];
    }
};

// The RPO-256 coin step's reseed, warp lane `lane` (group lane / 16,
// state element lane % 16, idle from 12): seed_out = merge(seed, root);
// returns this lane's element of the permuted state (seed' element e - 4
// where e is a digest lane).  perm(v) permutes the group's state, this
// lane's element v (CoinRpoPerm).
template <class Perm>
GL_HD uint64_t coin_rpo_reseed(const uint8_t* seed, const uint8_t* root,
                               int lane, Perm perm, uint8_t* seed_out) {
    constexpr int G = rpo_group_lanes<1>();
    const int group = lane / G, e = lane % G;
    uint64_t v = 0;
    if (e >= RPO_CAPACITY && e < RPO_WIDTH) {
        uint64_t el[RPO_DIGEST];
        coin_load_elems(e < RPO_CAPACITY + RPO_DIGEST ? seed : root, el);
        const int d = (e - RPO_CAPACITY) % RPO_DIGEST;
        v = d == 0 ? el[0] : d == 1 ? el[1] : d == 2 ? el[2] : el[3];
    }
    const uint64_t sd = perm(v);
    if (group == 0 && e >= RPO_CAPACITY && e < RPO_CAPACITY + RPO_DIGEST)
        for (int b = 0; b < 8; b++)
            seed_out[8 * (e - RPO_CAPACITY) + b] = (uint8_t)(sd >> (8 * b));
    return sd;
}

// The step's draws after the reseed (sd: coin_rpo_reseed's element):
// draws[0..k) the first k draws after it (group g takes counters 1 + g,
// 3 + g, ..); returns alpha (k = 1 or 3: group 0's first digest holds it,
// elements 7, 6, 5) in every lane where N > 0
template <class Perm, class Warp>
GL_HD gl3 coin_rpo_draws(uint64_t sd, int64_t k, int64_t N, int lane,
                         Perm perm, Warp& w, uint64_t* draws) {
    constexpr int G = rpo_group_lanes<1>(), groups = COIN_LANES / G;
    const int group = lane / G, e = lane % G;
    const bool dig = e >= RPO_CAPACITY && e < RPO_CAPACITY + RPO_DIGEST;
    const int64_t digests = (k + RPO_DIGEST - 1) / RPO_DIGEST;
    gl3 alpha = gl3_from_base(0);
    for (int64_t r = 0; r * groups < digests; r++) {
        const uint64_t counter = 1 + (uint64_t)(r * groups + group);
        const uint64_t v = e == 0 || e == 10 ? 1 : dig ? sd
          : e == 8 ? counter & 0xFFFFFFFFULL : e == 9 ? counter >> 32 : 0;
        // element e holds digest element e - 4, popped as draw 7 - e
        const uint64_t val = gl_mul(perm(v), COIN_R_INV);
        const int64_t j = (int64_t)(counter - 1) * RPO_DIGEST
                          + (RPO_CAPACITY + RPO_DIGEST - 1 - e);
        if (dig && j < k) draws[j] = val;
        if (r == 0 && N > 0) {
            alpha.c0 = w.shfl(val, 7);
            if (k == 3) {
                alpha.c1 = w.shfl(val, 6);
                alpha.c2 = w.shfl(val, 5);
            }
        }
    }
    return alpha;
}

// The RPO-256 coin step: the reseed, the draws, alpha's first N powers
// into pw (scripts/coin_single.cu stamps the three parts apart)
template <class Perm, class Warp>
GL_HD void coin_rpo_warp(const uint8_t* seed, const uint8_t* root, int64_t k,
                         int64_t N, int lane, Perm perm, Warp& w,
                         uint8_t* seed_out, uint64_t* draws, uint64_t* pw) {
    const uint64_t sd = coin_rpo_reseed(seed, root, lane, perm, seed_out);
    const gl3 alpha = coin_rpo_draws(sd, k, N, lane, perm, w, draws);
    if (N > 0) coin_alpha_powers_warp(alpha, k, N, lane, w, pw);
}
