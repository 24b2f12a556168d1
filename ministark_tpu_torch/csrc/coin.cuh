// The Fiat-Shamir coin step between two FRI layers, on the device: reseed
// with a layer's Merkle root, then the first k field draws after it, and
// the powers of the drawn alpha that the next fold weighs its
// coefficients by.
// Shared by the CUDA kernels (csrc/coin.cu, nvcc, sm_90a) and by host C++
// (g++, the CPU tests).  The host coin (random.py `PublicCoin`) is the
// source of truth; these replay its two operations:
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
// Seeds and roots are 32 digest bytes, read byte by byte (any alignment).
// The powers alpha^0 .. alpha^(N-1) of an Fp alpha (k = 1, draws[0]) or
// an Fq3 alpha (k = 3, the components draws[0..3)) are written
// component-major, pw[c * N + j], when N > 0.
#pragma once

#include "goldilocks.cuh"
#include "rpo256.cuh"
#include "rpo256_lanes.cuh"
#include "sha256.cuh"

#define COIN_R_INV 0xFFFFFFFE00000001ULL  // (2^64 mod p)^-1 mod p

// u64 i (i = 0..3) of a digest's popped byte stream: digest bytes
// 31 - 8i .. 24 - 8i, big-endian, the little-endian value of bytes
// 24 - 8i .. 31 - 8i; from its eight big-endian words st
GL_HD uint64_t coin_sha_popped(const uint32_t st[8], int i) {
    return (uint64_t)sha256_bswap(st[7 - 2 * i]) << 32
           | sha256_bswap(st[6 - 2 * i]);
}

// the draws one digest (words d) gives, in pop order, appended to
// draws[got..k): an accepted u64 (u < p) as u R^-1, a rejected one skipped
GL_HD void coin_sha_take(const uint32_t d[8], int64_t k, int64_t& got,
                         uint64_t* draws) {
    for (int i = 0; i < 4 && got < k; i++) {
        const uint64_t u = coin_sha_popped(d, i);
        if (u < GL_P) draws[got++] = gl_mul(u, COIN_R_INV);
    }
}

GL_HD void coin_load_words(const uint8_t* p, uint32_t* w) {
    for (int k = 0; k < 8; k++)
        w[k] = (uint32_t)p[4 * k] << 24 | (uint32_t)p[4 * k + 1] << 16
               | (uint32_t)p[4 * k + 2] << 8 | p[4 * k + 3];
}

GL_HD void coin_store_words(uint8_t* p, const uint32_t* w) {
    for (int k = 0; k < 8; k++)
        for (int b = 0; b < 4; b++)
            p[4 * k + b] = (uint8_t)(w[k] >> (24 - 8 * b));
}

// alpha^j for j < N, alpha = a[0] (k = 1) or (a[0], a[1], a[2]) (k = 3),
// component-major: pw[c * N + j]
GL_HD void coin_alpha_powers(const uint64_t* a, int64_t k, int64_t N,
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
GL_HD void coin_sha_step(const uint8_t* seed, const uint8_t* root, int64_t k,
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
        coin_sha_take(d, k, got, draws);
    }
    if (N > 0) coin_alpha_powers(draws, k, N, pw);
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

// The RPO-256 coin step, run by `groups` groups at once, this one group
// `group`: seed_out = merge(seed, root), then draws[0..k) the first k
// draws after it, and alpha's first N powers into pw (k = 1 or 3: group
// 0's first digest holds alpha).  perm(s) permutes the whole 12-element state s in place
// (every lane of a group holds all of it).  Group g computes the digests
// of counters 1 + g, 1 + g + groups, ..; every group runs the same number
// of permutations (a group's lanes exchange with shuffles), and `writer`
// marks the one lane of each group that stores.
template <class Perm>
GL_HD void coin_rpo_step(const uint8_t* seed, const uint8_t* root, int64_t k,
                         int64_t N, int group, int groups, bool writer,
                         uint8_t* seed_out, uint64_t* draws, uint64_t* pw,
                         Perm perm) {
    uint64_t s[RPO_WIDTH], sd[RPO_DIGEST];
    for (int j = 0; j < RPO_CAPACITY; j++) s[j] = 0;
    coin_load_elems(seed, s + RPO_CAPACITY);
    coin_load_elems(root, s + RPO_CAPACITY + RPO_DIGEST);
    perm(s);
    for (int j = 0; j < RPO_DIGEST; j++) sd[j] = s[RPO_CAPACITY + j];
    if (writer && group == 0) coin_store_elems(seed_out, sd);
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
    if (N > 0 && writer && group == 0) coin_alpha_powers(draws, k, N, pw);
}

// perm for coin_rpo_step on one thread: the whole permutation
struct CoinRpoPerm {
    GL_FN void operator()(uint64_t* s) const { rpo_permute(s); }
};

// perm for coin_rpo_step on a group of lanes, one element a lane
// (rpo256_lanes.cuh): each lane takes its element of s, the group runs the
// permutation, and the exchange hands every lane the whole state again.
// ex(v, s) is the group's exchange (__shfl_sync on the card).
template <class Ex, class Mul>
struct CoinRpoGroupPerm {
    RpoLane<1> ln;
    Ex ex;
    Mul mul;
    GL_FN void operator()(uint64_t* s) const {
        uint64_t v[1] = {ln.elem(0) < RPO_WIDTH ? s[ln.elem(0)] : 0};
        rpo_permute_lanes<1>(ln, v, ex, mul);
        ex(v, s);
    }
};
