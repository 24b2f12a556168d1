// SHA-256 (FIPS 180-4) of word-aligned messages, shared by kernel D
// (csrc/sha256.cu, nvcc, sm_90a) and by host C++ (g++, the CPU tests):
// the compression, the padded message, the constant schedule of a block
// that is wholly padding, Merkle merges, the proof-of-work grind's
// midstate and leading-zero count, and the step that builds the levels of
// a Merkle tree near its root in one block.
//
// Words are SHA's big-endian 32-bit words; digests leave as their 32
// standard bytes.  A block made wholly of padding (every merge's second
// block, the last block of a row of 8k elements) has a schedule that
// depends only on the message length, so it runs as 64 rounds on K[t] +
// W[t] computed once a launch (`Sha256KW`), as the JAX package's
// `_sha_kernel` takes `const_scheds` (sha256_pallas.py:38-90).  The grind
// message (seed || 8-byte big-endian nonce) is one block whose first 8
// words are the seed, so rounds 0-7 run once a launch (`Sha256GrindSeed`).
#pragma once

#include <stdint.h>
#ifndef __CUDA_ARCH__
#include <string.h>
#endif

#ifdef __CUDACC__
#define SHA_HD __host__ __device__ __forceinline__
#else
#define SHA_HD static inline
#endif

#define SHA256_K_INIT { \
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, \
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, \
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786, \
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA, \
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, \
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, \
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B, \
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070, \
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, \
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, \
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2}

static const uint32_t sha256_k_host[64] = SHA256_K_INIT;
#ifdef __CUDACC__
__constant__ uint32_t sha256_k_dev[64] = SHA256_K_INIT;
#endif

SHA_HD uint32_t sha256_k(int t) {
#ifdef __CUDA_ARCH__
    return sha256_k_dev[t];
#else
    return sha256_k_host[t];
#endif
}

SHA_HD uint32_t sha256_rotr(uint32_t x, int n) {
#ifdef __CUDA_ARCH__
    return __funnelshift_r(x, x, n);
#else
    return (x >> n) | (x << (32 - n));
#endif
}

SHA_HD uint32_t sha256_bswap(uint32_t x) {
#ifdef __CUDA_ARCH__
    return __byte_perm(x, 0, 0x0123);
#else
    return __builtin_bswap32(x);
#endif
}

SHA_HD void sha256_init(uint32_t st[8]) {
    st[0] = 0x6A09E667; st[1] = 0xBB67AE85; st[2] = 0x3C6EF372;
    st[3] = 0xA54FF53A; st[4] = 0x510E527F; st[5] = 0x9B05688C;
    st[6] = 0x1F83D9AB; st[7] = 0x5BE0CD19;
}

// one round on the working state s = (a, .., h); kw = K[t] + W[t]
SHA_HD void sha256_round(uint32_t s[8], uint32_t kw) {
    const uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
    const uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
    const uint32_t S1 =
        sha256_rotr(e, 6) ^ sha256_rotr(e, 11) ^ sha256_rotr(e, 25);
    const uint32_t ch = g ^ (e & (f ^ g));
    const uint32_t t1 = h + S1 + ch + kw;
    const uint32_t S0 =
        sha256_rotr(a, 2) ^ sha256_rotr(a, 13) ^ sha256_rotr(a, 22);
    const uint32_t maj = (a & b) | ((a | b) & c);
    s[7] = g; s[6] = f; s[5] = e; s[4] = d + t1;
    s[3] = c; s[2] = b; s[1] = a; s[0] = t1 + S0 + maj;
}

// schedule word t >= 16, in place in the rolling 16-word window w
SHA_HD uint32_t sha256_sched(uint32_t w[16], int t) {
    const uint32_t w15 = w[(t + 1) & 15], w2 = w[(t + 14) & 15];
    const uint32_t s0 =
        sha256_rotr(w15, 7) ^ sha256_rotr(w15, 18) ^ (w15 >> 3);
    const uint32_t s1 =
        sha256_rotr(w2, 17) ^ sha256_rotr(w2, 19) ^ (w2 >> 10);
    return w[t & 15] += s0 + w[(t + 9) & 15] + s1;
}

// rounds T0 .. 63 of the block whose words are w (its schedule rolled in
// w), on the working state s
template <int T0>
SHA_HD void sha256_rounds(uint32_t s[8], uint32_t w[16]) {
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int t = T0; t < 64; t++)
        sha256_round(s, sha256_k(t) + (t < 16 ? w[t] : sha256_sched(w, t)));
}

SHA_HD void sha256_compress(uint32_t st[8], uint32_t w[16]) {
    uint32_t s[8];
    for (int k = 0; k < 8; k++) s[k] = st[k];
    sha256_rounds<0>(s, w);
    for (int k = 0; k < 8; k++) st[k] += s[k];
}

// a block whose K[t] + W[t] are given: no schedule to compute
SHA_HD void sha256_compress_kw(uint32_t st[8], const uint32_t* kw) {
    uint32_t s[8];
    for (int k = 0; k < 8; k++) s[k] = st[k];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int t = 0; t < 64; t++) sha256_round(s, kw[t]);
    for (int k = 0; k < 8; k++) st[k] += s[k];
}

// The padded message of W words: its data blocks (the first data_words(W)
// words, the padding that follows the data in the last of them) and, where
// total_words(W) is larger, one more block that is wholly padding.
SHA_HD int64_t sha256_total_words(int64_t W) { return (W + 3 + 15) / 16 * 16; }
SHA_HD int64_t sha256_data_words(int64_t W) { return (W + 15) / 16 * 16; }

// word t >= W of the padded message: 0x80000000, zeros, the bit length
SHA_HD uint32_t sha256_pad_word(int64_t W, int64_t t) {
    const int64_t total = sha256_total_words(W);
    const uint64_t bitlen = (uint64_t)W * 32;
    if (t == W) return 0x80000000u;
    if (t == total - 2) return (uint32_t)(bitlen >> 32);
    if (t == total - 1) return (uint32_t)bitlen;
    return 0;
}

// K[t] + W[t] of the block of a W-word message that is wholly padding
// (where total_words(W) > data_words(W)): computed once a launch
struct Sha256KW {
    uint32_t kw[64];
};

SHA_HD Sha256KW sha256_pad_kw(int64_t W) {
    Sha256KW p;
    uint32_t w[16];
    const int64_t base = sha256_data_words(W);
    for (int k = 0; k < 16; k++) w[k] = sha256_pad_word(W, base + k);
    for (int t = 0; t < 64; t++)
        p.kw[t] = sha256_k(t) + (t < 16 ? w[t] : sha256_sched(w, t));
    return p;
}

// SHA-256 of the W-word message whose word t is word(t); pad: sha256_pad_kw(W)
template <class Word>
SHA_HD void sha256_message(Word word, int64_t W, const uint32_t* pad,
                           uint32_t st[8]) {
    sha256_init(st);
    const int64_t data = sha256_data_words(W);
    for (int64_t blk = 0; blk < data; blk += 16) {
        uint32_t w[16];
        if (blk + 16 <= W) {
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
            for (int k = 0; k < 16; k++) w[k] = word(blk + k);
        } else {
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
            for (int k = 0; k < 16; k++) {
                const int64_t t = blk + k;
                w[k] = t < W ? word(t) : sha256_pad_word(W, t);
            }
        }
        sha256_compress(st, w);
    }
    if (sha256_total_words(W) > data) sha256_compress_kw(st, pad);
}

// 32 digest bytes <-> 8 words
SHA_HD void sha256_load_digest(const uint8_t* p, uint32_t* w) {
#ifdef __CUDA_ARCH__
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
    for (int k = 0; k < 8; k++) w[k] = sha256_bswap(q[k]);
#else
    uint32_t q[8];
    memcpy(q, p, 32);
    for (int k = 0; k < 8; k++) w[k] = sha256_bswap(q[k]);
#endif
}

SHA_HD void sha256_store_digest(uint8_t* p, const uint32_t st[8]) {
#ifdef __CUDA_ARCH__
    uint4* o = reinterpret_cast<uint4*>(p);
    o[0] = make_uint4(sha256_bswap(st[0]), sha256_bswap(st[1]),
                      sha256_bswap(st[2]), sha256_bswap(st[3]));
    o[1] = make_uint4(sha256_bswap(st[4]), sha256_bswap(st[5]),
                      sha256_bswap(st[6]), sha256_bswap(st[7]));
#else
    uint32_t q[8];
    for (int k = 0; k < 8; k++) q[k] = sha256_bswap(st[k]);
    memcpy(p, q, 32);
#endif
}

// a Merkle merge: sha256 of the 16 words w (left || right); pad:
// sha256_pad_kw(16)
SHA_HD void sha256_merge_words(uint32_t w[16], const uint32_t* pad,
                               uint32_t st[8]) {
    sha256_init(st);
    sha256_compress(st, w);
    sha256_compress_kw(st, pad);
}

// -- proof of work -----------------------------------------------------------

// The grind's seed: its 8 words and the working state after rounds 0-7,
// which read only those words.
struct Sha256GrindSeed {
    uint32_t w[8];
    uint32_t mid[8];
};

SHA_HD Sha256GrindSeed sha256_grind_seed(const uint8_t seed[32]) {
    Sha256GrindSeed g;
    for (int k = 0; k < 8; k++)
        g.w[k] = (uint32_t)seed[4 * k] << 24 | (uint32_t)seed[4 * k + 1] << 16
                 | (uint32_t)seed[4 * k + 2] << 8 | seed[4 * k + 3];
    sha256_init(g.mid);
    for (int t = 0; t < 8; t++) sha256_round(g.mid, sha256_k(t) + g.w[t]);
    return g;
}

// digest words of sha256(seed || nonce as 8 big-endian bytes): words 8-9
// are the nonce's halves, 10-15 the padding of a 40-byte message; rounds
// 8-63 from the seed's state
SHA_HD void sha256_grind_digest(const Sha256GrindSeed& g, uint64_t nonce,
                                uint32_t st[8]) {
    uint32_t w[16];
    for (int k = 0; k < 8; k++) w[k] = g.w[k];
    w[8] = (uint32_t)(nonce >> 32);
    w[9] = (uint32_t)nonce;
    w[10] = 0x80000000u;
    w[11] = w[12] = w[13] = w[14] = 0;
    w[15] = 320;
    uint32_t s[8];
    for (int k = 0; k < 8; k++) s[k] = g.mid[k];
    sha256_rounds<8>(s, w);
    sha256_init(st);
    for (int k = 0; k < 8; k++) st[k] += s[k];
}

// leading zero bits of a digest's bytes (hash.leading_zeros)
SHA_HD int sha256_leading_zeros(const uint32_t st[8]) {
    for (int k = 0; k < 8; k++) {
        if (st[k] != 0) {
#ifdef __CUDA_ARCH__
            return 32 * k + __clz(st[k]);
#else
            return 32 * k + __builtin_clz(st[k]);
#endif
        }
    }
    return 256;
}

// -- the levels of a tree near its root ----------------------------------------

// Every level above a level `in` of m digests (m a power of two, >= 2),
// built by m/2 threads of one block: level h (h = m/2, m/4, .., 1 nodes)
// merges the two halves of the level below, node i = merge(below[i],
// below[i + h]), and is written to out after the levels before it, so out
// holds m - 1 digests.  Thread t merges node t of every level that has
// one and keeps its digest in `sm` (2 * 8 * (m/2) words, two levels)
// word-major: word k of node i at k * (m/2) + i, so a warp's nodes read
// and write 32 consecutive words, one a bank.  sync() is the block's
// barrier between levels.
template <class Sync>
SHA_HD void sha256_tree_tops(const uint8_t* in, uint8_t* out, int64_t m,
                             int64_t t, uint32_t* sm, const uint32_t* pad,
                             Sync sync) {
    const int64_t half = m / 2;
    uint32_t* cur = sm;
    uint32_t* below = sm + 8 * half;
    for (int64_t h = half; h >= 1; h /= 2) {
        if (t < h) {
            uint32_t w[16], st[8];
            if (h == half) {
                sha256_load_digest(in + 32 * t, w);
                sha256_load_digest(in + 32 * (t + h), w + 8);
            } else {
                for (int k = 0; k < 8; k++) {
                    w[k] = below[k * half + t];
                    w[8 + k] = below[k * half + t + h];
                }
            }
            sha256_merge_words(w, pad, st);
            for (int k = 0; k < 8; k++) cur[k * half + t] = st[k];
            sha256_store_digest(out + 32 * t, st);
        }
        sync();
        uint32_t* tmp = below;
        below = cur;
        cur = tmp;
        out += 32 * h;
    }
}
