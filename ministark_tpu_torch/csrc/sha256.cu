// Kernel D: batched SHA-256, one message per thread: Merkle row digests of
// Goldilocks rows and 64-byte Merkle merges.
//
// Replaces ministark_tpu/ops/sha256_pallas.py `_sha_kernel` (wrappers
// `hash_rows_fp_lanes` and `merge_lanes`), and through ops/sha256.py
// `hash_rows_ext3` the wrapper `hash_rows_ext3_lanes` (sha256_pallas.py:171):
// a (C, 3, n) Fq3 matrix read with row stride 1 and element stride n is a
// row of 3C elements, each Fq3 value serialized as c0 || c1 || c2.
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
// 32-bit instructions per 64-byte block; a 64-byte row is 2 blocks, a merge
// 2 blocks of which the second is constant padding).  Design: the message
// schedule is a rolling 16-word window held in registers (fully unrolled),
// padding words are generated in place instead of read, and each thread
// streams its message straight from device memory.
#include "goldilocks.cuh"
#include "launch.cuh"

__constant__ uint32_t K256[64] = {
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2};

static __device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
    return __funnelshift_r(x, x, n);
}

static __device__ __forceinline__ uint32_t bswap(uint32_t x) {
    return __byte_perm(x, 0, 0x0123);
}

static __device__ __forceinline__ void compress(uint32_t st[8],
                                                uint32_t w[16]) {
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
    for (int t = 0; t < 64; t++) {
        if (t >= 16) {
            uint32_t w15 = w[(t + 1) & 15], w2 = w[(t + 14) & 15];
            uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
            uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
            w[t & 15] += s0 + w[(t + 9) & 15] + s1;
        }
        uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
        uint32_t ch = g ^ (e & (f ^ g));
        uint32_t t1 = h + S1 + ch + K256[t] + w[t & 15];
        uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
        uint32_t maj = (a & b) | ((a | b) & c);
        uint32_t t2 = S0 + maj;
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// SHA-256 of a W-word message whose word t is word(t), padding generated.
template <class Word>
static __device__ __forceinline__ void sha256_words(Word word, int64_t W,
                                                    uint32_t st[8]) {
    st[0] = 0x6A09E667; st[1] = 0xBB67AE85; st[2] = 0x3C6EF372;
    st[3] = 0xA54FF53A; st[4] = 0x510E527F; st[5] = 0x9B05688C;
    st[6] = 0x1F83D9AB; st[7] = 0x5BE0CD19;
    const int64_t total = ((W + 3 + 15) / 16) * 16;
    const uint64_t bitlen = (uint64_t)W * 32;
    for (int64_t blk = 0; blk < total; blk += 16) {
        uint32_t w[16];
#pragma unroll
        for (int k = 0; k < 16; k++) {
            int64_t t = blk + k;
            uint32_t v = 0;
            if (t < W) v = word(t);
            else if (t == W) v = 0x80000000u;
            else if (t == total - 2) v = (uint32_t)(bitlen >> 32);
            else if (t == total - 1) v = (uint32_t)bitlen;
            w[k] = v;
        }
        compress(st, w);
    }
}

static __device__ __forceinline__ void store_digest(uint8_t* out,
                                                    const uint32_t st[8]) {
    uint4* o = reinterpret_cast<uint4*>(out);
    o[0] = make_uint4(bswap(st[0]), bswap(st[1]), bswap(st[2]), bswap(st[3]));
    o[1] = make_uint4(bswap(st[4]), bswap(st[5]), bswap(st[6]), bswap(st[7]));
}

__global__ void hash_rows_kernel(const uint64_t* __restrict__ m,
                                 uint8_t* __restrict__ out, int64_t n,
                                 int64_t ncols, int64_t row_stride,
                                 int64_t col_stride) {
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        const uint64_t* row = m + i * row_stride;
        uint32_t st[8];
        sha256_words([&](int64_t t) {
            uint64_t v = row[(t >> 1) * col_stride];
            return bswap((t & 1) ? (uint32_t)(v >> 32) : (uint32_t)v);
        }, 2 * ncols, st);
        store_digest(out + 32 * i, st);
    }
}

__global__ void merge_kernel(const uint8_t* __restrict__ left,
                             const uint8_t* __restrict__ right,
                             uint8_t* __restrict__ out, int64_t n) {
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        const uint32_t* l = reinterpret_cast<const uint32_t*>(left + 32 * i);
        const uint32_t* r = reinterpret_cast<const uint32_t*>(right + 32 * i);
        uint32_t st[8];
        sha256_words([&](int64_t t) {
            return bswap(t < 8 ? l[t] : r[t - 8]);
        }, 16, st);
        store_digest(out + 32 * i, st);
    }
}

MS_API int ms_hash_rows(const uint64_t* m, uint8_t* out, int64_t n,
                        int64_t ncols, int64_t row_stride, int64_t col_stride,
                        cudaStream_t stream) {
    if (n > 0)
        hash_rows_kernel<<<ms_blocks(n, 128), 128, 0, stream>>>(
            m, out, n, ncols, row_stride, col_stride);
    return ms_last_error();
}

MS_API int ms_merge(const uint8_t* left, const uint8_t* right, uint8_t* out,
                    int64_t n, cudaStream_t stream) {
    if (n > 0)
        merge_kernel<<<ms_blocks(n, 128), 128, 0, stream>>>(left, right, out,
                                                            n);
    return ms_last_error();
}
