// RPO-256 (Rescue Prime Optimized, eprint 2022/1577) over Goldilocks: the
// parameters and the permutation of one 12-element state, shared by the
// CUDA kernels (csrc/rpo256.cu through rpo256_lanes.cuh, nvcc, sm_90a) and
// by host C++ (g++, the CPU tests, where rpo_permute is the reference).
//
// State width 12, capacity 4, rate 8, digest = state[4..8], 7 rounds; a
// round is MDS + RC0, x^7, MDS + RC1, x^(1/7).  The parameters are the
// reference's (ministark_tpu/ops/rpo256.py), here in canonical form: the
// circulant MDS matrix's first row has entries <= 26 and the round
// constants are canonical u64 values.
//
// The MDS product exploits the small entries: each output is a sum of 12
// products of a u64 by a constant <= 26.  Each u64 is split into 32-bit
// halves, so every product is one 32x32->64 multiply-add (IMAD.WIDE) into
// two 64-bit sums below 2^41, and the 74-bit total is reduced once.
// x^(1/7) = x^10540996611094048183 runs the 63-squaring, 9-multiply
// addition chain of ministark_tpu/ops/rpo256_pallas.py:122-133.
#pragma once

#include "goldilocks.cuh"

#define RPO_WIDTH 12
#define RPO_CAPACITY 4
#define RPO_RATE 8
#define RPO_DIGEST 4
#define RPO_ROUNDS 7

// the round constants: [0] added after the first MDS of a round, [1]
// after the second; canonical values
#define RPO_RC_INIT { \
    { \
     {0x50595E2460423080ULL, 0x5A84CE185F5BAE97ULL, 0xF72973C23AA6F9CBULL, \
      0x017CA8081F617C3CULL, 0x58AA35ADE9424046ULL, 0xDBE16FA8B27FAECBULL, \
      0x8A6E521E04CC3F3FULL, 0x2E6BC5568C881614ULL, 0x8A3626330BAA9677ULL, \
      0xB3DDEACCFBF5A691ULL, 0x854467ACE60E8A1BULL, 0xE72B7A87BED131F4ULL}, \
     {0xB43BC4A4DEB5D7A5ULL, 0x09135300915C4F81ULL, 0x3DA3ED63DAE7F669ULL, \
      0x380A98ACC7DB7371ULL, 0x4DE7085B5365A926ULL, 0xB7817F191D432DD5ULL, \
      0x2A284BB7BFCB3755ULL, 0xE7889F13DD9BEA2BULL, 0x73B444DF687FED0BULL, \
      0x2CCA04F182DB3A00ULL, 0x708E51F9A1893E3AULL, 0x27DBABFDDAB59589ULL}, \
     {0xFACF6EA8CD7F5EBFULL, 0x560E4919EF81A7E9ULL, 0xF563693084500B1BULL, \
      0x9319157E04FA6D58ULL, 0x0D87E8DB62DA4D1AULL, 0x72B07B7D0A3060D1ULL, \
      0x8BB0C6EFCE682AE2ULL, 0x1E44EFC3F951C7B5ULL, 0x57AB9282AFC28A97ULL, \
      0x1372EB1BD827429CULL, 0x7B4BF8C76437D9B6ULL, 0xB556F49D65B5AFFCULL}, \
     {0x4EC08822D1649AF2ULL, 0x4FEC612AE8A20297ULL, 0xC1807DB3D406EEC9ULL, \
      0x12C5EDBB56D825E2ULL, 0xED762CEB74D62145ULL, 0x0DEE82FE5A880AA6ULL, \
      0x397AE162D2D827B3ULL, 0x70B50C4015E67D10ULL, 0xC675A5E7967161E9ULL, \
      0xBE4B9DF1676FDBA5ULL, 0xEC39C51147CA6F4BULL, 0x56C3E89E2D94DC42ULL}, \
     {0x43D4474017EEF67AULL, 0x2A02792DF9C4708CULL, 0x8528A35711D49DD3ULL, \
      0x921CFE7A0D5480EFULL, 0x6D24FD145D1ACEA7ULL, 0xF3544CEC7C8FB490ULL, \
      0x503C812A00BA9267ULL, 0xEC41AD6D8AE8801EULL, 0x018596A32AE63FC7ULL, \
      0x6359A43C0EC3956DULL, 0x29028AD62F22F702ULL, 0x6729E445D0CE55D9ULL}, \
     {0xE254BA7B438CB541ULL, 0xA6378971BFBFB3DAULL, 0xADEB7834C155923FULL, \
      0xCA8B77F99F834E42ULL, 0x65319F21E97797B8ULL, 0x4C88374B5DD3159DULL, \
      0x8B228FD24A337113ULL, 0x6538C386D1E55BFDULL, 0x5D609F3F4A01143CULL, \
      0x57E126A4F4CF409EULL, 0xB843CEF8C2FAF7E4ULL, 0x2417D2A27B45B944ULL}, \
     {0x62DA3F9791D3AB16ULL, 0x0E5A3C7794118CF2ULL, 0x6B1B386AE880F795ULL, \
      0x29E5E505B3F5A91AULL, 0x9E426915297DF504ULL, 0x8EABF5C551CE1736ULL, \
      0x04ADCF0EC4E3F6E2ULL, 0xB909BF5ACD54F805ULL, 0x31E81ABBEF89DDF8ULL, \
      0x7077EEA8DE2E5D38ULL, 0xC713E6261BE1BABDULL, 0xEC6EA1039669E548ULL}}, \
    { \
     {0x545610627C0E253FULL, 0xD4050299CC1D7937ULL, 0x4A5E0FEEFB8988E1ULL, \
      0xC586C83181332146ULL, 0xBF691615416D26E5ULL, 0xA1301A4712135881ULL, \
      0xCE60A1A2007BBDAEULL, 0x8CD5C7EB4E3B7A2BULL, 0x3DDBF8040326E3F7ULL, \
      0xD85D99AE231FD27BULL, 0x8BA8176A640FA5C7ULL, 0xC510D0790D441656ULL}, \
     {0x56154CC23DC0375CULL, 0xF58000EF967C75F3ULL, 0x31E402E2B72C1DEBULL, \
      0x0530B354A02CCCB7ULL, 0x112635E298261F0DULL, 0xC4AFBFD141F5B352ULL, \
      0x09D1CDFD29D87590ULL, 0xD674DB73E2D291FFULL, 0x030CCED019223FA2ULL, \
      0xF816C89CB0BE2BD0ULL, 0xF6135FEC50264FD2ULL, 0x2834B20EFCE752B8ULL}, \
     {0x6F58C0A8643B651FULL, 0xD05B57D23A80DF96ULL, 0x3E3FB28855BAEB0DULL, \
      0xAD5476203073CF51ULL, 0x83D8634A982015B0ULL, 0x1C8147561ADBF416ULL, \
      0xAC5F3488C1EE4E2AULL, 0x04F0BBDDF9FD028BULL, 0x7DE3771F68FEAF14ULL, \
      0xB12AA71A8096D2D8ULL, 0x7D89C6216FE08363ULL, 0xB38055125E76C95AULL}, \
     {0xFF33B8D66FF1C2C4ULL, 0xE8331207B185B3EBULL, 0x3D9ECB3A80A135F0ULL, \
      0xEED0B078F2CF1CEAULL, 0x7948ECEEBC83B020ULL, 0xEBEEE2B7C12EC72FULL, \
      0xBBCFE0C636955337ULL, 0x074A9B1B5C662C37ULL, 0xEBBFDF02E9518234ULL, \
      0x4BDDFF91D264912EULL, 0xC967B70BE3BFF877ULL, 0x984B52DE2F0EA2AEULL}, \
     {0x60E616FFFF6D6221ULL, 0xC3326EB1C066F68BULL, 0xE450B29006E2A864ULL, \
      0x631350B987E27AE7ULL, 0x7D11141C0755E6D7ULL, 0xCAE34D92DC29F5C1ULL, \
      0x135B5F370979E6D3ULL, 0x4053390604D15B1FULL, 0xE1100AA2BEDBAC65ULL, \
      0x95A16C738E50183BULL, 0x5EFB96EA7A0B1962ULL, 0x67573C0C226BF3D7ULL}, \
     {0x33DBC0D5D6954218ULL, 0x0804F1885D65A6EDULL, 0x5CD7A60A805F62DDULL, \
      0xC0B53529A6F84A34ULL, 0xC743A850C9C43478ULL, 0x6B78B89A3847D5F4ULL, \
      0xDFEB4958CCE467DBULL, 0xAA920EB91C6B33A1ULL, 0xA75D6B947C97C6ECULL, \
      0xE45F85A25B0B6767ULL, 0x3F712DD18A72BA74ULL, 0xEEB4117DF819AC88ULL}, \
     {0xEDBB66463142CCADULL, 0x0736A3C13B07EDE4ULL, 0x85943C1B27ADEB26ULL, \
      0x171AE3690F17F576ULL, 0x69E1B3086DBD2562ULL, 0x305E0EF39CE86971ULL, \
      0x8763E3E68D1C072EULL, 0xD331B9277F5CD123ULL, 0xE46FD0DDB6C1D138ULL, \
      0x85D641ECB35BEEE3ULL, 0x321E1684863D6BC3ULL, 0xFD5BB0830A60D1DCULL}}}

static const uint64_t rpo_rc_host[2][RPO_ROUNDS][RPO_WIDTH] = RPO_RC_INIT;
#ifdef __CUDACC__
__constant__ uint64_t rpo_rc_dev[2][RPO_ROUNDS][RPO_WIDTH] = RPO_RC_INIT;
#endif

GL_HD uint64_t rpo_rc(int which, int round, int m) {
#ifdef __CUDA_ARCH__
    return rpo_rc_dev[which][round][m];
#else
    return rpo_rc_host[which][round][m];
#endif
}

// first row of the circulant MDS matrix: MDS[m][n] = row[(n - m) % 12]
GL_HD uint32_t rpo_mds_row(int j) {
    return j == 0 ? 7 : j == 1 ? 23 : j == 2 ? 8 : j == 3 ? 26
         : j == 4 ? 13 : j == 5 ? 10 : j == 6 ? 9 : j == 7 ? 7
         : j == 8 ? 6 : j == 9 ? 22 : j == 10 ? 21 : 8;
}

// out[m] = sum_j row[j] * s[(m + j) % 12] + rc[m], canonical
GL_HD void rpo_mds_rc(const uint64_t* s, uint64_t* out, int which,
                      int round) {
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int m = 0; m < RPO_WIDTH; m++) {
        uint64_t lo = 0, hi = 0;  // each < 12 * 26 * 2^32 < 2^41
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
        for (int j = 0; j < RPO_WIDTH; j++) {
            uint64_t v = s[(m + j) % RPO_WIDTH];
            uint64_t c = rpo_mds_row(j);
            lo += c * (uint32_t)v;
            hi += c * (uint32_t)(v >> 32);
        }
        uint64_t l = lo + (hi << 32);  // lo + hi * 2^32 as a 128-bit value
        uint64_t h = (hi >> 32) + (l < lo ? 1 : 0);
        out[m] = gl_add(gl_reduce128(l, h), rpo_rc(which, round, m));
    }
}

GL_HD uint64_t rpo_pow7(uint64_t x) {
    uint64_t x2 = gl_mul(x, x);
    uint64_t x3 = gl_mul(x2, x);
    uint64_t x6 = gl_mul(x3, x3);
    return gl_mul(x6, x);
}

GL_HD uint64_t rpo_sqr_n(uint64_t x, int n) {
    for (int i = 0; i < n; i++) x = gl_mul(x, x);
    return x;
}

// x^10540996611094048183, the inverse of x^7: 63 squarings, 9 multiplies
GL_HD uint64_t rpo_pow_inv7(uint64_t x) {
    uint64_t t1 = gl_mul(x, x);                     // x^2
    uint64_t t2 = gl_mul(t1, t1);                   // x^4
    uint64_t t3 = gl_mul(rpo_sqr_n(t2, 3), t2);     // x^36
    uint64_t t4 = gl_mul(rpo_sqr_n(t3, 6), t3);     // x^2340
    uint64_t t5 = gl_mul(rpo_sqr_n(t4, 12), t4);
    uint64_t t6 = gl_mul(rpo_sqr_n(t5, 6), t3);
    uint64_t t7 = gl_mul(rpo_sqr_n(t6, 31), t6);
    uint64_t a = rpo_sqr_n(gl_mul(gl_mul(t7, t7), t6), 2);
    uint64_t b = gl_mul(gl_mul(t1, t2), x);
    return gl_mul(a, b);
}

// the permutation, in place on a canonical state
GL_HD void rpo_permute(uint64_t* s) {
    uint64_t t[RPO_WIDTH];
    for (int r = 0; r < RPO_ROUNDS; r++) {
        rpo_mds_rc(s, t, 0, r);
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
        for (int m = 0; m < RPO_WIDTH; m++) t[m] = rpo_pow7(t[m]);
        rpo_mds_rc(t, s, 1, r);
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
        for (int m = 0; m < RPO_WIDTH; m++) s[m] = rpo_pow_inv7(s[m]);
    }
}

// leading zero bits of a digest's byte stream (four little-endian u64s),
// the proof-of-work measure (hash.leading_zeros)
GL_HD int rpo_leading_zeros(const uint64_t* d) {
    int z = 0;
    for (int k = 0; k < RPO_DIGEST; k++) {
        for (int b = 0; b < 8; b++) {
            uint32_t byte = (uint32_t)(d[k] >> (8 * b)) & 0xFF;
            if (byte != 0) {
                while (!(byte & 0x80)) {
                    byte <<= 1;
                    z++;
                }
                return z;
            }
            z += 8;
        }
    }
    return z;
}
