// Kernel F's arithmetic, point by point: the DEEP sum (deep.cu ms_deep,
// ms_deep_ext3) and the OOD barycentric sums (ms_ood_sums,
// ms_ood_sums_ext3), shared by the CUDA kernels (nvcc) and host C++ (g++,
// for the CPU tests).  Both are written once over a field traits type:
// dp_fp (Fp transcripts, fib) or dp_fq3 (Fq3 transcripts, brainfuck).
//
// The DEEP sum  sum_t alpha_t (ood_t - T_t[i]) inv_t[i]  is regrouped by
// inverse row: the terms whose OOD point is the same share inv_t, so
//   sum_{t in g} alpha_t (ood_t - T_t[i]) inv_g[i]
//     = (C_g - sum_{t in g} alpha_t T_t[i]) inv_g[i],
//   C_g = sum_{t in g} alpha_t ood_t   (once a launch, not once a point):
// one product a term and one a group of terms, where the direct form takes
// two a term.  The host splits each group into segments of terms of one
// kind (Fp or Fq3 columns) and a bounded length, so that `lanes` threads
// can share a point's segments; exact field sums make the order free.
//
// The OOD sums  S[j][c] = sum_i col_c[i] inv_j[i] g^i  run by groups of
// (point, column) pairs: a group reads each of its columns once a point
// and adds each pair's products, unreduced, into 160-bit accumulators; the
// weights inv_j[i] g^i of its points are formed once a point, and g^i is
// made in registers from g^(first point) and a step.
#pragma once

#include "goldilocks.cuh"

// Fp: one plane, one scalar slot an element
struct dp_fp {
    typedef uint64_t T;
    static const int SLOTS = 1;
    GL_FN static T zero() { return 0; }
    GL_FN static T load(const uint64_t* p, int64_t i, int64_t) { return p[i]; }
    GL_FN static void store(uint64_t* p, int64_t i, int64_t, T a) { p[i] = a; }
    GL_FN static T scalar(const uint64_t* s, int64_t k) { return s[k]; }
    GL_FN static T add(T a, T b) { return gl_add(a, b); }
    GL_FN static T sub(T a, T b) { return gl_sub(a, b); }
    GL_FN static T mul(T a, T b) { return gl_mul_cc(a, b); }
    GL_FN static T mul_base(T a, uint64_t b) { return gl_mul_cc(a, b); }
    GL_FN static uint64_t plane(T a, int) { return a; }
};

// Fq3: three planes `n` apart, three scalar slots an element
struct dp_fq3 {
    typedef gl3 T;
    static const int SLOTS = 3;
    GL_FN static T zero() { return gl3_from_base(0); }
    GL_FN static T load(const uint64_t* p, int64_t i, int64_t n) {
        return gl3_load(p, i, n);
    }
    GL_FN static void store(uint64_t* p, int64_t i, int64_t n, T a) {
        gl3_store(p, i, n, a);
    }
    GL_FN static T scalar(const uint64_t* s, int64_t k) {
        return gl3_load(s, 3 * k, 1);
    }
    GL_FN static T add(T a, T b) { return gl3_add(a, b); }
    GL_FN static T sub(T a, T b) { return gl3_sub(a, b); }
    GL_FN static T mul(T a, T b) { return gl3_mul_cc(a, b); }
    GL_FN static T mul_base(T a, uint64_t b) { return gl3_mul_base_cc(a, b); }
    GL_FN static uint64_t plane(T a, int k) {
        return k == 0 ? a.c0 : k == 1 ? a.c1 : a.c2;
    }
};

// -- the DEEP sum -------------------------------------------------------------
// The host's plan (ops/deep.py `deep_plan`), int64 words:
//   [T, nseg,
//    column pointer of each term, in plan order (a segment's terms in a row),
//    each term's index t in the scalar table (ood_t at slot 2t, alpha_t at
//      2t + 1, A and B after the last term),
//    segment starts (nseg + 1, the last T),
//    segment kinds (0: Fp columns, 1: Fq3 columns),
//    segment inverse rows (pointers)]
// Scalars are F::SLOTS words each.

// What a point's lanes read, staged once a block (or once on the host).
template <class F>
struct DeepStaged {
    typedef typename F::T T;
    int64_t nterms, nseg;
    const int64_t* orig;         // per term: its index in the scalars
    const int64_t* seg_of;       // the plan's segment starts
    const uint64_t* s;           // the scalars
    T* alpha;                    // per term
    T* ao;                       // per term: alpha_t ood_t
    T* c;                        // per segment: the sum of its alpha_t ood_t
    const uint64_t** col;        // per term
    const uint64_t** inv;        // per segment
    int64_t* start;              // per segment, and the end
    int64_t* kind;               // per segment
    T A, B;
};

// The staged arrays' sizes in bytes (the kernel's dynamic shared memory)
template <class F>
GL_HD int64_t deep_staged_bytes(int64_t nterms, int64_t nseg) {
    const int64_t t = (int64_t)sizeof(typename F::T);
    return nterms * (2 * t + 8) + nseg * (t + 24) + 8;
}

// Lay the staged arrays out at `mem` (the widest first, so that every
// array stays aligned) and read the plan's header
template <class F>
GL_HD DeepStaged<F> deep_staged(const int64_t* plan, const uint64_t* s,
                                unsigned char* mem) {
    typedef typename F::T T;
    DeepStaged<F> st;
    st.nterms = plan[0];
    st.nseg = plan[1];
    st.orig = plan + 2 + st.nterms;
    st.seg_of = st.orig + st.nterms;
    st.s = s;
    st.alpha = (T*)mem;
    st.ao = st.alpha + st.nterms;
    st.c = st.ao + st.nterms;
    st.col = (const uint64_t**)(st.c + st.nseg);
    st.inv = st.col + st.nterms;
    st.start = (int64_t*)(st.inv + st.nseg);
    st.kind = st.start + st.nseg + 1;
    st.A = F::scalar(s, 2 * st.nterms);
    st.B = F::scalar(s, 2 * st.nterms + 1);
    return st;
}

// Stage 1, term k by thread k mod nthreads (all of them on the host):
// alpha_t, alpha_t ood_t and the column pointers; the segments' tables
template <class F>
GL_HD void deep_stage_terms(const int64_t* plan, DeepStaged<F>& st, int tid,
                            int nthreads) {
    const int64_t nt = st.nterms, ns = st.nseg;
    const int64_t* kinds = st.seg_of + ns + 1;
    const int64_t* invs = kinds + ns;
    for (int64_t t = tid; t < nt; t += nthreads) {
        const int64_t o = st.orig[t];
        st.alpha[t] = F::scalar(st.s, 2 * o + 1);
        st.ao[t] = F::mul(st.alpha[t], F::scalar(st.s, 2 * o));
        st.col[t] = (const uint64_t*)plan[2 + t];
    }
    for (int64_t g = tid; g < ns; g += nthreads) {
        st.inv[g] = (const uint64_t*)invs[g];
        st.kind[g] = kinds[g];
    }
    for (int64_t g = tid; g <= ns; g += nthreads) st.start[g] = st.seg_of[g];
}

// Stage 2, after stage 1: C_g, segment g by thread g mod nthreads
template <class F>
GL_HD void deep_stage_segs(DeepStaged<F>& st, int tid, int nthreads) {
    for (int64_t g = tid; g < st.nseg; g += nthreads) {
        typename F::T acc = F::zero();
        for (int64_t t = st.seg_of[g]; t < st.seg_of[g + 1]; t++)
            acc = F::add(acc, st.ao[t]);
        st.c[g] = acc;
    }
}

// One lane's share of point i: the segments lane, lane + lanes, ...
template <class F>
GL_HD typename F::T deep_lane(const DeepStaged<F>& st, int64_t i, int64_t n,
                              int lane, int lanes) {
    typedef typename F::T T;
    T part = F::zero();
    for (int64_t g = lane; g < st.nseg; g += lanes) {
        const int64_t a = st.start[g], b = st.start[g + 1];
        T acc = F::zero();
        if (st.kind[g] == 0) {
#pragma unroll 4
            for (int64_t t = a; t < b; t++)
                acc = F::add(acc, F::mul_base(st.alpha[t], st.col[t][i]));
        } else {
#pragma unroll 2
            for (int64_t t = a; t < b; t++)
                acc = F::add(acc, F::mul(st.alpha[t], F::load(st.col[t], i, n)));
        }
        part = F::add(part, F::mul(F::sub(st.c[g], acc),
                                   F::load(st.inv[g], i, n)));
    }
    return part;
}

// The lanes' sum times (A + B x)
template <class F>
GL_HD typename F::T deep_finish(const DeepStaged<F>& st, typename F::T sum,
                                uint64_t x) {
    return F::mul(sum, F::add(st.A, F::mul_base(st.B, x)));
}

// -- the OOD sums ---------------------------------------------------------------
// The host's groups (ops/deep.py `ood_groups`), each a record of
// OOD_RECORD(P, W) int64 words:
//   [pairs, points, kind, W inverse rows (pointers), P column pointers,
//    P point slots, P output indices]
// A group's columns are of one kind (0 Fp, 1 Fq3); a pair's slot is its
// point's place among the group's inverse rows.  Unused slots and pairs
// repeat the group's first inverse row and column, so that a point's loads
// are unconditional and issue together (a load under a branch waits for
// the branch: one load's latency a pair).  An Fp transcript's groups
// (fib) have Fp columns and Fp inverse rows; an Fq3 transcript's groups
// Fq3 inverse rows.  Fp transcripts take one group of every pair (up to
// 32 pairs and 4 points, so each row is read once a point); Fq3
// transcripts groups of a few pairs and 2 points.
#define OOD_RECORD(P, W) (3 + (W) + 3 * (P))
#define OOD_COL(W, p) (3 + (W) + (p))
#define OOD_SLOT(P, W, p) (3 + (W) + (P) + (p))
#define OOD_OUT(P, W, p) (3 + (W) + 2 * (P) + (p))
// points a thread may take in one launch: its accumulators' top words
// count at most 3 carries a point (below 2^32)
#define OOD_MAX_RUN (1LL << 20)
// points a block takes at least
#define OOD_CHUNK_MIN 2048

// The chunks a group's n points are cut into, a block each: one wave of
// the `resident` blocks the card holds over the groups, none shorter than
// OOD_CHUNK_MIN points, and enough that no thread (of `threads` a block)
// takes more than OOD_MAX_RUN points
GL_HD int64_t ood_chunk_count(int64_t n, int64_t groups, int64_t resident,
                              int64_t threads) {
    const int64_t least = (n + threads * OOD_MAX_RUN - 1)
                          / (threads * OOD_MAX_RUN);
    int64_t c = (resident + groups - 1) / groups;
    const int64_t fill = (n + OOD_CHUNK_MIN - 1) / OOD_CHUNK_MIN;
    if (c > fill) c = fill;
    if (c > 65535) c = 65535;
    if (c < least) c = least;
    return c < 1 ? 1 : c;
}

// A sum of u64 products, unreduced: 160 bits, r[0] the lowest word.  Each
// product is below 2^128 and each carry out of bit 128 lands in r[4], so
// a thread's run of points (at most 3 products a point into one
// accumulator, at most OOD_MAX_RUN points) never overflows it.
struct ood_acc {
    uint32_t r[5];
};

GL_HD void ood_acc_zero(ood_acc& a) {
    a.r[0] = a.r[1] = a.r[2] = a.r[3] = a.r[4] = 0;
}

// a += x * y, for any u64 x and y
GL_HD void ood_mac(ood_acc& a, uint64_t x, uint64_t y) {
#ifdef __CUDA_ARCH__
    const uint32_t x0 = (uint32_t)x, x1 = (uint32_t)(x >> 32);
    const uint32_t y0 = (uint32_t)y, y1 = (uint32_t)(y >> 32);
    asm("mad.lo.cc.u32 %0, %5, %7, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %7, %1;\n\t"
        "madc.lo.cc.u32 %2, %6, %8, %2;\n\t"
        "madc.hi.cc.u32 %3, %6, %8, %3;\n\t"
        "addc.u32 %4, %4, 0;\n\t"
        "mad.lo.cc.u32 %1, %5, %8, %1;\n\t"
        "madc.hi.cc.u32 %2, %5, %8, %2;\n\t"
        "addc.cc.u32 %3, %3, 0;\n\t"
        "addc.u32 %4, %4, 0;\n\t"
        "mad.lo.cc.u32 %1, %6, %7, %1;\n\t"
        "madc.hi.cc.u32 %2, %6, %7, %2;\n\t"
        "addc.cc.u32 %3, %3, 0;\n\t"
        "addc.u32 %4, %4, 0;"
        : "+r"(a.r[0]), "+r"(a.r[1]), "+r"(a.r[2]), "+r"(a.r[3]),
          "+r"(a.r[4])
        : "r"(x0), "r"(x1), "r"(y0), "r"(y1));
#else
    typedef unsigned __int128 u128;
    const u128 p = (u128)x * y;
    const u128 s = ((u128)a.r[3] << 96 | (u128)a.r[2] << 64
                    | (u128)a.r[1] << 32 | a.r[0]);
    const u128 t = s + p;
    if (t < s) a.r[4]++;
    a.r[0] = (uint32_t)t;
    a.r[1] = (uint32_t)(t >> 32);
    a.r[2] = (uint32_t)(t >> 64);
    a.r[3] = (uint32_t)(t >> 96);
#endif
}

// a column's or inverse row's word, through the read-only cache on the
// card
GL_HD uint64_t ood_ld(const uint64_t* p) {
#ifdef __CUDA_ARCH__
    return __ldg((const unsigned long long*)p);
#else
    return *p;
#endif
}

// the sum mod p, canonical: lo + hi 2^64 + top 2^128 with 2^64 = 2^32 - 1
// and 2^128 = -2^32 (mod p)
GL_HD uint64_t ood_acc_reduce(const ood_acc& a) {
    const uint64_t lo = (uint64_t)a.r[1] << 32 | a.r[0];
    const uint64_t hi = (uint64_t)a.r[3] << 32 | a.r[2];
    return gl_sub(gl_reduce128(lo, hi), gl_canon((uint64_t)a.r[4] << 32));
}

// x g^e from the table tbl[b] = g^(2^b): a product a set bit of e
GL_HD uint64_t ood_power(const uint64_t* tbl, uint64_t x, uint64_t e) {
    for (int b = 0; e; b++, e >>= 1)
        if (e & 1) x = gl_mul_cc(x, tbl[b]);
    return x;
}

// g and the table tbl[b] = g^(2^b), b < 32, from the row's first two
// powers f = gpow[0] and f g = gpow[1] (n > 1; f != 0): g = gpow[1] / f,
// one inverse where f is not 1 (a rank's cyclic share, rows r + d t)
GL_HD void ood_pow2_table(uint64_t f, uint64_t fg, int64_t n, uint64_t* tbl) {
    uint64_t g = n > 1 ? fg : 1;
    if (n > 1 && f != 1) g = gl_mul_cc(g, gl_inv_chain(f, gl_mul_cc_fn()));
    for (int b = 0; b < 32; b++) {
        tbl[b] = g;
        g = gl_mul_cc(g, g);
    }
}

// A record's words, in place (shared memory on the card)
template <int P, int W>
struct OodRec {
    const int64_t* w;
    GL_FN int64_t pairs() const { return w[0]; }
    GL_FN int64_t kind() const { return w[2]; }
    GL_FN const uint64_t* inv(int s) const {
        return (const uint64_t*)w[3 + s];
    }
    GL_FN const uint64_t* col(int p) const {
        return (const uint64_t*)w[OOD_COL(W, p)];
    }
    GL_FN int64_t slot(int p) const { return w[OOD_SLOT(P, W, p)]; }
    GL_FN int64_t out(int p) const { return w[OOD_OUT(P, W, p)]; }
};

// Accumulators a pair: 1 for an Fp transcript; for an Fq3 one 3 (c0, c1,
// c2), or 6 for an Fq3 column in Karatsuba form (KARA).  Words of a
// point's weight table a slot: Fp 1; Fq3 the planes w0, w1, w2, then the
// schoolbook's 2 w1, 2 w2 or Karatsuba's w0 + w1, w0 + w2, w1 + w2.  A
// thread keeps its table wt[k * ws] in shared memory (ws = the block's
// threads), written once a point and read by each pair at its slot's
// offset: a register array indexed by a run-time slot would go to local
// memory, and selects cost a dozen instructions a pair.
#define OOD_ACCS(ext, kara) ((ext) ? ((kara) ? 6 : 3) : 1)
// the shipped form of an Fq3 column's products (ood_point_fq3): Karatsuba
// (true) or the schoolbook (false); timed in turns at brainfuck's 2^24
// points (scripts/ab_kernels.py --ood-variants), both at 240 registers,
// the schoolbook no slower
#define OOD_KARA false
#define OOD_WEIGHT_WORDS(ext, kara) ((ext) ? ((kara) ? 6 : 5) : 1)

// Fp transcript: point i's products, acc[p] += col_p[i] w_slot(p)[i],
// gi = g^i (any u64 congruent); the P + W loads first, all of them
template <int P, int W>
GL_HD void ood_point_fp(const OodRec<P, W>& r, uint32_t i, uint64_t gi,
                        ood_acc* acc, uint64_t* wt, int ws) {
    uint64_t w[W], v[P];
#pragma unroll
    for (int s = 0; s < W; s++) w[s] = ood_ld(r.inv(s) + i);
#pragma unroll
    for (int p = 0; p < P; p++) v[p] = ood_ld(r.col(p) + i);
#pragma unroll
    for (int s = 0; s < W; s++) wt[s * ws] = gl_mul_cc_lazy(w[s], gi);
    const int64_t np = r.pairs();
#pragma unroll
    for (int p = 0; p < P; p++)
        if (p < np) ood_mac(acc[p], v[p], wt[(int)r.slot(p) * ws]);
}

// Fq3 transcript, columns of kind K (0 Fp, 1 Fq3): point i's products
// into acc[p * OOD_ACCS(true, KARA && K) + ..] for the group's first Q
// pairs (a record of P: the groups of Fp columns hold more pairs than
// those of Fq3 ones).  A weight w = inv_j[i] g^i (three canonical planes).
//  - Fp column a: w a, three products into acc c0, c1, c2.
//  - Fq3 column a, schoolbook (u^3 = 2): nine products into c0, c1, c2,
//    with no subtraction, by the doubled planes 2 w1, 2 w2 made once a
//    point:  c0 += a0 w0 + a1 (2 w2) + a2 (2 w1),
//    c1 += a0 w1 + a1 w0 + a2 (2 w2),  c2 += a0 w2 + a1 w1 + a2 w0.
//  - Fq3 column a, Karatsuba (KARA): six products into six accumulators,
//    a_k w_k and (a_k + a_l)(w_k + w_l), the weights' sums made once a
//    point and the column's three a pair; ood_finish_fq3 combines them
//    once a thread (the subtractions after the reduction).
template <int Q, int P, int W, int K, bool KARA>
GL_HD void ood_point_fq3(const OodRec<P, W>& r, uint32_t i, uint32_t n,
                         uint64_t gi, ood_acc* acc, uint64_t* wt, int ws) {
    constexpr int NW = OOD_WEIGHT_WORDS(true, KARA);
    constexpr int A = OOD_ACCS(true, KARA && K == 1);
    // the loads first, all of them: per slot the inverse row's planes,
    // per pair its column's (1, or 3 for K = 1)
    uint64_t w[3][W], a[3][Q];
#pragma unroll
    for (int s = 0; s < W; s++) {
        const uint64_t* q = r.inv(s);
        w[0][s] = ood_ld(q + i);
        w[1][s] = ood_ld(q + n + i);
        w[2][s] = ood_ld(q + 2 * (uint64_t)n + i);
    }
#pragma unroll
    for (int p = 0; p < Q; p++) {
        const uint64_t* c = r.col(p);
        a[0][p] = ood_ld(c + i);
        if (K == 1) {
            a[1][p] = ood_ld(c + n + i);
            a[2][p] = ood_ld(c + 2 * (uint64_t)n + i);
        }
    }
#pragma unroll
    for (int s = 0; s < W; s++) {
        uint64_t* t = wt + s * NW * ws;
        const uint64_t w0 = gl_mul_cc(w[0][s], gi);
        const uint64_t w1 = gl_mul_cc(w[1][s], gi);
        const uint64_t w2 = gl_mul_cc(w[2][s], gi);
        t[0] = w0;
        t[ws] = w1;
        t[2 * ws] = w2;
        if (K == 1 && KARA) {
            t[3 * ws] = gl_add(w0, w1);
            t[4 * ws] = gl_add(w0, w2);
            t[5 * ws] = gl_add(w1, w2);
        } else if (K == 1) {
            t[3 * ws] = gl_add(w1, w1);
            t[4 * ws] = gl_add(w2, w2);
        }
    }
    const int64_t np = r.pairs();
#pragma unroll
    for (int p = 0; p < Q; p++)
        if (p < np) {
            const uint64_t* t = wt + (int)r.slot(p) * NW * ws;
            ood_acc* x = acc + p * A;
            const uint64_t w0 = t[0], w1 = t[ws], w2 = t[2 * ws];
            const uint64_t a0 = a[0][p];
            if (K == 0) {
                ood_mac(x[0], a0, w0);
                ood_mac(x[1], a0, w1);
                ood_mac(x[2], a0, w2);
                continue;
            }
            const uint64_t a1 = a[1][p], a2 = a[2][p];
            if (KARA) {
                ood_mac(x[0], a0, w0);
                ood_mac(x[1], a1, w1);
                ood_mac(x[2], a2, w2);
                ood_mac(x[3], gl_add(a0, a1), t[3 * ws]);
                ood_mac(x[4], gl_add(a0, a2), t[4 * ws]);
                ood_mac(x[5], gl_add(a1, a2), t[5 * ws]);
                continue;
            }
            const uint64_t d1 = t[3 * ws], d2 = t[4 * ws];
            ood_mac(x[0], a0, w0);
            ood_mac(x[0], a1, d2);
            ood_mac(x[0], a2, d1);
            ood_mac(x[1], a0, w1);
            ood_mac(x[1], a1, w0);
            ood_mac(x[1], a2, d2);
            ood_mac(x[2], a0, w2);
            ood_mac(x[2], a1, w1);
            ood_mac(x[2], a2, w0);
        }
}

// a pair's accumulators as its Fq3 sum (canonical): c0, c1, c2, or (KARA)
// v_k = sum a_k w_k and m_kl = sum (a_k + a_l)(w_k + w_l), with
// c0 = v0 + 2 (m12 - v1 - v2), c1 = m01 - v0 - v1 + 2 v2,
// c2 = m02 - v0 - v2 + v1
template <bool KARA>
GL_HD gl3 ood_finish_fq3(const ood_acc* x) {
    if (!KARA)
        return gl3_make(ood_acc_reduce(x[0]), ood_acc_reduce(x[1]),
                        ood_acc_reduce(x[2]));
    const uint64_t v0 = ood_acc_reduce(x[0]), v1 = ood_acc_reduce(x[1]);
    const uint64_t v2 = ood_acc_reduce(x[2]), m01 = ood_acc_reduce(x[3]);
    const uint64_t m02 = ood_acc_reduce(x[4]), m12 = ood_acc_reduce(x[5]);
    const uint64_t c0 = gl_sub(gl_sub(m12, v1), v2);
    return gl3_make(gl_add(v0, gl_add(c0, c0)),
                    gl_add(gl_sub(gl_sub(m01, v0), v1), gl_add(v2, v2)),
                    gl_add(gl_sub(gl_sub(m02, v0), v2), v1));
}

// Where a group's partial sums go: word k of chunk `chunk`'s partials is
// plane k / pairs of output pair k % pairs (F::SLOTS planes)
GL_HD int64_t ood_partial_index(int64_t chunk, int64_t plane, int64_t out,
                                int64_t pairs, int64_t slots) {
    return (chunk * slots + plane) * pairs + out;
}
