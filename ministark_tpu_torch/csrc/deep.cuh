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
// and adds into one accumulator a pair; the weights inv_j[i] g^i of its
// (at most OOD_W) points are formed once a point.
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
// OOD_RECORD(P) int64 words:
//   [pairs, points, kind, OOD_W inverse rows (pointers), P column pointers,
//    P metas, P output indices]
// A group's columns are of one kind (0 Fp, 1 Fq3).  A pair's meta: bit 0
// its point's slot in the group, bit 1 set where the pair reads the column
// of the pair before it (so a column is loaded once a point).  An Fp
// transcript's groups (fib) have Fp columns and Fp inverse rows; an Fq3
// transcript's groups Fq3 inverse rows.
#define OOD_W 2

#define OOD_RECORD(P) (3 + OOD_W + 3 * (P))
// where a record keeps pair p's output index
#define OOD_OUT(P, p) (3 + OOD_W + 2 * (P) + (p))

// a column's value at i as V (an Fp column's or an Fq3 one's), and the
// product of a weight with it
GL_HD uint64_t ood_load(const uint64_t* p, int64_t i, int64_t, uint64_t) {
    return p[i];
}
GL_HD gl3 ood_load(const uint64_t* p, int64_t i, int64_t n, gl3) {
    return gl3_load(p, i, n);
}
template <class F>
GL_HD typename F::T ood_mul(typename F::T w, uint64_t v) {
    return F::mul_base(w, v);
}
template <class F>
GL_HD typename F::T ood_mul(typename F::T w, gl3 v) {
    return F::mul(w, v);
}

// The pairs of a group of one column kind (V its values' type): each
// column loaded once a point, then its pairs' products
template <class F, int P, class V>
GL_HD void ood_pairs(const int64_t* rec, int64_t i, int64_t n,
                     typename F::T w0, typename F::T w1,
                     typename F::T* acc) {
    const int64_t np = rec[0];
    const int64_t* col = rec + 3 + OOD_W;
    const int64_t* meta = col + P;
    V v = V();
#pragma unroll
    for (int p = 0; p < P; p++)
        if (p < np) {
            if (!(meta[p] & 2)) v = ood_load((const uint64_t*)col[p], i, n, V());
            acc[p] = F::add(acc[p], ood_mul<F>((meta[p] & 1) ? w1 : w0, v));
        }
}

// Add point i's products into acc[0 .. pairs); g = g^i
template <class F, int P>
GL_HD void ood_point(const int64_t* rec, int64_t i, int64_t n, uint64_t g,
                     typename F::T* acc) {
    const uint64_t* const* inv = (const uint64_t* const*)(rec + 3);
    const typename F::T w0 = F::mul_base(F::load(inv[0], i, n), g);
    const typename F::T w1 =
        rec[1] > 1 ? F::mul_base(F::load(inv[1], i, n), g) : F::zero();
    if constexpr (F::SLOTS == 3) {
        if (rec[2]) {
            ood_pairs<F, P, gl3>(rec, i, n, w0, w1, acc);
            return;
        }
    }
    ood_pairs<F, P, uint64_t>(rec, i, n, w0, w1, acc);
}

// Where a group's partial sums go: word k of chunk `chunk`'s partials is
// plane k / pairs of output pair k % pairs (F::SLOTS planes)
GL_HD int64_t ood_partial_index(int64_t chunk, int64_t plane, int64_t out,
                                int64_t pairs, int64_t slots) {
    return (chunk * slots + plane) * pairs + out;
}
