// The per-thread routine of kernel A (csrc/inv.cu): Montgomery's trick over
// a group of K elements that share one Fermat chain, in Fp and in Fq3;
// shared by the CUDA kernel (nvcc, sm_90a) and a host driver that runs it
// one "thread" at a time (g++, the CPU tests).
//
// The caller hands the group out through ld(k), which gives 1 for the
// padding past the end of the input, and takes the inverses back through
// st(k, v), which drops the padding; so any length works.  Zeros are
// masked to 1 before the products and come back as 0.  Forward pass: the
// prefix products pre_k = x_0 ... x_k.  One chain: t = pre_{K-1}^-1.
// Backward pass: x_k^-1 = t pre_{k-1}, then t <- t x_k.  That is
// 3 (K - 1) products and one chain of 73 for K inverses.  The prefix
// products, the chain and the running t are lazy (any u64 congruent to
// the value, mul.lazy); what is stored is canonical.
//
// Fq3 runs the trick on the norms N_k = a_k v_k (v_k = gl3_adj(a_k)) and
// writes a_k^-1 = v_k N_k^-1.
//
// KEEP: hold x_k (Fq3: v_k and N_k) in registers from the forward pass to
// the backward pass; else call ld(k) again there (and recompute v_k and
// N_k), which costs registers nothing and a second read that the cache
// serves.
#pragma once

#include "goldilocks.cuh"

template <int K, bool KEEP, class Ld, class St, class Mul>
GL_HD void inv_batch_fp(const Ld& ld, const St& st, Mul mul) {
    static_assert(K >= 1 && K <= 32, "the zero mask is one 32-bit word");
    uint64_t x[K], pre[K];
    uint32_t zero = 0;
#pragma unroll
    for (int k = 0; k < K; k++) {
        uint64_t v = ld(k);
        if (v == 0) {
            zero |= 1u << k;
            v = 1;
        }
        if constexpr (KEEP) x[k] = v;
        pre[k] = k == 0 ? v : mul.lazy(pre[k - 1], v);
    }
    uint64_t t = gl_inv_chain(pre[K - 1], mul);
#pragma unroll
    for (int k = K - 1; k > 0; k--) {
        uint64_t v = KEEP ? x[k] : ld(k);
        if (!KEEP && v == 0) v = 1;
        const uint64_t r = mul(t, pre[k - 1]);
        t = mul.lazy(t, v);
        st(k, (zero >> k) & 1 ? 0 : r);
    }
    st(0, zero & 1 ? 0 : gl_canon(t));
}

template <int K, bool KEEP, class Ld, class St, class Mul>
GL_HD void inv_batch_ext3(const Ld& ld, const St& st, Mul mul) {
    static_assert(K >= 1 && K <= 32, "the zero mask is one 32-bit word");
    gl3 adj[K];
    uint64_t nrm[K], pre[K];
    uint32_t zero = 0;
#pragma unroll
    for (int k = 0; k < K; k++) {
        const gl3 a = ld(k);
        const gl3 v = gl3_adj(a, mul);
        uint64_t m = gl3_norm(a, v, mul);
        if (m == 0) {
            zero |= 1u << k;
            m = 1;
        }
        if constexpr (KEEP) {
            adj[k] = v;
            nrm[k] = m;
        }
        pre[k] = k == 0 ? m : mul.lazy(pre[k - 1], m);
    }
    uint64_t t = gl_inv_chain(pre[K - 1], mul);
#pragma unroll
    for (int k = K - 1; k >= 0; k--) {
        gl3 v;
        uint64_t m;
        if constexpr (KEEP) {
            v = adj[k];
            m = nrm[k];
        } else {
            const gl3 a = ld(k);
            v = gl3_adj(a, mul);
            m = gl3_norm(a, v, mul);
        }
        const uint64_t r = k == 0 ? t : mul(t, pre[k - 1]);
        if (k > 0) t = mul.lazy(t, m == 0 ? 1 : m);
        st(k, (zero >> k) & 1
                  ? gl3_make(0, 0, 0)
                  : gl3_make(mul(v.c0, r), mul(v.c1, r), mul(v.c2, r)));
    }
}

// -- a thread's group in the kernel's layout --------------------------------
// A block of T threads takes tile j of K T elements; thread t's k-th element
// is j K T + k T + t (coalesced across a warp for each k).

// Fp: element e of a flat array, 1 past the end
struct inv_fp_ld {
    const uint64_t* p;
    int64_t e0, step, n;
    GL_FN uint64_t operator()(int k) const {
        const int64_t e = e0 + k * step;
        return e < n ? p[e] : 1;
    }
};

struct inv_fp_st {
    uint64_t* p;
    int64_t e0, step, n;
    GL_FN void operator()(int k, uint64_t v) const {
        const int64_t e = e0 + k * step;
        if (e < n) p[e] = v;
    }
};

template <int K, bool KEEP, class Mul>
GL_HD void inv_fp_thread(const uint64_t* in, uint64_t* out, int64_t n,
                         int64_t j, int t, int T, Mul mul) {
    const int64_t e0 = j * K * T + t;
    inv_batch_fp<K, KEEP>(inv_fp_ld{in, e0, T, n}, inv_fp_st{out, e0, T, n},
                          mul);
}

// Fq3: flat element e = b n + i of a (B, 3, n) array, its component c at
// e + 2 n b + c n.  A thread's K elements e0 + k T cross at most one row
// boundary when n >= K T (one division a thread); else each divides.
struct inv_ext3_at {
    int64_t e0, step, n, total, b0, i0;
    bool one_step;
    GL_FN int64_t operator()(int k) const {
        const int64_t e = e0 + k * step;
        const int64_t b = one_step ? b0 + (i0 + k * step >= n) : e / n;
        return e + 2 * n * b;
    }
    GL_FN bool valid(int k) const { return e0 + k * step < total; }
};

struct inv_ext3_ld {
    const uint64_t* p;
    inv_ext3_at at;
    GL_FN gl3 operator()(int k) const {
        return at.valid(k) ? gl3_load(p, at(k), at.n) : gl3_from_base(1);
    }
};

struct inv_ext3_st {
    uint64_t* p;
    inv_ext3_at at;
    GL_FN void operator()(int k, gl3 v) const {
        if (at.valid(k)) gl3_store(p, at(k), at.n, v);
    }
};

template <int K, bool KEEP, class Mul>
GL_HD void inv_ext3_thread(const uint64_t* in, uint64_t* out, int64_t n,
                           int64_t total, int64_t j, int t, int T, Mul mul) {
    const int64_t e0 = j * K * T + t, b0 = e0 / n;
    const inv_ext3_at at{e0, T, n, total, b0, e0 - b0 * n,
                         n >= (int64_t)K * T};
    inv_batch_ext3<K, KEEP>(inv_ext3_ld{in, at}, inv_ext3_st{out, at}, mul);
}
