// The affine scan of the brainfuck extension columns (csrc/scan.cu): the
// per-element math and a thread's walks over its run of elements, shared
// by the kernel (nvcc) and by host C++ (g++, for the CPU tests).
//
// Column c of a batch is the recurrence s' = a_i s + b_i over Fq3 from
// init[c]: map i is f_i(s) = a_i s + b_i, an `aff3`.  Maps compose as
//
//   (A2, B2) o (A1, B1) = (A2 A1, A2 B1 + B2)      (A1, B1) applied first,
//
// so a run of maps folds into one map, and the state after a run is its
// fold applied to the state before it.  Every value stored is canonical,
// as scan_mul_add leaves it, so the output is bit-identical to scan.py's
// plain versions.
#pragma once

#include "deep.cuh"  // the OOD sums' 160-bit accumulator (ood_mac)

// The launch: SCAN_THREADS threads a block, SCAN_K consecutive elements a
// thread, a tile of SCAN_THREADS * SCAN_K elements of one column a block
// (timed on an H100 against 128 threads and 16 elements: scan.cu)
#define SCAN_THREADS 256
#define SCAN_K 8

struct aff3 {
    gl3 a, b;  // s -> a s + b
};

GL_HD aff3 aff3_make(gl3 a, gl3 b) {
    aff3 f;
    f.a = a; f.b = b;
    return f;
}

GL_HD aff3 aff3_identity() {
    return aff3_make(gl3_from_base(1), gl3_from_base(0));
}

// a b + c over Fq3, canonical: the schoolbook's nine products (u^3 = 2
// folded into a's doubled c1 and c2) summed unreduced into one 160-bit
// accumulator a component that starts at c (deep.cuh ood_mac), and one
// reduction a component
GL_HD gl3 scan_mul_add(gl3 a, gl3 b, gl3 c) {
    const uint64_t a1d = gl_add(a.c1, a.c1), a2d = gl_add(a.c2, a.c2);
    ood_acc r0, r1, r2;
    ood_acc_zero(r0); ood_acc_zero(r1); ood_acc_zero(r2);
    r0.r[0] = (uint32_t)c.c0; r0.r[1] = (uint32_t)(c.c0 >> 32);
    r1.r[0] = (uint32_t)c.c1; r1.r[1] = (uint32_t)(c.c1 >> 32);
    r2.r[0] = (uint32_t)c.c2; r2.r[1] = (uint32_t)(c.c2 >> 32);
    ood_mac(r0, a.c0, b.c0); ood_mac(r0, a1d, b.c2); ood_mac(r0, a2d, b.c1);
    ood_mac(r1, a.c0, b.c1); ood_mac(r1, a.c1, b.c0); ood_mac(r1, a2d, b.c2);
    ood_mac(r2, a.c0, b.c2); ood_mac(r2, a.c1, b.c1); ood_mac(r2, a.c2, b.c0);
    return gl3_make(ood_acc_reduce(r0), ood_acc_reduce(r1),
                    ood_acc_reduce(r2));
}

// f first, then g: s -> g.a (f.a s + f.b) + g.b
GL_HD aff3 aff3_then(aff3 f, aff3 g) {
    return aff3_make(scan_mul_add(g.a, f.a, gl3_from_base(0)),
                     scan_mul_add(g.a, f.b, g.b));
}

// f(s) = f.a s + f.b
GL_HD gl3 aff3_apply(aff3 f, gl3 s) { return scan_mul_add(f.a, s, f.b); }

// Map i of a run whose a and b are three planes each, `stride` words
// apart: a column in device memory (stride n) or a tile staged in shared
// memory (scan.cu)
GL_HD aff3 scan_map(const uint64_t* a, const uint64_t* b, int64_t stride,
                    int64_t i) {
    return aff3_make(gl3_load(a, i, stride), gl3_load(b, i, stride));
}

// A thread's first walk: the fold of its run's maps i0 .. i0 + count - 1
// (count <= K; the identity where count <= 0)
template <int K>
GL_HD aff3 scan_thread_fold(const uint64_t* a, const uint64_t* b,
                            int64_t stride, int64_t i0, int64_t count) {
    aff3 f = aff3_identity();
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int k = 0; k < K; k++)
        if (k < count) f = k == 0 ? scan_map(a, b, stride, i0)
                                  : aff3_then(f, scan_map(a, b, stride,
                                                          i0 + k));
    return f;
}

// A thread's second walk: from state s before map i0, apply maps i0 ..
// i0 + count - 1 in turn and store at each i the state after map i
// (inclusive) or before it (exclusive) into out's three planes (the same
// stride; out may be a: map i is read before state i is stored); returns
// the state after the run
template <int K>
GL_HD gl3 scan_thread_walk(const uint64_t* a, const uint64_t* b,
                           uint64_t* out, int64_t stride, int64_t i0,
                           int64_t count, gl3 s, bool inclusive) {
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int k = 0; k < K; k++)
        if (k < count) {
            const gl3 t = aff3_apply(scan_map(a, b, stride, i0 + k), s);
            gl3_store(out, i0 + k, stride, inclusive ? t : s);
            s = t;
        }
    return s;
}

// A tile staged in shared memory (scan.cu): six planes (a's components,
// then b's) SCAN_PLANE(T, K) words apart, element e of the tile in slot e
// + e / K: one pad word after each thread's run, so that a half-warp's
// 8-byte reads of the threads' k-th elements hit distinct banks (for an
// even K, K + 1 is odd)
#define SCAN_PLANE(T, K) ((T) * ((K) + 1))

GL_HD int scan_slot(int e, int K) { return e + e / K; }

// the count of a thread's run of K from global index i0 in a column of n
GL_HD int64_t scan_count(int64_t n, int64_t i0, int64_t K) {
    return n - i0 < K ? n - i0 : K;
}

// Tiles of `tile` elements a column of n (the last one ragged)
GL_HD int64_t scan_tiles(int64_t n, int64_t tile) {
    return (n + tile - 1) / tile;
}
