// Kernel F's OOD sums as csrc/deep.cu shipped them before the lazy
// design (the grouped kernel): kept for scripts/ab_kernels.py to time
// against the kernel csrc/deep.cu ships (its entry points ab_old_ood_sums
// and ab_old_ood_sums_ext3 take the old arguments).  Built by
// ab_kernels.py with the port's nvcc flags and csrc/ on the include path.
//
// S[j][c] = sum_i col_c[i] inv_j[i] g^i by groups of (point, column)
// pairs: a group reads each of its columns once a point and adds into one
// accumulator a pair, a full Goldilocks product and sum each (gl_mul_cc,
// gl_add; Karatsuba gl3_mul_cc for Fq3 columns); the weights inv_j[i] g^i
// of its (at most two) points are formed once a point from the row
// gpow[i] = g^i.  Block (group, chunk) streams the chunk's points, reduces
// over the block with warp shuffles and writes one partial a pair; a
// second launch sums the chunks' partials.  P = 8 pairs a group for Fp
// transcripts, 4 for Fq3; 256 threads a block.
#include "deep.cuh"
#include "launch.cuh"

#define old_OOD_THREADS 256

// -- the math ---------------------------------------------------------------
// The host's groups (scripts/ab_kernels.py `old_ood_groups`), each a record of
// old_OOD_RECORD(P) int64 words:
//   [pairs, points, kind, old_OOD_W inverse rows (pointers), P column pointers,
//    P metas, P output indices]
// A group's columns are of one kind (0 Fp, 1 Fq3).  A pair's meta: bit 0
// its point's slot in the group, bit 1 set where the pair reads the column
// of the pair before it (so a column is loaded once a point).  An Fp
// transcript's groups (fib) have Fp columns and Fp inverse rows; an Fq3
// transcript's groups Fq3 inverse rows.
#define old_OOD_W 2

#define old_OOD_RECORD(P) (3 + old_OOD_W + 3 * (P))
// where a record keeps pair p's output index
#define old_OOD_OUT(P, p) (3 + old_OOD_W + 2 * (P) + (p))

// a column's value at i as V (an Fp column's or an Fq3 one's), and the
// product of a weight with it
GL_HD uint64_t old_ood_load(const uint64_t* p, int64_t i, int64_t, uint64_t) {
    return p[i];
}
GL_HD gl3 old_ood_load(const uint64_t* p, int64_t i, int64_t n, gl3) {
    return gl3_load(p, i, n);
}
template <class F>
GL_HD typename F::T old_ood_mul(typename F::T w, uint64_t v) {
    return F::mul_base(w, v);
}
template <class F>
GL_HD typename F::T old_ood_mul(typename F::T w, gl3 v) {
    return F::mul(w, v);
}

// The pairs of a group of one column kind (V its values' type): each
// column loaded once a point, then its pairs' products
template <class F, int P, class V>
GL_HD void old_ood_pairs(const int64_t* rec, int64_t i, int64_t n,
                     typename F::T w0, typename F::T w1,
                     typename F::T* acc) {
    const int64_t np = rec[0];
    const int64_t* col = rec + 3 + old_OOD_W;
    const int64_t* meta = col + P;
    V v = V();
#pragma unroll
    for (int p = 0; p < P; p++)
        if (p < np) {
            if (!(meta[p] & 2)) v = old_ood_load((const uint64_t*)col[p], i, n, V());
            acc[p] = F::add(acc[p], old_ood_mul<F>((meta[p] & 1) ? w1 : w0, v));
        }
}

// Add point i's products into acc[0 .. pairs); g = g^i
template <class F, int P>
GL_HD void old_ood_point(const int64_t* rec, int64_t i, int64_t n, uint64_t g,
                     typename F::T* acc) {
    const uint64_t* const* inv = (const uint64_t* const*)(rec + 3);
    const typename F::T w0 = F::mul_base(F::load(inv[0], i, n), g);
    const typename F::T w1 =
        rec[1] > 1 ? F::mul_base(F::load(inv[1], i, n), g) : F::zero();
    if constexpr (F::SLOTS == 3) {
        if (rec[2]) {
            old_ood_pairs<F, P, gl3>(rec, i, n, w0, w1, acc);
            return;
        }
    }
    old_ood_pairs<F, P, uint64_t>(rec, i, n, w0, w1, acc);
}

// Where a group's partial sums go: word k of chunk `chunk`'s partials is
// plane k / pairs of output pair k % pairs (F::SLOTS planes)
GL_HD int64_t old_ood_partial_index(int64_t chunk, int64_t plane, int64_t out,
                                int64_t pairs, int64_t slots) {
    return (chunk * slots + plane) * pairs + out;
}

// -- the OOD sums ---------------------------------------------------------------

__device__ __forceinline__ uint64_t old_shfl_down(uint64_t v, int d) {
    return __shfl_down_sync(0xffffffffu, (unsigned long long)v, d);
}
__device__ __forceinline__ gl3 old_shfl_down(gl3 v, int d) {
    return gl3_make(old_shfl_down(v.c0, d), old_shfl_down(v.c1, d),
                    old_shfl_down(v.c2, d));
}

// The sum of v over the block, in thread 0 (red: a value a warp)
template <class F>
__device__ __forceinline__ typename F::T old_block_sum(typename F::T v,
                                                   typename F::T* red) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v = F::add(v, old_shfl_down(v, d));
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    __syncthreads();  // red is free
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (threadIdx.x == 0)
        for (int w = 1; w < (int)blockDim.x / 32; w++) v = F::add(v, red[w]);
    return v;
}

template <class F, int P, int THREADS>
__global__ void __launch_bounds__(THREADS)
    old_ood_kernel(const int64_t* __restrict__ recs,
               const uint64_t* __restrict__ gpow,
               uint64_t* __restrict__ partial, int64_t n, int64_t chunk,
               int64_t pairs) {
    typedef typename F::T T;
    __shared__ int64_t rec[old_OOD_RECORD(P)];
    __shared__ T red[THREADS / 32];
    const int64_t words = old_OOD_RECORD(P);
    for (int k = threadIdx.x; k < words; k += blockDim.x)
        rec[k] = recs[blockIdx.x * words + k];
    __syncthreads();
    T acc[P];
#pragma unroll
    for (int p = 0; p < P; p++) acc[p] = F::zero();
    const int64_t a = blockIdx.y * chunk;
    const int64_t b = a + chunk < n ? a + chunk : n;
    for (int64_t i = a + threadIdx.x; i < b; i += blockDim.x)
        old_ood_point<F, P>(rec, i, n, gpow[i], acc);
    const int64_t np = rec[0];
#pragma unroll
    for (int p = 0; p < P; p++) {
        if (p < np) {
            const T v = old_block_sum<F>(acc[p], red);
            if (threadIdx.x == 0) {
                const int64_t o = rec[old_OOD_OUT(P, p)];
                for (int k = 0; k < F::SLOTS; k++)
                    partial[old_ood_partial_index(blockIdx.y, k, o, pairs,
                                              F::SLOTS)] = F::plane(v, k);
            }
        }
    }
}

// out[k] = sum over the chunks of partial[c * K + k], a block a word
__global__ void __launch_bounds__(256)
    old_ood_reduce_kernel(const uint64_t* __restrict__ partial,
                      uint64_t* __restrict__ out, int64_t chunks, int64_t K) {
    __shared__ uint64_t red[256 / 32];
    const int64_t k = blockIdx.x;
    uint64_t v = 0;
    for (int64_t c = threadIdx.x; c < chunks; c += blockDim.x)
        v = gl_add(v, partial[c * K + k]);
    v = old_block_sum<dp_fp>(v, red);
    if (threadIdx.x == 0) out[k] = v;
}

template <class F, int P, int THREADS = old_OOD_THREADS>
static int old_launch_ood(const int64_t* recs, int64_t groups,
                      const uint64_t* gpow, uint64_t* partial, uint64_t* out,
                      int64_t n, int64_t chunks, int64_t pairs,
                      cudaStream_t stream) {
    if (groups > 65535 || chunks < 1 || chunks > 65535)
        return (int)cudaErrorInvalidValue;
    if (n > 0 && groups > 0 && pairs > 0) {
        const int64_t chunk = (n + chunks - 1) / chunks;
        old_ood_kernel<F, P, THREADS><<<dim3((unsigned)groups, (unsigned)chunks),
                                    THREADS, 0, stream>>>(recs, gpow, partial,
                                                          n, chunk, pairs);
        const int64_t K = F::SLOTS * pairs;
        old_ood_reduce_kernel<<<(unsigned)K, 256, 0, stream>>>(
            partial, out, chunks, K);
    }
    return ms_last_error();
}

MS_API int ab_old_ood_sums(const int64_t* recs, int64_t groups,
                       const uint64_t* gpow, uint64_t* partial, uint64_t* out,
                       int64_t n, int64_t chunks, int64_t pairs,
                       cudaStream_t stream) {
    return old_launch_ood<dp_fp, 8>(recs, groups, gpow, partial, out, n, chunks,
                                 pairs, stream);
}

MS_API int ab_old_ood_sums_ext3(const int64_t* recs, int64_t groups,
                            const uint64_t* gpow, uint64_t* partial,
                            uint64_t* out, int64_t n, int64_t chunks,
                            int64_t pairs, cudaStream_t stream) {
    return old_launch_ood<dp_fq3, 4>(recs, groups, gpow, partial, out, n, chunks,
                                 pairs, stream);
}
