// Kernel F: the DEEP phase over the LDE domain, over Fp (fib) or Fq3
// (brainfuck) transcripts, in two entry points.
//
// The DEEP sum (ms_deep, ms_deep_ext3) replaces
// ministark_tpu/ops/deep_pallas.py `_group_kernel_base` and
// `_finish_kernel_base` (Fp), `_group_kernel_ext` (deep_pallas.py:64) and
// `_finish_kernel_ext` (:125) (Fq3):
//
//   out[i] = (sum_t alpha_t * (ood_t - T_t[i]) * inv_t[i]) * (A + B * x[i])
//
// with inv_t = 1/(y_t - x) the barycentric inverses of term t's OOD point.
// The OOD sums (ms_ood_sums, ms_ood_sums_ext3) replace the XLA program
// beside the Pallas kernel, ministark_tpu/composer.py `_ood_program_impl`
// (prog_fp, prog_ext): for every OOD point j and column c it uses,
//
//   S[j][c] = sum_i col_c[i] * inv_j[i] * g^i.
//
// Both reached from composer.py's DEEP phase; the math is in deep.cuh.
//
// Bound on the card: integer operations for Fq3 transcripts, bytes for Fp
// (chip_smoke.py's model).  Design:
//  - DEEP: the plan, the scalars and each group's C_g are staged in shared
//    memory once a block.  A block holds 256 / lanes points, each shared by
//    `lanes` threads in different warps (a warp runs one segment, so its
//    loads are coalesced and its branches uniform); the lanes' partial
//    sums meet in shared memory and lane 0 multiplies by (A + B x) and
//    stores.  The host picks lanes (ops/deep.py deep_lanes): two for Fq3
//    transcripts, one for Fp ones (timed in turns, scripts/ab_kernels.py).
//  - OOD: block (group, chunk) streams the chunk's points of the group's
//    columns, a thread every THREADS-th point: first every load of the
//    point (unused pairs repeat a valid column, so no load waits on a
//    branch; through the read-only cache), then each pair's products added
//    unreduced into 160-bit accumulators (deep.cuh `ood_mac`: a 32-bit
//    carry chain, no reduction a term), reduced mod p once a thread before
//    the block's warp-shuffle sum; one partial a pair and chunk, and a
//    second launch sums the chunks' partials.  A thread keeps its point's
//    weights in its column of a shared-memory table, which each pair reads
//    at its slot's offset.  g^i is not read: the block's first thread
//    makes the table g^(2^b) from gpow[0] and gpow[1] (the row is f g^i:
//    all of it or a rank's cyclic share), each thread its first power from
//    it and then one product a point.  The grid is one wave of the blocks
//    the card holds (deep.cuh ood_chunk_count over
//    cudaOccupancyMaxActiveBlocksPerMultiprocessor: at least enough that
//    no thread takes more than OOD_MAX_RUN points; the wrapper sizes the
//    partials by ms_ood_chunks), so the first thread's table is made once
//    an SM.  Fp transcripts (bound by bytes) take every pair in one group
//    (P the smallest of 16, 20, 32 pairs that holds them, up to 4
//    points), so each column and inverse row is read once a point.  Fq3
//    transcripts (bound by operations) keep groups of two points: OOD_P3
//    pairs of Fq3 columns, OOD_P30 of Fp columns (three accumulators a
//    pair, not nine products); an Fq3 column's products take the
//    schoolbook form (deep.cuh OOD_KARA: the lazy Karatsuba was no
//    faster).  P, P0, the form and the threads were timed in turns
//    (scripts/ab_kernels.py --ood-variants; --ood against the grouped
//    kernel this replaced, scripts/ood_grouped.cu).
#include "deep.cuh"
#include "launch.cuh"

#define DEEP_THREADS 256

template <class F>
__global__ void __launch_bounds__(DEEP_THREADS)
    deep_kernel(const int64_t* __restrict__ plan,
                const uint64_t* __restrict__ s,
                const uint64_t* __restrict__ x, uint64_t* __restrict__ out,
                int64_t n, int lanes) {
    typedef typename F::T T;
    extern __shared__ __align__(16) unsigned char mem[];
    __shared__ T red[DEEP_THREADS];
    DeepStaged<F> st = deep_staged<F>(plan, s, mem);
    deep_stage_terms<F>(plan, st, threadIdx.x, blockDim.x);
    __syncthreads();
    deep_stage_segs<F>(st, threadIdx.x, blockDim.x);
    __syncthreads();
    const int per = blockDim.x / lanes;
    const int lane = threadIdx.x / per, p = threadIdx.x % per;
    for (int64_t base = (int64_t)blockIdx.x * per; base < n;
         base += (int64_t)gridDim.x * per) {
        const int64_t i = base + p;
        T r = i < n ? deep_lane<F>(st, i, n, lane, lanes) : F::zero();
        if (lanes > 1) {
            red[threadIdx.x] = r;
            __syncthreads();
            if (lane == 0)
                for (int l = 1; l < lanes; l++)
                    r = F::add(r, red[l * per + p]);
            __syncthreads();
        }
        if (lane == 0 && i < n) F::store(out, i, n, deep_finish<F>(st, r, x[i]));
    }
}

template <class F>
static int launch_deep(const int64_t* plan, int64_t T, int64_t nseg,
                       const uint64_t* s, const uint64_t* x, uint64_t* out,
                       int64_t n, int lanes, cudaStream_t stream) {
    if (lanes < 1 || lanes > 32 || DEEP_THREADS % lanes)
        return (int)cudaErrorInvalidValue;
    if (n > 0) {
        const int64_t bytes = deep_staged_bytes<F>(T, nseg);
        if (bytes > 40 * 1024) return (int)cudaErrorInvalidValue;
        const int per = DEEP_THREADS / lanes;
        int64_t blocks = (n + per - 1) / per;
        if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride over the rest
        deep_kernel<F><<<(unsigned)blocks, DEEP_THREADS, (size_t)bytes,
                         stream>>>(plan, s, x, out, n, lanes);
    }
    return ms_last_error();
}

MS_API int ms_deep(const int64_t* plan, int64_t T, int64_t nseg,
                   const uint64_t* s, const uint64_t* x, uint64_t* out,
                   int64_t n, int lanes, cudaStream_t stream) {
    return launch_deep<dp_fp>(plan, T, nseg, s, x, out, n, lanes, stream);
}

MS_API int ms_deep_ext3(const int64_t* plan, int64_t T, int64_t nseg,
                        const uint64_t* s, const uint64_t* x, uint64_t* out,
                        int64_t n, int lanes, cudaStream_t stream) {
    return launch_deep<dp_fq3>(plan, T, nseg, s, x, out, n, lanes, stream);
}

// -- the OOD sums ---------------------------------------------------------------

#define OOD_W 4        // points a group of an Fp transcript
#define OOD_T 128      // threads a block, Fp
#define OOD_W3 2       // points a group of an Fq3 transcript
#define OOD_P3 4       // pairs a group of Fq3 columns, Fq3 transcripts
#define OOD_P30 12     // pairs a group of Fp columns, Fq3 transcripts
#define OOD_T3 128     // threads a block, Fq3

__device__ __forceinline__ uint64_t shfl_down(uint64_t v, int d) {
    return __shfl_down_sync(0xffffffffu, (unsigned long long)v, d);
}
__device__ __forceinline__ gl3 shfl_down(gl3 v, int d) {
    return gl3_make(shfl_down(v.c0, d), shfl_down(v.c1, d),
                    shfl_down(v.c2, d));
}

// The sum of v over the block, in thread 0 (red: a value a warp)
template <class F>
__device__ __forceinline__ typename F::T block_sum(typename F::T v,
                                                   typename F::T* red) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v = F::add(v, shfl_down(v, d));
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    __syncthreads();  // red is free
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (threadIdx.x == 0)
        for (int w = 1; w < (int)blockDim.x / 32; w++) v = F::add(v, red[w]);
    return v;
}

// A block's points a + threadIdx.x + k THREADS < b of one group, its first
// Q pairs, columns of kind K (Fq3 transcripts; KARA: Fq3 columns in
// Karatsuba form), then its partial sums; gi = g^(first point)
template <bool EXT, int K, bool KARA, int Q, int P, int W, int THREADS>
__device__ __forceinline__ void ood_block(const OodRec<P, W>& r, uint32_t a,
                                          uint32_t b, uint32_t n, uint64_t gi,
                                          uint64_t step, uint64_t* wt,
                                          uint64_t* partial, int64_t pairs,
                                          gl3* red) {
    constexpr bool KA = KARA && K == 1;
    constexpr int A = OOD_ACCS(EXT, KA);
    ood_acc acc[Q * A];
#pragma unroll
    for (int p = 0; p < Q * A; p++) ood_acc_zero(acc[p]);
    for (uint32_t i = a + threadIdx.x; i < b; i += THREADS) {
        if (EXT)
            ood_point_fq3<Q, P, W, K, KARA>(r, i, n, gi, acc, wt, THREADS);
        else
            ood_point_fp<P, W>(r, i, gi, acc, wt, THREADS);
        gi = gl_mul_cc_lazy(gi, step);
    }
    const int64_t np = r.pairs();
#pragma unroll
    for (int p = 0; p < Q; p++) {
        if (p < np) {
            const int64_t o = r.out(p);
            if (EXT) {
                const gl3 v = block_sum<dp_fq3>(
                    ood_finish_fq3<KA>(acc + p * A), red);
                if (threadIdx.x == 0)
                    for (int k = 0; k < 3; k++)
                        partial[ood_partial_index(blockIdx.y, k, o, pairs,
                                                  3)] = dp_fq3::plane(v, k);
            } else {
                const uint64_t v = block_sum<dp_fp>(
                    ood_acc_reduce(acc[p]), (uint64_t*)red);
                if (threadIdx.x == 0)
                    partial[ood_partial_index(blockIdx.y, 0, o, pairs, 1)] = v;
            }
        }
    }
}

// P: pairs a group (Fp transcripts; Fq3 columns of Fq3 transcripts), P0:
// pairs a group of Fp columns in an Fq3 transcript (P for Fp ones); the
// records hold max(P, P0)
template <bool EXT, bool KARA, int P, int P0, int W, int THREADS>
__global__ void __launch_bounds__(THREADS)
    ood_kernel(const int64_t* __restrict__ recs,
               const uint64_t* __restrict__ gpow,
               uint64_t* __restrict__ partial, uint32_t n, uint32_t chunk,
               int64_t pairs) {
    static_assert(THREADS == 128 || THREADS == 256, "THREADS: 128 or 256");
    constexpr int LOG_T = THREADS == 128 ? 7 : 8;
    constexpr int RP = P > P0 ? P : P0;
    constexpr int NW = OOD_WEIGHT_WORDS(EXT, KARA) * W;
    __shared__ int64_t rec[OOD_RECORD(RP, W)];
    __shared__ uint64_t tbl[32];
    __shared__ uint64_t first;
    __shared__ gl3 red[THREADS / 32];
    __shared__ uint64_t wt[NW * THREADS];  // each thread's weight table
    const int64_t words = OOD_RECORD(RP, W);
    for (int k = threadIdx.x; k < words; k += THREADS)
        rec[k] = recs[blockIdx.x * words + k];
    const uint32_t a = blockIdx.y * chunk;
    const uint32_t b = a >= n ? a : n - a > chunk ? a + chunk : n;
    if (threadIdx.x == 0) {
        ood_pow2_table(gpow[0], gpow[n > 1 ? 1 : 0], n, tbl);
        first = ood_power(tbl, gpow[0], a);
    }
    __syncthreads();
    const uint64_t gi = ood_power(tbl, first, threadIdx.x);
    const uint64_t step = tbl[LOG_T];
    const OodRec<RP, W> r{rec};
    uint64_t* t = wt + threadIdx.x;
    if (EXT && r.kind())
        ood_block<EXT, 1, KARA, P, RP, W, THREADS>(r, a, b, n, gi, step, t,
                                                   partial, pairs, red);
    else
        ood_block<EXT, 0, KARA, P0, RP, W, THREADS>(r, a, b, n, gi, step, t,
                                                    partial, pairs, red);
}

// out[k] = sum over the chunks of partial[c * K + k], a block a word
__global__ void __launch_bounds__(256)
    ood_reduce_kernel(const uint64_t* __restrict__ partial,
                      uint64_t* __restrict__ out, int64_t chunks, int64_t K) {
    __shared__ uint64_t red[256 / 32];
    const int64_t k = blockIdx.x;
    uint64_t v = 0;
    for (int64_t c = threadIdx.x; c < chunks; c += blockDim.x)
        v = gl_add(v, partial[c * K + k]);
    v = block_sum<dp_fp>(v, red);
    if (threadIdx.x == 0) out[k] = v;
}

// The chunks a launch of this instantiation cuts a group's n points into
// (deep.cuh ood_chunk_count, over the blocks the card holds at once:
// cudaOccupancyMaxActiveBlocksPerMultiprocessor)
template <bool EXT, bool KARA, int P, int P0, int W, int THREADS>
static int64_t ood_chunks(int64_t n, int64_t groups) {
    static int resident = 0;
    if (!resident) {
        int dev = 0, sms = 0, per = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per, ood_kernel<EXT, KARA, P, P0, W, THREADS>, THREADS, 0);
        resident = sms * (per > 0 ? per : 1);
    }
    return ood_chunk_count(n, groups, resident, THREADS);
}

// capacity: the chunks the partials hold (ms_ood_chunks' count)
template <bool EXT, bool KARA, int P, int P0, int W, int THREADS>
static int launch_ood(const int64_t* recs, int64_t groups,
                      const uint64_t* gpow, uint64_t* partial, uint64_t* out,
                      int64_t n, int64_t capacity, int64_t pairs,
                      cudaStream_t stream) {
    if (groups > 65535 || n > (1LL << 31)) return (int)cudaErrorInvalidValue;
    if (n > 0 && groups > 0 && pairs > 0) {
        const int64_t chunks =
            ood_chunks<EXT, KARA, P, P0, W, THREADS>(n, groups);
        if (chunks > capacity) return (int)cudaErrorInvalidValue;
        const int64_t chunk = (n + chunks - 1) / chunks;
        ood_kernel<EXT, KARA, P, P0, W, THREADS>
            <<<dim3((unsigned)groups, (unsigned)chunks), THREADS, 0,
               stream>>>(recs, gpow, partial, (uint32_t)n, (uint32_t)chunk,
                         pairs);
        const int64_t K = (EXT ? 3 : 1) * pairs;
        ood_reduce_kernel<<<(unsigned)K, 256, 0, stream>>>(
            partial, out, chunks, K);
    }
    return ms_last_error();
}

// The shipped instantiations: Fp transcripts every pair in one group of
// P = 16 (S), 20 (F, R, D) or 32 (more pairs: groups of 32), 4 points; Fq3
// transcripts OOD_P3 / OOD_P30 pairs and 2 points, the Fq3 product in
// OOD_KARA's form
#define OOD_FP_CASES(X) X(16) X(20) X(32)
#define OOD_FP_ARGS(p) false, false, p, p, OOD_W, OOD_T
#define OOD_FQ3_ARGS true, OOD_KARA, OOD_P3, OOD_P30, OOD_W3, OOD_T3

// The chunks the partials must hold for a launch of ms_ood_sums at P pairs
// a group (ext 0) or of ms_ood_sums_ext3 (ext 1) on `groups` groups of n
// points; -1 for a P with no instantiation
MS_API int64_t ms_ood_chunks(int64_t ext, int64_t P, int64_t n,
                             int64_t groups) {
    if (ext) return ood_chunks<OOD_FQ3_ARGS>(n, groups);
#define OOD_FP_CHUNKS(p) \
    if (P == p) return ood_chunks<OOD_FP_ARGS(p)>(n, groups);
    OOD_FP_CASES(OOD_FP_CHUNKS)
#undef OOD_FP_CHUNKS
    return -1;
}

// P: the pairs a group of the records (ops/deep.py OOD_FP_PAIRS)
MS_API int ms_ood_sums(const int64_t* recs, int64_t groups,
                       const uint64_t* gpow, uint64_t* partial, uint64_t* out,
                       int64_t n, int64_t capacity, int64_t pairs, int64_t P,
                       cudaStream_t stream) {
#define OOD_FP_LAUNCH(p)                                                  \
    if (P == p)                                                           \
        return launch_ood<OOD_FP_ARGS(p)>(recs, groups, gpow, partial, out, \
                                          n, capacity, pairs, stream);
    OOD_FP_CASES(OOD_FP_LAUNCH)
#undef OOD_FP_LAUNCH
    return (int)cudaErrorInvalidValue;
}

// the records of OOD_P3 pairs of Fq3 columns or OOD_P30 of Fp columns
// (ops/deep.py OOD_P3, OOD_P30)
MS_API int ms_ood_sums_ext3(const int64_t* recs, int64_t groups,
                            const uint64_t* gpow, uint64_t* partial,
                            uint64_t* out, int64_t n, int64_t capacity,
                            int64_t pairs, cudaStream_t stream) {
    return launch_ood<OOD_FQ3_ARGS>(recs, groups, gpow, partial, out, n,
                                    capacity, pairs, stream);
}
