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
//    columns, accumulates each pair in registers (P pairs a group: 4 in
//    Fq3, 8 in Fp; two points a group, so that a thread keeps two
//    weights), reduces over the block with warp shuffles and writes one
//    partial a pair; a second launch sums the chunks' partials.  P and the
//    block's threads were timed in turns (scripts/ab_kernels.py
//    --ood-variants): more pairs a group read the weights' rows fewer
//    times but keep more registers (P = 16: 108-210), fewer warps an SM.  A group's blocks
//    of one chunk run side by side (group is the fast grid dimension), so
//    the inverse rows and g^i they share are read from L2.  Staging the
//    weights of a tile of points in shared memory once for all the groups
//    (scripts/ood_staged.cu) ran slower on the brainfuck path
//    (scripts/ab_kernels.py --ood-staged).
#include "deep.cuh"
#include "launch.cuh"

#define DEEP_THREADS 256
#define OOD_THREADS 256

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

template <class F, int P, int THREADS>
__global__ void __launch_bounds__(THREADS)
    ood_kernel(const int64_t* __restrict__ recs,
               const uint64_t* __restrict__ gpow,
               uint64_t* __restrict__ partial, int64_t n, int64_t chunk,
               int64_t pairs) {
    typedef typename F::T T;
    __shared__ int64_t rec[OOD_RECORD(P)];
    __shared__ T red[THREADS / 32];
    const int64_t words = OOD_RECORD(P);
    for (int k = threadIdx.x; k < words; k += blockDim.x)
        rec[k] = recs[blockIdx.x * words + k];
    __syncthreads();
    T acc[P];
#pragma unroll
    for (int p = 0; p < P; p++) acc[p] = F::zero();
    const int64_t a = blockIdx.y * chunk;
    const int64_t b = a + chunk < n ? a + chunk : n;
    for (int64_t i = a + threadIdx.x; i < b; i += blockDim.x)
        ood_point<F, P>(rec, i, n, gpow[i], acc);
    const int64_t np = rec[0];
#pragma unroll
    for (int p = 0; p < P; p++) {
        if (p < np) {
            const T v = block_sum<F>(acc[p], red);
            if (threadIdx.x == 0) {
                const int64_t o = rec[OOD_OUT(P, p)];
                for (int k = 0; k < F::SLOTS; k++)
                    partial[ood_partial_index(blockIdx.y, k, o, pairs,
                                              F::SLOTS)] = F::plane(v, k);
            }
        }
    }
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

template <class F, int P, int THREADS = OOD_THREADS>
static int launch_ood(const int64_t* recs, int64_t groups,
                      const uint64_t* gpow, uint64_t* partial, uint64_t* out,
                      int64_t n, int64_t chunks, int64_t pairs,
                      cudaStream_t stream) {
    if (groups > 65535 || chunks < 1 || chunks > 65535)
        return (int)cudaErrorInvalidValue;
    if (n > 0 && groups > 0 && pairs > 0) {
        const int64_t chunk = (n + chunks - 1) / chunks;
        ood_kernel<F, P, THREADS><<<dim3((unsigned)groups, (unsigned)chunks),
                                    THREADS, 0, stream>>>(recs, gpow, partial,
                                                          n, chunk, pairs);
        const int64_t K = F::SLOTS * pairs;
        ood_reduce_kernel<<<(unsigned)K, 256, 0, stream>>>(
            partial, out, chunks, K);
    }
    return ms_last_error();
}

MS_API int ms_ood_sums(const int64_t* recs, int64_t groups,
                       const uint64_t* gpow, uint64_t* partial, uint64_t* out,
                       int64_t n, int64_t chunks, int64_t pairs,
                       cudaStream_t stream) {
    return launch_ood<dp_fp, 8>(recs, groups, gpow, partial, out, n, chunks,
                                 pairs, stream);
}

MS_API int ms_ood_sums_ext3(const int64_t* recs, int64_t groups,
                            const uint64_t* gpow, uint64_t* partial,
                            uint64_t* out, int64_t n, int64_t chunks,
                            int64_t pairs, cudaStream_t stream) {
    return launch_ood<dp_fq3, 4>(recs, groups, gpow, partial, out, n, chunks,
                                 pairs, stream);
}
