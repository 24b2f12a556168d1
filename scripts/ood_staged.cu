// Kernel F's OOD sums, S[j][c] = sum_i col_c[i] inv_j[i] g^i, in a
// second design kept for scripts/ab_kernels.py --ood-staged to time
// against the one csrc/deep.cu ships: a block takes a tile of points at a
// time, stages the weights w_j[i] = inv_j[i] g^i of every OOD point j for
// the tile in shared memory, then each of its warps streams one group of
// at most P (point, column) pairs against them, a column once a point,
// the group's sums in registers over all the block's tiles; one partial a
// pair and block, and a second launch sums the blocks'.  Built by
// ab_kernels.py with the port's nvcc flags and csrc/ on the include path.
//
// A group, STAGED_GROUP(P) int64 words (ab_kernels.py `_staged_groups`):
//   [pairs, kind (0 Fp columns, 1 Fq3), P column pointers,
//    P metas (point << 1, bit 0 where the pair reads the column of the
//    pair before it), P output indices]
// The weights sit plane-major in shared memory: plane k of point j's
// weight at w[(j * SLOTS + k) * tile + p].
#include "deep.cuh"
#include "launch.cuh"

#define STAGED_MAX_THREADS 512
#define STAGED_SHARED (192 * 1024)
#define STAGED_GROUP(P) (2 + 3 * (P))

// a column's value at i as V (an Fp column's or an Fq3 one's), and the
// product of a weight with it
__device__ __forceinline__ uint64_t ood_load(const uint64_t* p, int64_t i,
                                             int64_t, uint64_t) {
    return p[i];
}
__device__ __forceinline__ gl3 ood_load(const uint64_t* p, int64_t i,
                                        int64_t n, gl3) {
    return gl3_load(p, i, n);
}
template <class F>
__device__ __forceinline__ typename F::T ood_mul(typename F::T w,
                                                 uint64_t v) {
    return F::mul_base(w, v);
}
template <class F>
__device__ __forceinline__ typename F::T ood_mul(typename F::T w, gl3 v) {
    return F::mul(w, v);
}

__device__ __forceinline__ uint64_t st_shfl_down(uint64_t v, int d) {
    return __shfl_down_sync(0xffffffffu, (unsigned long long)v, d);
}
__device__ __forceinline__ gl3 st_shfl_down(gl3 v, int d) {
    return gl3_make(st_shfl_down(v.c0, d), st_shfl_down(v.c1, d),
                    st_shfl_down(v.c2, d));
}

// the weights of the tile's points t0 + p, p < len, thread tid's share
template <class F>
__device__ void staged_weights(const uint64_t* inv, int64_t npts,
                               const uint64_t* gpow, int64_t n, int64_t t0,
                               int64_t len, uint64_t* w, int64_t tile) {
    for (int64_t p = threadIdx.x; p < len; p += blockDim.x) {
        const uint64_t g = gpow[t0 + p];
        for (int64_t j = 0; j < npts; j++) {
            const typename F::T v =
                F::mul_base(F::load(inv + j * F::SLOTS * n, t0 + p, n), g);
            for (int k = 0; k < F::SLOTS; k++)
                w[(j * F::SLOTS + k) * tile + p] = F::plane(v, k);
        }
    }
}

template <class F, int P, class V>
__device__ void staged_points(const int64_t* rec, const uint64_t* w,
                              int64_t tile, int64_t t0, int64_t len,
                              int64_t n, int lane, typename F::T* acc) {
    const int64_t np = rec[0];
    const int64_t* meta = rec + 2 + P;
    const uint64_t* col[P];
    const uint64_t* wp[P];
#pragma unroll
    for (int p = 0; p < P; p++) {
        col[p] = (const uint64_t*)rec[2 + p];
        wp[p] = w + (p < np ? meta[p] >> 1 : 0) * F::SLOTS * tile;
    }
#pragma unroll 2
    for (int64_t i = lane; i < len; i += 32) {
        V v = V();
#pragma unroll
        for (int p = 0; p < P; p++)
            if (p < np) {
                if (!(meta[p] & 1)) v = ood_load(col[p], t0 + i, n, V());
                acc[p] = F::add(acc[p],
                                ood_mul<F>(F::load(wp[p], i, tile), v));
            }
    }
}

template <class F, int P>
__global__ void __launch_bounds__(STAGED_MAX_THREADS)
    staged_kernel(const int64_t* __restrict__ groups, int64_t ngroups,
                  const uint64_t* __restrict__ inv, int64_t npts,
                  const uint64_t* __restrict__ gpow,
                  uint64_t* __restrict__ partial, int64_t n, int64_t tile,
                  int64_t pairs) {
    typedef typename F::T T;
    extern __shared__ __align__(16) uint64_t w[];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int64_t g = (int64_t)blockIdx.y * (blockDim.x / 32) + warp;
    const bool mine = g < ngroups;
    const int64_t* rec = groups + (mine ? g : 0) * STAGED_GROUP(P);
    T acc[P];
#pragma unroll
    for (int p = 0; p < P; p++) acc[p] = F::zero();
    for (int64_t t0 = (int64_t)blockIdx.x * tile; t0 < n;
         t0 += (int64_t)gridDim.x * tile) {
        const int64_t len = n - t0 < tile ? n - t0 : tile;
        __syncthreads();  // the last tile's weights are read
        staged_weights<F>(inv, npts, gpow, n, t0, len, w, tile);
        __syncthreads();
        if (!mine) continue;
        if constexpr (F::SLOTS == 3) {
            if (rec[1]) {
                staged_points<F, P, gl3>(rec, w, tile, t0, len, n, lane,
                                         acc);
                continue;
            }
        }
        staged_points<F, P, uint64_t>(rec, w, tile, t0, len, n, lane, acc);
    }
    if (!mine) return;
#pragma unroll
    for (int p = 0; p < P; p++)
        if (p < rec[0]) {
            T v = acc[p];
#pragma unroll
            for (int d = 16; d > 0; d >>= 1) v = F::add(v, st_shfl_down(v, d));
            if (lane == 0)
                for (int s = 0; s < F::SLOTS; s++)
                    partial[((int64_t)blockIdx.x * F::SLOTS + s) * pairs +
                            rec[2 + 2 * P + p]] = F::plane(v, s);
        }
}

// out[k] = sum over the blocks of partial[c * K + k], a block a word
__global__ void __launch_bounds__(256)
    staged_reduce_kernel(const uint64_t* __restrict__ partial,
                         uint64_t* __restrict__ out, int64_t blocks,
                         int64_t K) {
    __shared__ uint64_t red[256 / 32];
    uint64_t v = 0;
    for (int64_t c = threadIdx.x; c < blocks; c += blockDim.x)
        v = gl_add(v, partial[c * K + blockIdx.x]);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v = gl_add(v, st_shfl_down(v, d));
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int k = 1; k < 256 / 32; k++) v = gl_add(v, red[k]);
        out[blockIdx.x] = v;
    }
}

// groups one a warp, `warps` warps a block; at most `blocks` blocks along
// the points (fewer where the card holds fewer at once)
template <class F, int P>
static int launch_staged(const int64_t* groups, int64_t ngroups,
                         int64_t warps, const uint64_t* inv, int64_t npts,
                         const uint64_t* gpow, uint64_t* partial,
                         uint64_t* out, int64_t n, int64_t tile,
                         int64_t blocks, int64_t pairs, cudaStream_t stream) {
    const int64_t bytes = npts * F::SLOTS * tile * 8;
    if (tile < 32 || warps < 1 || warps * 32 > STAGED_MAX_THREADS ||
        blocks < 1 || blocks > 65535 || bytes > STAGED_SHARED)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        staged_kernel<F, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        STAGED_SHARED);
    if (e != cudaSuccess) return (int)e;
    if (n > 0 && ngroups > 0) {
        const int64_t batches = (ngroups + warps - 1) / warps;
        int dev, sms, per_sm = 0;
        e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, staged_kernel<F, P>, (int)(warps * 32),
                (size_t)bytes);
        if (e != cudaSuccess) return (int)e;
        const int64_t fit = (int64_t)per_sm * sms / batches;
        if (fit >= 1 && blocks > fit) blocks = fit;
        staged_kernel<F, P><<<dim3((unsigned)blocks, (unsigned)batches),
                              (unsigned)(warps * 32), (size_t)bytes,
                              stream>>>(groups, ngroups, inv, npts, gpow,
                                        partial, n, tile, pairs);
        const int64_t K = F::SLOTS * pairs;
        staged_reduce_kernel<<<(unsigned)K, 256, 0, stream>>>(partial, out,
                                                             blocks, K);
    }
    return ms_last_error();
}

#define STAGED_ENTRY(name, F, P)                                             \
    MS_API int name(const int64_t* groups, int64_t ngroups, int64_t warps,  \
                    const uint64_t* inv, int64_t npts, const uint64_t* gpow, \
                    uint64_t* partial, uint64_t* out, int64_t n,             \
                    int64_t tile, int64_t blocks, int64_t pairs,             \
                    cudaStream_t stream) {                                   \
        return launch_staged<F, P>(groups, ngroups, warps, inv, npts, gpow,  \
                                   partial, out, n, tile, blocks, pairs,     \
                                   stream);                                  \
    }
STAGED_ENTRY(ab_staged_fp_p2, dp_fp, 2)
STAGED_ENTRY(ab_staged_fp_p4, dp_fp, 4)
STAGED_ENTRY(ab_staged_fp_p8, dp_fp, 8)
STAGED_ENTRY(ab_staged_fq3_p2, dp_fq3, 2)
STAGED_ENTRY(ab_staged_fq3_p4, dp_fq3, 4)
