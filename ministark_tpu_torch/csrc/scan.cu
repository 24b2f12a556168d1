// The affine scan of the brainfuck extension columns over Fq3 (scan.py
// affine_scan_ext3): for each column c of a (B, 3, n) batch,
//
//   s_0 = init[c],  s_{i+1} = a_i s_i + b_i,
//
// stored as the state after step i (inclusive columns) or before it
// (exclusive ones: out[0] = init).  It replaces no Pallas kernel: the JAX
// package runs the same doubling as XLA code (ministark_tpu/scan.py:32
// affine_scan_ext3), and the port ran it as 20 plain-torch Hillis-Steele
// passes at 2^20 rows, each two full Fq3 products over the batch.  The
// math is in scan.cuh.
//
// Bound on the card: bytes.  The scan must read a and b once and write the
// result once, 72 bytes an element: 0.20 ms at 9 x 2^20 at 3.35 TB/s.  Its
// least work, one Fq3 product an element, takes about two thirds of that
// on the integer pipes; a parallel scan does three (two to fold a run of
// maps, one to walk it again from its incoming state) and the block scans
// besides, so the kernel sits on the operations' side of the line.
// Design, three launches:
//  1. scan_fold_kernel: a block takes a tile of SCAN_THREADS * SCAN_K
//     elements of one column, staged in shared memory with coalesced
//     loads; each thread folds its SCAN_K consecutive maps in registers
//     (scan_thread_fold); the block scans its threads' folds (five
//     warp-shuffle steps, then the warps' folds through shared memory,
//     scanned by warp 0), and stores each thread's prefix (the fold of the
//     tile's earlier threads) and the tile's fold.
//  2. scan_column_kernel: one block a column scans the tiles' folds from
//     init, which gives each tile its incoming state.
//  3. scan_apply_kernel: the tile staged again; each thread applies its
//     prefix to the tile's incoming state and walks its maps again
//     (scan_thread_walk), writing the states over the staged a, which the
//     block stores with coalesced stores.
// Each Fq3 product sums the schoolbook's nine products unreduced in 160
// bits and reduces once a component (scan.cuh scan_mul_add).  Timed in
// turns on an H100 against the alternatives (PERF.md §6, row 16): at 9 x
// 2^20 the three launches beat a one-pass decoupled look-back (each tile
// publishing its fold and then its end state, thread 0 folding back over
// its column's earlier tiles) by 30%, as most blocks waited on the chain
// of end states; staging beat reading the runs in place (a warp's 8-byte
// loads 64 bytes apart) by 2.3x, the lazy schoolbook gl3_mul_cc's
// Karatsuba by 1.8x; 256 threads of 8 elements beat 128 threads and 16
// elements.  The wrapper allocates the scratch
// (ms_affine_scan_ext3_scratch); the kernels allocate nothing and the host
// waits on nothing.
#include "launch.cuh"
#include "scan.cuh"

#define FULL_MASK 0xFFFFFFFFu

__device__ __forceinline__ aff3 aff3_shfl_up(aff3 f, int d) {
    aff3 r;
    r.a.c0 = __shfl_up_sync(FULL_MASK, f.a.c0, d);
    r.a.c1 = __shfl_up_sync(FULL_MASK, f.a.c1, d);
    r.a.c2 = __shfl_up_sync(FULL_MASK, f.a.c2, d);
    r.b.c0 = __shfl_up_sync(FULL_MASK, f.b.c0, d);
    r.b.c1 = __shfl_up_sync(FULL_MASK, f.b.c1, d);
    r.b.c2 = __shfl_up_sync(FULL_MASK, f.b.c2, d);
    return r;
}

// The block's scan of its threads' folds `mine`, in thread order: the
// fold of the earlier threads of the block (prefix) and of all its
// threads (total).  warp_sh holds T / 32 folds; the block must not reuse
// it before a __syncthreads().
template <int T>
__device__ __forceinline__ void scan_block(aff3 mine, aff3* warp_sh,
                                           aff3& prefix, aff3& total) {
    constexpr int NW = T / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    aff3 incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const aff3 lo = aff3_shfl_up(incl, d);
        if (lane >= d) incl = aff3_then(lo, incl);
    }
    aff3 lane_excl = aff3_shfl_up(incl, 1);
    if (lane == 0) lane_excl = aff3_identity();
    if (lane == 31) warp_sh[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        aff3 w = lane < NW ? warp_sh[lane] : aff3_identity();
#pragma unroll
        for (int d = 1; d < NW; d <<= 1) {
            const aff3 lo = aff3_shfl_up(w, d);
            if (lane >= d) w = aff3_then(lo, w);
        }
        if (lane < NW) warp_sh[lane] = w;
    }
    __syncthreads();
    prefix = warp == 0 ? lane_excl : aff3_then(warp_sh[warp - 1], lane_excl);
    total = warp_sh[NW - 1];
}

// a map's six words at w, w + stride, ... (a's components, then b's)
__device__ __forceinline__ void aff3_put(uint64_t* w, int64_t stride,
                                         aff3 f) {
    gl3_store(w, 0, stride, f.a);
    gl3_store(w, 3 * stride, stride, f.b);
}

__device__ __forceinline__ aff3 aff3_get(const uint64_t* w, int64_t stride) {
    return aff3_make(gl3_load(w, 0, stride), gl3_load(w, 3 * stride, stride));
}

// The tile from t0 of a column's planes a and b into shared memory
// (scan.cuh scan_slot), coalesced; zeros past n
template <int T, int K>
__device__ __forceinline__ void tile_load(uint64_t* sm, const uint64_t* a,
                                          const uint64_t* b, int64_t n,
                                          int64_t t0) {
#pragma unroll
    for (int p = 0; p < 6; p++) {
        const uint64_t* src = (p < 3 ? a + p * n : b + (p - 3) * n) + t0;
#pragma unroll
        for (int k = 0; k < K; k++) {
            const int e = k * T + threadIdx.x;
            sm[p * SCAN_PLANE(T, K) + scan_slot(e, K)] =
                t0 + e < n ? __ldg((const unsigned long long*)src + e) : 0;
        }
    }
}

// The states written over the tile's a planes, to the column's out
template <int T, int K>
__device__ __forceinline__ void tile_store(const uint64_t* sm, uint64_t* out,
                                           int64_t n, int64_t t0) {
#pragma unroll
    for (int p = 0; p < 3; p++)
#pragma unroll
        for (int k = 0; k < K; k++) {
            const int e = k * T + threadIdx.x;
            if (t0 + e < n)
                out[p * n + t0 + e] =
                    sm[p * SCAN_PLANE(T, K) + scan_slot(e, K)];
        }
}

template <int T, int K>
__global__ void __launch_bounds__(T)
    scan_fold_kernel(const uint64_t* __restrict__ a,
                     const uint64_t* __restrict__ b, int64_t n, int64_t tpc,
                     uint64_t* __restrict__ prefixes,
                     uint64_t* __restrict__ tile_a,
                     uint64_t* __restrict__ tile_b) {
    extern __shared__ uint64_t sm[];
    __shared__ aff3 warp_sh[T / 32];
    const int64_t tile = blockIdx.x, c = tile / tpc, j = tile % tpc;
    const int64_t t0 = j * (T * K);
    tile_load<T, K>(sm, a + c * 3 * n, b + c * 3 * n, n, t0);
    __syncthreads();
    aff3 prefix, total;
    scan_block<T>(scan_thread_fold<K>(sm, sm + 3 * SCAN_PLANE(T, K),
                                      SCAN_PLANE(T, K),
                                      scan_slot(threadIdx.x * K, K),
                                      scan_count(n, t0 + threadIdx.x * K, K)),
                  warp_sh, prefix, total);
    aff3_put(prefixes + tile * 6 * T + threadIdx.x, T, prefix);
    if (threadIdx.x == 0) {
        gl3_store(tile_a + c * 3 * tpc, j, tpc, total.a);
        gl3_store(tile_b + c * 3 * tpc, j, tpc, total.b);
    }
}

// each tile's incoming state: the exclusive scan of the column's tiles'
// folds (tpc of them, as (B, 3, tpc) planes of a and b) from init
template <int T>
__global__ void __launch_bounds__(T)
    scan_column_kernel(const uint64_t* __restrict__ a,
                       const uint64_t* __restrict__ b,
                       const uint64_t* __restrict__ init,
                       uint64_t* __restrict__ out, int64_t tpc) {
    __shared__ aff3 warp_sh[T / 32];
    const int64_t c = blockIdx.x;
    const uint64_t* ac = a + c * 3 * tpc;
    const uint64_t* bc = b + c * 3 * tpc;
    gl3 s = gl3_load(init, 3 * c, 1);
    for (int64_t t0 = 0; t0 < tpc; t0 += T) {
        const int64_t i = t0 + threadIdx.x, count = scan_count(tpc, i, 1);
        aff3 prefix, total;
        scan_block<T>(scan_thread_fold<1>(ac, bc, tpc, i, count), warp_sh,
                      prefix, total);
        scan_thread_walk<1>(ac, bc, out + c * 3 * tpc, tpc, i, count,
                            aff3_apply(prefix, s), false);
        s = aff3_apply(total, s);
        __syncthreads();
    }
}

template <int T, int K>
__global__ void __launch_bounds__(T)
    scan_apply_kernel(const uint64_t* __restrict__ a,
                      const uint64_t* __restrict__ b, uint64_t mask,
                      uint64_t* __restrict__ out, int64_t n, int64_t tpc,
                      const uint64_t* __restrict__ prefixes,
                      const uint64_t* __restrict__ tile_in) {
    extern __shared__ uint64_t sm[];
    const int64_t tile = blockIdx.x, c = tile / tpc, j = tile % tpc;
    const int64_t t0 = j * (T * K);
    tile_load<T, K>(sm, a + c * 3 * n, b + c * 3 * n, n, t0);
    __syncthreads();
    scan_thread_walk<K>(
        sm, sm + 3 * SCAN_PLANE(T, K), sm, SCAN_PLANE(T, K),
        scan_slot(threadIdx.x * K, K), scan_count(n, t0 + threadIdx.x * K, K),
        aff3_apply(aff3_get(prefixes + tile * 6 * T + threadIdx.x, T),
                   gl3_load(tile_in + c * 3 * tpc, j, tpc)),
        (mask >> c) & 1);
    __syncthreads();
    tile_store<T, K>(sm, out + c * 3 * n, n, t0);
}

// The scratch, in 64-bit words: each thread's prefix, then the tiles' folds
// (a and b planes) and their incoming states
MS_API int64_t ms_affine_scan_ext3_scratch(int64_t B, int64_t n) {
    const int64_t tiles = B * scan_tiles(n, SCAN_THREADS * SCAN_K);
    return tiles * (6 * SCAN_THREADS + 9);
}

// a, b, out: (B, 3, n); init: (B, 3); bit c of mask: column c inclusive
// (B <= 64); scratch: ms_affine_scan_ext3_scratch(B, n) words
MS_API int ms_affine_scan_ext3(const uint64_t* a, const uint64_t* b,
                               const uint64_t* init, uint64_t mask,
                               uint64_t* out, int64_t B, int64_t n,
                               uint64_t* scratch, cudaStream_t stream) {
    constexpr int T = SCAN_THREADS, K = SCAN_K;
    constexpr size_t smem = 6 * SCAN_PLANE(T, K) * sizeof(uint64_t);
    static bool fold_set[MS_MAX_DEVICES], apply_set[MS_MAX_DEVICES];
    if (B * n > 0) {
        int e = ms_smem_limit(scan_fold_kernel<T, K>, smem, fold_set);
        if (!e) e = ms_smem_limit(scan_apply_kernel<T, K>, smem, apply_set);
        if (e) return e;
        const int64_t tpc = scan_tiles(n, T * K), tiles = B * tpc;
        uint64_t* prefixes = scratch;
        uint64_t* tile_a = prefixes + tiles * 6 * T;
        uint64_t* tile_b = tile_a + 3 * tiles;
        uint64_t* tile_in = tile_b + 3 * tiles;
        scan_fold_kernel<T, K><<<(unsigned)tiles, T, smem, stream>>>(
            a, b, n, tpc, prefixes, tile_a, tile_b);
        scan_column_kernel<T><<<(unsigned)B, T, 0, stream>>>(
            tile_a, tile_b, init, tile_in, tpc);
        scan_apply_kernel<T, K><<<(unsigned)tiles, T, smem, stream>>>(
            a, b, mask, out, n, tpc, prefixes, tile_in);
    }
    return ms_last_error();
}
