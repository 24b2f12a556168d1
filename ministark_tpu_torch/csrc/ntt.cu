// Kernel B: batched column NTTs, each column in registers and shared
// memory (the six-step building block).
//
// Replaces ministark_tpu/ops/ntt_pallas.py `_col_ntt_kernel_unrolled`
// (called through `col_ntt` from ntt.py's six-step pipeline).
//
// Computes, for each batch b and column c of x viewed as (B, n1, C):
//   load rows in bit-reversed order (optionally times pre[row, c]),
//   run all log2(n1) radix-2 DIT stages with twiddles tw[k] = w^k, k < n1/2,
//   store canonical values (optionally times tmat[row, c]).
// `pre` and `tmat` are (n1, C) tables shared by every batch: the coset
// scale before the first pass, the six-step twiddle matrix after it, and
// the inverse transform's 1/n * offset^-i after the second pass.
//
// Bound on the card: 32-bit integer instructions.  A column of n1 points
// takes n1/2 log2(n1) butterflies, each a Goldilocks product (a 64x64-bit
// product from four 32-bit multiplies, then a reduction) and an add and a
// sub, against 16 bytes of device traffic per point and pass: about a dozen
// 32-bit operations per byte moved, where the card does five per byte of
// its memory rate, so the time is the instruction stream, and whatever adds
// instructions or stalls it costs directly.  The design:
//  - one instantiation per n1 = 2^L (L = 0..14), so every index, loop bound
//    and shift is a compile-time constant (no division, 32-bit positions);
//  - a thread holds R = 16 values of one column (ntt_sched.cuh) and runs
//    four stages on them in registers per round, so a 2^12-point column is
//    three rounds with two exchanges through shared memory (a write, one
//    barrier, a read) instead of twelve stages that each read and write
//    shared memory behind a barrier; the exchange slots are XOR-swizzled
//    so no round's accesses conflict in the banks;
//  - butterflies keep lazy representatives (one carry or borrow fix, no
//    compare-and-select to canonical form), canonical only at the store;
//    round 0's unit twiddles cost no product; the product is written as
//    32-bit PTX carry chains (`gl_mul_cc`, goldilocks.cuh);
//  - twiddles come from a shared-memory copy of the per-stage tables,
//    laid out as a heap (stage b at [2^b, 2^(b+1))) so consecutive threads
//    read consecutive slots, and the last stage's straight from tw, which
//    consecutive threads read contiguously;
//  - a block owns tc columns (a power of two dividing C; tc * n1 <= 8192,
//    at most 512 threads): two blocks of up to 16 warps fit an SM below
//    ~100 KB of shared memory each, rows are read and written as tc * 8-byte
//    segments, and tc shrinks while the grid has fewer than two blocks per
//    SM; n1 = 2^14 takes one column and 1024 threads a block;
//  - the batch is folded into grid.x, and each instantiation sets its
//    shared-memory limit once, on its first launch.
// Tried and slower at the proves' shapes on an H100: 8 values a thread,
// 4096-value tiles, one block an SM with up to 128 registers a thread, and
// gl_mul's C++ product.  Registers and spills of each instantiation:
// scripts/ptxas_report.py.
//
// Columns longer than 16384 rows take the multi-pass variant
// `ms_col_ntt_pass` at the end of this file.
#include "goldilocks.cuh"
#include "launch.cuh"
#include "ntt_pass.cuh"
#include "ntt_sched.cuh"

// twiddle of bit b for low position bits j: the heap in shared memory, or
// the table itself for the last stage
template <int L>
struct SharedTw {
    const uint64_t* heap;
    const uint64_t* tw;
    __host__ __device__ __forceinline__ uint64_t operator()(int b,
                                                            uint32_t j) const {
#ifdef __CUDA_ARCH__
        return b == L - 1 ? __ldg(tw + j) : heap[(1u << b) + j];
#else
        return 0;  // device only; the host build never calls it
#endif
    }
};

// rounds I.. of a 2^L-point column (UNIT: see ntt_stage)
template <int L, int I, bool UNIT = true, class Tw>
__device__ __forceinline__ void run_rounds(uint64_t* v, uint64_t* tile,
                                           uint32_t f, uint32_t cc, int tc,
                                           const Tw& tw) {
    if constexpr (I < ntt_rounds(L)) {
        if constexpr (I > 0) {
            if constexpr (I > 1) __syncthreads();  // round I-1 read the tile
            ntt_write<L, I - 1>(tile, v, f, cc, tc);
            __syncthreads();
            ntt_read<L, I>(tile, v, f, cc, tc);
        }
        ntt_round<L, I, UNIT>(v, f, tw);
        run_rounds<L, I + 1, UNIT>(v, tile, f, cc, tc, tw);
    }
}

// threads of a block at most: 512 (two blocks an SM), or a whole 2^14-point
// column's 1024 (one)
template <int L>
constexpr int ntt_max_threads() { return L == NTT_MAX_LOG ? 1024 : 512; }

template <int L>
__global__ void __launch_bounds__(ntt_max_threads<L>(),
                                  L == NTT_MAX_LOG ? 1 : 2)
col_ntt_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
               const uint64_t* __restrict__ tw,
               const uint64_t* __restrict__ pre,
               const uint64_t* __restrict__ tmat, int64_t C, int log_tc,
               unsigned col_blocks) {
    constexpr int N = 1 << L;
    extern __shared__ uint64_t smem[];
    uint64_t* heap = smem;           // N/2 slots, slot 0 unused
    uint64_t* tile = smem + N / 2;   // N * tc slots
    const int tc = 1 << log_tc;
    const unsigned b = blockIdx.x / col_blocks;
    const int64_t c = (int64_t)(blockIdx.x - b * col_blocks) * tc +
                      (threadIdx.x & (tc - 1));
    const uint32_t f = threadIdx.x >> log_tc, cc = threadIdx.x & (tc - 1);
    const int64_t off = (int64_t)b * N * C + c;

    uint64_t v[1 << ntt_rl(L)];
    ntt_load<L>(v, x + off, pre ? pre + c : nullptr, f, C);
    for (int e = threadIdx.x + 1; e < N / 2; e += blockDim.x) {
        const int bb = 31 - __clz(e);
        heap[e] = tw[(e - (1 << bb)) << (L - 1 - bb)];
    }
    __syncthreads();
    run_rounds<L, 0>(v, tile, f, cc, tc, SharedTw<L>{heap, tw});
    ntt_store<L>(v, y + off, tmat ? tmat + c : nullptr, f, C);
}

template <int L>
static int col_ntt_launch(const uint64_t* x, uint64_t* y, const uint64_t* tw,
                          const uint64_t* pre, const uint64_t* tmat,
                          int64_t B, int64_t C, cudaStream_t stream) {
    constexpr int N = 1 << L, T = N >> ntt_rl(L);
    constexpr int MAX_THREADS = ntt_max_threads<L>();
    constexpr int TC_MAX = (NTT_TILE_ELEMS >> L) < 1 ? 1
        : ((NTT_TILE_ELEMS >> L) * T > MAX_THREADS ? MAX_THREADS / T
                                                  : NTT_TILE_ELEMS >> L);
    constexpr bool EXCHANGE = ntt_rounds(L) > 1;
    // set once per instantiation and device: the most shared memory it
    // asks for
    static bool configured[MS_MAX_DEVICES];
    const int e = ms_smem_limit(
        col_ntt_kernel<L>,
        ((EXCHANGE ? (size_t)N * TC_MAX : 0) + N / 2) * 8, configured);
    if (e) return e;
    int log_tc = 0;  // columns a block: the largest power of two dividing C
    while ((1 << (log_tc + 1)) <= TC_MAX && C % (2LL << log_tc) == 0) log_tc++;
    // ... but narrower while the grid has fewer than two blocks per SM
    while (log_tc > 2 && (C >> log_tc) * B < 2 * 132) log_tc--;
    const int64_t blocks = (C >> log_tc) * B;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
    const size_t smem = ((EXCHANGE ? (size_t)N << log_tc : 0) + N / 2) * 8;
    col_ntt_kernel<L><<<(unsigned)blocks, T << log_tc, smem, stream>>>(
        x, y, tw, pre, tmat, C, log_tc, (unsigned)(C >> log_tc));
    return ms_last_error();
}

MS_API int ms_col_ntt(const uint64_t* x, uint64_t* y, const uint64_t* tw,
                      const uint64_t* pre, const uint64_t* tmat, int64_t B,
                      int64_t n1, int64_t C, int64_t log_n1,
                      cudaStream_t stream) {
    if (B == 0 || C == 0) return ms_last_error();
    switch (log_n1) {
#define NTT_CASE(l) \
    case l: return col_ntt_launch<l>(x, y, tw, pre, tmat, B, C, stream);
        NTT_CASE(0) NTT_CASE(1) NTT_CASE(2) NTT_CASE(3) NTT_CASE(4)
        NTT_CASE(5) NTT_CASE(6) NTT_CASE(7) NTT_CASE(8) NTT_CASE(9)
        NTT_CASE(10) NTT_CASE(11) NTT_CASE(12) NTT_CASE(13) NTT_CASE(14)
#undef NTT_CASE
    }
    return (int)cudaErrorInvalidValue;
}

// The multi-pass column NTT for n1 above kernel B's tile (transforms of
// more than 2^28 points): a few stages a pass over device memory.
//
// Replaces ministark_tpu/ops/ntt_pallas.py `_col_ntt_kernel`, which runs
// one butterfly stage per grid step.  Same function as col_ntt_kernel: the
// bit-reversing gather (times pre), log2(n1) radix-2 DIT stages with
// twiddles tw[j * (n1 >> stage)], the output canonical (times tmat).
//
// Bound on the card: integer operations for the least work (a product and
// two adds a butterfly, log2(n1) stages), against one read and one write
// of every element.  A pass over device memory costs 16 bytes an element,
// so the design keeps the passes few: NTT_PASS_MAX_LOG = 8 stages a pass
// (ntt_pass.cuh), two passes up to n1 = 2^16 where one launch a stage made
// seventeen.  A block takes one group of 2^K positions of a pass for tc
// adjacent columns (row segments of tc * 8 bytes; up to 4096 values, 32 KB
// of exchange), gathers or loads them, runs the pass's K stages with kernel
// B's round schedule (ntt_sched.cuh: 16 values a thread, four stages a
// round in registers, lazy butterflies, the PTX product, a swizzled
// exchange), the group's twiddles in a shared-memory heap, and writes them
// back in place; the first pass fuses the gather and pre, the last folds
// tmat.  One instantiation per pass length K (and first pass or not) makes
// the register loops constant; positions are 32-bit shifts and masks, and
// a block decodes its group with one 32-bit division.
template <int K, bool FIRST>
__global__ void __launch_bounds__(512)
col_ntt_pass_kernel(const uint64_t* x, uint64_t* y,
                    const uint64_t* __restrict__ tw,
                    const uint64_t* __restrict__ pre,
                    const uint64_t* __restrict__ tmat, int64_t C, int L,
                    int a, bool last, int log_tc, unsigned col_blocks) {
    extern __shared__ uint64_t smem[];
    uint64_t* heap = smem;                 // 2^K slots, slot 0 unused
    uint64_t* tile = smem + (1 << K);      // 2^K * tc slots
    const int tc = 1 << log_tc;
    const unsigned q = blockIdx.x / col_blocks;  // (batch, group)
    const uint32_t g = q & ((1u << (L - K)) - 1);
    const int64_t b = q >> (L - K);
    const uint32_t f = threadIdx.x >> log_tc, cc = threadIdx.x & (tc - 1);
    const int64_t c = (int64_t)(blockIdx.x - q * col_blocks) * tc + cc;
    const int64_t off = (b << L) * C + c;

    uint64_t v[1 << ntt_rl(K)];
    if constexpr (FIRST)
        ntt_pass_gather<K>(v, x + off, pre ? pre + c : nullptr, f, C, L, g);
    else
        ntt_pass_load<K>(v, y + off, f, C, a, g);
    if constexpr (K > 0) {
        ntt_pass_heap(heap, tw, K, L, a, g, threadIdx.x + 1, blockDim.x);
        __syncthreads();
        run_rounds<K, 0, FIRST>(v, tile, f, cc, tc, PassTw{heap});
    }
    ntt_pass_store<K>(v, y + off, tmat ? tmat + c : nullptr, last, f, C, a,
                      g);
}

template <int K, bool FIRST>
static int col_ntt_pass_launch(const uint64_t* x, uint64_t* y,
                               const uint64_t* tw, const uint64_t* pre,
                               const uint64_t* tmat, int64_t B, int64_t C,
                               int L, int a, bool last, cudaStream_t stream) {
    constexpr int T = (1 << K) >> ntt_rl(K);  // threads a column
    int log_tc = 0;  // columns a block: the largest power of two dividing C
    while ((2 << log_tc) <= ntt_pass_tc_max(K) && C % (2LL << log_tc) == 0)
        log_tc++;
    const int64_t blocks = (C >> log_tc) * (B << (L - K));
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
    const size_t smem =
        ((size_t)(1 << K) + (ntt_rounds(K) > 1 ? (size_t)1 << (K + log_tc)
                                               : 0)) * 8;
    col_ntt_pass_kernel<K, FIRST><<<(unsigned)blocks, T << log_tc, smem,
                                    stream>>>(
        x, y, tw, pre, tmat, C, L, a, last, log_tc, (unsigned)(C >> log_tc));
    return ms_last_error();
}

// pass `pass` of the column transform: x (B, n1, C) -> y, in place on y
// after the first
MS_API int ms_col_ntt_pass(const uint64_t* x, uint64_t* y, const uint64_t* tw,
                           const uint64_t* pre, const uint64_t* tmat,
                           int64_t B, int64_t n1, int64_t C, int64_t log_n1,
                           int64_t pass, cudaStream_t stream) {
    const int L = (int)log_n1;
    if (B == 0 || C == 0) return ms_last_error();
    if (L < 0 || L > 30 || (1LL << L) != n1 || pass < 0 ||
        pass >= ntt_passes(L))
        return (int)cudaErrorInvalidValue;
    const int K = ntt_pass_len(L, (int)pass), a = ntt_pass_start(L, (int)pass);
    const bool last = pass == ntt_passes(L) - 1;
    switch (K * 2 + (pass == 0)) {
#define PASS_CASE(k)                                                         \
    case 2 * k + 1:                                                          \
        return col_ntt_pass_launch<k, true>(x, y, tw, pre, tmat, B, C, L, a, \
                                            last, stream);                   \
    case 2 * k:                                                              \
        return col_ntt_pass_launch<k, false>(x, y, tw, pre, tmat, B, C, L, a,\
                                             last, stream);
        PASS_CASE(0) PASS_CASE(1) PASS_CASE(2) PASS_CASE(3) PASS_CASE(4)
        PASS_CASE(5) PASS_CASE(6) PASS_CASE(7) PASS_CASE(8)
#undef PASS_CASE
    }
    return (int)cudaErrorInvalidValue;
}
