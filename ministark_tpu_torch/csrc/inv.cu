// Kernel A: batched Goldilocks inverses, 0 -> 0, in Fp and in Fq3.
//
// ms_inv_fp replaces ministark_tpu/ops/inv_pallas.py `_inv_fp_hybrid_kernel`
// (and its plain `_inv_fp_kernel`, which only serves tiles that do not
// divide: here one kernel takes any length), reached from fields/device.py
// `batch_inv`.  ms_inv_ext3 replaces `_inv_ext3_kernel` (inv_pallas.py:72),
// reached from `ext3_batch_inv`: the DEEP phase's barycentric inverses
// 1/(y - x) at the Fq3 OOD points and the constraint evaluation's Fq3
// denominators.
//
// Bound on the card: 32-bit integer instructions.  An inverse on its own
// is a Fermat chain of 73 Goldilocks products against 16 bytes of traffic
// (48 for Fq3), about 90 operations a byte where the card does five.  The
// design is the TPU kernel's: Montgomery's trick (inv_batch.cuh) lets K
// elements share one chain, at three products an element, so a thread
// spends 3 + 73 / K products an inverse (Fq3: the norm map's 12 more).
//  - A block of T threads takes a tile of K T elements; thread t's k-th
//    element is tile + k T + t, so each of the K loads and stores is
//    coalesced across the warp.  The last tile is padded with 1s.
//  - The group stays in registers between the forward and the backward
//    pass (KEEP), or the backward pass reads it again (L1 or L2).
//  - The chain is an addition chain (goldilocks.cuh gl_inv_chain); every
//    product is the PTX carry-chain one, and the prefix products and the
//    chain skip the final reduction to [0, p) (gl_mul_cc_lazy).
// K, KEEP and T are template parameters.  Timed in turns on an H100
// (scripts/ab_kernels.py --inv-variants): Fp runs fastest at K = 16,
// reading the group again, 256 threads (80 registers); K = 32 keeps too
// many registers, K = 8 runs the chain twice as often.  Fq3 at K = 8,
// keeping the adjugates and norms (112 registers): reading again costs the
// adjugate's nine products twice, K = 16 leaves too few warps.
// scripts/ptxas_report.py shows registers and spills.
#include "inv_batch.cuh"
#include "launch.cuh"

template <int K, bool KEEP, int T, class Mul>
__global__ void __launch_bounds__(T)
    inv_fp_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                  int64_t n, int64_t tiles) {
    for (int64_t j = blockIdx.x; j < tiles; j += gridDim.x)
        inv_fp_thread<K, KEEP>(in, out, n, j, threadIdx.x, T, Mul());
}

template <int K, bool KEEP, int T, class Mul>
__global__ void __launch_bounds__(T)
    inv_ext3_kernel(const uint64_t* __restrict__ in,
                    uint64_t* __restrict__ out, int64_t n, int64_t total,
                    int64_t tiles) {
    for (int64_t j = blockIdx.x; j < tiles; j += gridDim.x)
        inv_ext3_thread<K, KEEP>(in, out, n, total, j, threadIdx.x, T, Mul());
}

template <int K, bool KEEP, int T, class Mul>
static int launch_inv_fp(const uint64_t* in, uint64_t* out, int64_t n,
                         cudaStream_t stream) {
    if (n > 0) {
        const int64_t tiles = (n + K * T - 1) / (K * T);
        inv_fp_kernel<K, KEEP, T, Mul>
            <<<ms_blocks(tiles, 1), T, 0, stream>>>(in, out, n, tiles);
    }
    return ms_last_error();
}

template <int K, bool KEEP, int T, class Mul>
static int launch_inv_ext3(const uint64_t* in, uint64_t* out, int64_t B,
                           int64_t n, cudaStream_t stream) {
    if (B * n > 0) {
        const int64_t tiles = (B * n + K * T - 1) / (K * T);
        inv_ext3_kernel<K, KEEP, T, Mul>
            <<<ms_blocks(tiles, 1), T, 0, stream>>>(in, out, n, B * n,
                                                    tiles);
    }
    return ms_last_error();
}

MS_API int ms_inv_fp(const uint64_t* in, uint64_t* out, int64_t n,
                     cudaStream_t stream) {
    return launch_inv_fp<16, false, 256, gl_mul_cc_fn>(in, out, n, stream);
}

// in/out: B blocks of three component planes of n values, shape (B, 3, n)
MS_API int ms_inv_ext3(const uint64_t* in, uint64_t* out, int64_t B, int64_t n,
                       cudaStream_t stream) {
    return launch_inv_ext3<8, true, 256, gl_mul_cc_fn>(in, out, B, n, stream);
}
