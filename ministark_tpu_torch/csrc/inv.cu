// Kernel A: elementwise Goldilocks inverse, 0 -> 0; and its Fq3 twin.
//
// ms_inv_fp replaces ministark_tpu/ops/inv_pallas.py `_inv_fp_hybrid_kernel`
// (and its plain `_inv_fp_kernel`), reached from fields/device.py
// `batch_inv`.  ms_inv_ext3 replaces `_inv_ext3_kernel` (inv_pallas.py:72),
// reached from `ext3_batch_inv`: the DEEP phase's barycentric inverses
// 1/(y - x) at the Fq3 OOD points.
//
// Bound on the card: arithmetic.  Each element costs one Fermat chain,
// a^(p-2) by square-and-multiply (~64 squarings + ~63 multiplies of 64-bit
// Goldilocks products), against 16 bytes of traffic (48 for Fq3, whose norm
// map adds ~15 products to the one chain).  Design: one thread per element
// in a grid-stride loop, so the chain's latency hides behind many resident
// warps; the TPU kernel's K-group Montgomery trick (one shared chain per K
// elements) is left for a later change.
#include "goldilocks.cuh"
#include "launch.cuh"

__global__ void inv_fp_kernel(const uint64_t* __restrict__ in,
                              uint64_t* __restrict__ out, int64_t n) {
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x)
        out[i] = gl_inv(in[i]);
}

// in/out: B blocks of three component planes of n values, shape (B, 3, n).
__global__ void inv_ext3_kernel(const uint64_t* __restrict__ in,
                                uint64_t* __restrict__ out, int64_t B,
                                int64_t n) {
    for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
         e < B * n; e += (int64_t)gridDim.x * blockDim.x) {
        const int64_t b = e / n, i = e - b * n;
        gl3_store(out + 3 * n * b, i, n, gl3_inv(gl3_load(in + 3 * n * b, i, n)));
    }
}

MS_API int ms_inv_fp(const uint64_t* in, uint64_t* out, int64_t n,
                     cudaStream_t stream) {
    if (n > 0) inv_fp_kernel<<<ms_blocks(n, 256), 256, 0, stream>>>(in, out, n);
    return ms_last_error();
}

MS_API int ms_inv_ext3(const uint64_t* in, uint64_t* out, int64_t B, int64_t n,
                       cudaStream_t stream) {
    if (B * n > 0)
        inv_ext3_kernel<<<ms_blocks(B * n, 256), 256, 0, stream>>>(in, out, B,
                                                                   n);
    return ms_last_error();
}
