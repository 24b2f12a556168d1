// Kernel F: the DEEP composition over the LDE domain, one fused pass.
//
// Replaces ministark_tpu/ops/deep_pallas.py `_group_kernel_base` and
// `_finish_kernel_base` (reached from composer.py's DEEP phase):
//
//   out[i] = (sum_t alpha_t * (ood_t - T_t[i]) * inv_t[i]) * (A + B * x[i])
//
// with inv_t = 1/(y_t - x) the barycentric inverses of term t's OOD point.
// Columns and inverse rows arrive as two device tables of pointers, the
// scalars as one table [ood_0, alpha_0, ood_1, alpha_1, ..., A, B].
//
// Bound on the card: memory traffic (two 8-byte reads and three field
// multiplies per term and point).  Design: one thread per LDE point sums
// every term in registers and writes once, where the TPU ran groups of 16
// terms through an accumulator in device memory.
#include "goldilocks.cuh"
#include "launch.cuh"

__global__ void deep_kernel(const uint64_t* const* __restrict__ cols,
                            const uint64_t* const* __restrict__ invs,
                            const uint64_t* __restrict__ s,
                            const uint64_t* __restrict__ x,
                            uint64_t* __restrict__ out, int64_t n, int64_t T) {
    const uint64_t A = s[2 * T], B = s[2 * T + 1];
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        uint64_t acc = 0;
        for (int64_t t = 0; t < T; t++) {
            uint64_t d = gl_sub(s[2 * t], cols[t][i]);
            acc = gl_add(acc, gl_mul(gl_mul(d, invs[t][i]), s[2 * t + 1]));
        }
        out[i] = gl_mul(acc, gl_add(A, gl_mul(B, x[i])));
    }
}

MS_API int ms_deep(const uint64_t* const* cols, const uint64_t* const* invs,
                   const uint64_t* s, const uint64_t* x, uint64_t* out,
                   int64_t n, int64_t T, cudaStream_t stream) {
    if (n > 0)
        deep_kernel<<<ms_blocks(n, 256), 256, 0, stream>>>(cols, invs, s, x,
                                                           out, n, T);
    return ms_last_error();
}
