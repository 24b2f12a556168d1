// Kernel F: the DEEP composition over the LDE domain, one fused pass, over
// Fp (fib) or Fq3 (brainfuck) transcripts.
//
// ms_deep replaces ministark_tpu/ops/deep_pallas.py `_group_kernel_base`
// and `_finish_kernel_base`; ms_deep_ext3 replaces `_group_kernel_ext`
// (deep_pallas.py:64) and `_finish_kernel_ext` (:125).  Both are reached
// from composer.py's DEEP phase:
//
//   out[i] = (sum_t alpha_t * (ood_t - T_t[i]) * inv_t[i]) * (A + B * x[i])
//
// with inv_t = 1/(y_t - x) the barycentric inverses of term t's OOD point.
// Columns and inverse rows arrive as two device tables of pointers, the
// scalars as one table.  Fp: [ood_0, alpha_0, ood_1, alpha_1, ..., A, B].
// Fq3: three slots per scalar, [ood_0, alpha_0, ..., A, B], and a kind per
// term: 0 for a base-field column (ood - T subtracts in c0 only), 1 for an
// Fq3 column; Fq3 columns, inverse rows and the output are (3, n) planes.
//
// Bound on the card: integer operations (chip_smoke.py's model: ~60 32-bit
// instructions per Fp term and point, ~480 per Fq3 term, against 16-48
// bytes; the Fp sum sits near the memory line).  Design: one
// thread per LDE point sums every term in registers and writes once; the
// loop over terms is not unrolled, so its register use does not grow with
// the term count (the TPU kernel ran groups of 8 Fq3 terms through an
// accumulator in device memory to bound its program size).
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

__global__ void deep_ext3_kernel(const uint64_t* const* __restrict__ cols,
                                 const int64_t* __restrict__ kinds,
                                 const uint64_t* const* __restrict__ invs,
                                 const uint64_t* __restrict__ s,
                                 const uint64_t* __restrict__ x,
                                 uint64_t* __restrict__ out, int64_t n,
                                 int64_t T) {
    const gl3 A = gl3_load(s, 6 * T, 1), B = gl3_load(s, 6 * T + 3, 1);
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        gl3 acc = gl3_from_base(0);
        for (int64_t t = 0; t < T; t++) {
            const gl3 ood = gl3_load(s, 6 * t, 1);
            const gl3 d = kinds[t] ? gl3_sub(ood, gl3_load(cols[t], i, n))
                                   : gl3_sub_base(ood, cols[t][i]);
            const gl3 q = gl3_mul(d, gl3_load(invs[t], i, n));
            acc = gl3_add(acc, gl3_mul(q, gl3_load(s, 6 * t + 3, 1)));
        }
        gl3_store(out, i, n, gl3_mul(acc, gl3_add(A, gl3_mul_base(B, x[i]))));
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

MS_API int ms_deep_ext3(const uint64_t* const* cols, const int64_t* kinds,
                        const uint64_t* const* invs, const uint64_t* s,
                        const uint64_t* x, uint64_t* out, int64_t n, int64_t T,
                        cudaStream_t stream) {
    if (n > 0)
        deep_ext3_kernel<<<ms_blocks(n, 256), 256, 0, stream>>>(
            cols, kinds, invs, s, x, out, n, T);
    return ms_last_error();
}
