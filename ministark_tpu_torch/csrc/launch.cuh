// Plain C interface shared by every kernel library: each entry point
// launches on the caller's stream and returns cudaGetLastError() as an int,
// so a launch that is refused raises in the Python wrapper.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MS_API extern "C" __attribute__((visibility("default")))

static inline int ms_last_error() { return (int)cudaGetLastError(); }

// Raise `kernel`'s dynamic shared-memory limit to `bytes` (where above the
// 48 KB default) on the current device, once a device: the attribute is the
// device's, so a process that launches on a second card sets it there too.
// `done`: the kernel's flags, one a device (a static array at the launch).
#define MS_MAX_DEVICES 64
template <class K>
static inline int ms_smem_limit(K* kernel, size_t bytes,
                                bool (&done)[MS_MAX_DEVICES]) {
    if (bytes <= 48 * 1024) return 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < MS_MAX_DEVICES && done[dev]) return 0;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    if (dev < MS_MAX_DEVICES) done[dev] = true;
    return 0;
}

static inline unsigned ms_blocks(int64_t n, int threads) {
    int64_t b = (n + threads - 1) / threads;
    if (b > 65535LL * 32) b = 65535LL * 32;  // grid-stride loops cover the rest
    return (unsigned)(b > 0 ? b : 1);
}

MS_API const char* ms_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
