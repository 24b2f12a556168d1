// Plain C interface shared by every kernel library: each entry point
// launches on the caller's stream and returns cudaGetLastError() as an int,
// so a launch that is refused raises in the Python wrapper.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MS_API extern "C" __attribute__((visibility("default")))

static inline int ms_last_error() { return (int)cudaGetLastError(); }

static inline unsigned ms_blocks(int64_t n, int threads) {
    int64_t b = (n + threads - 1) / threads;
    if (b > 65535LL * 32) b = 65535LL * 32;  // grid-stride loops cover the rest
    return (unsigned)(b > 0 ? b : 1);
}

MS_API const char* ms_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
