"""Device ms a prove of the libraries' device operations (``own_kernels``:
PyTorch's, CUB, thrust, NCCL, copies and fills), from the profiler's
trace of the profiled proves."""


def read(r):
    if r.profile is None:
        return None
    return 1e3 * r.profile["plain_s"] / r.profile["proves"]
