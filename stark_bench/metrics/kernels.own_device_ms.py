"""Device ms a prove of the hand-written kernels (``own_kernels``), from
the profiler's trace of the profiled proves."""


def read(r):
    if r.profile is None:
        return None
    return 1e3 * r.profile["own_s"] / r.profile["proves"]
