"""Hand-written kernel launches a prove: the program's counters
(``ops/build.py`` ``KERNELS[*].launches``) summed over the window and
divided by its proves."""


def read(r):
    if r.launches is None or not r.latencies:
        return None
    return r.launches / len(r.latencies)
