"""Percent of the profiled proves' wall time in which no operation ran on
the device: 100 * (1 - the union of the device intervals / the wall).
The profiler slows the host, so this reads higher than an untraced run
would."""


def read(r):
    if r.profile is None or r.profile["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - r.profile["busy_s"] / r.profile["wall_s"])
