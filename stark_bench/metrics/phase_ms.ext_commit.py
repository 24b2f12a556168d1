"""Device ms of the prover's "Extension trace commitment" phase, the mean
over the window's proves; nothing for an AIR without extension columns."""

from harness import phase_mean_ms


def read(r):
    if not r.config.get("extension_columns"):
        return None
    return phase_mean_ms(r, "Extension trace commitment")
