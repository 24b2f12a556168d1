"""Device ms of the prover's "Constraint evaluation" phase (its CUDA
events, ``utils/timer.py``), the mean over the window's proves."""

from harness import phase_mean_ms


def read(r):
    return phase_mean_ms(r, "Constraint evaluation")
