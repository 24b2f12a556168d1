"""The fib AIR: the measured program's entry layer and the plain reference.

The chain runs from 1, 2 over 8 Goldilocks columns; the traffic file sets
the rows.  The program makes its trace with its own entry point
(``models.fib.gen_trace``); the reference works the trace out again from
the chain's closed form (``plainstark.models.fib``)."""

from __future__ import annotations

COLUMNS = 8
# the traffic file's keys this AIR reads
TRAFFIC = ("rows",)


def _check(config, traffic):
    if config["chain_start"] != [1, 2] or config["base_columns"] != COLUMNS:
        raise ValueError("the fib AIR runs the chain from 1, 2 over 8 "
                         "columns")
    rows = traffic["rows"]
    if rows < 2 or rows & (rows - 1):
        raise ValueError(f"rows must be a power of two, got {rows}")
    return rows


def program(config, traffic, device):
    """(claim, witness, options, fq) of the measured program."""
    from ministark_tpu_torch.air import ProofOptions
    from ministark_tpu_torch.fields.scalar import Fp
    from ministark_tpu_torch.models.fib import FibClaim, gen_trace

    trace = gen_trace(_check(config, traffic) * COLUMNS, device=device)
    return (FibClaim(trace.last_value()), trace,
            ProofOptions(**config["options"]), Fp)


def reference(config, traffic, device, options=None,
              phase_s: dict | None = None) -> bytes:
    """The reference's proof bytes at the configuration's options (or at
    `options`, a dict of them); `phase_s` receives its phases' seconds."""
    from plainstark.air import ProofOptions
    from plainstark.fields.scalar import Fp
    from plainstark.models.fib import FibClaim, gen_trace

    trace = gen_trace(_check(config, traffic) * COLUMNS, device)
    opts = ProofOptions(**(options or config["options"]))
    return FibClaim(trace.last_value()).prove(opts, trace, phase_s).to_bytes(Fp)
