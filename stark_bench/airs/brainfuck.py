"""The BrainSTARK AIR: the measured program's entry layer and the plain
reference.

The traffic file gives the program, its input and the trace rows it must
run to.  The program runs its own VM and uploads the five tables
(``models.brainfuck``); the reference runs its own copy of the VM
(``plainstark.models.brainfuck``)."""

from __future__ import annotations

# the traffic file's keys this AIR reads
TRAFFIC = ("program", "input", "rows")


def _input(traffic) -> bytes:
    return traffic["input"].encode()


def _check_rows(rows, traffic):
    if rows != traffic["rows"]:
        raise ValueError(f"the program ran to {rows} rows, the traffic "
                         f"file says {traffic['rows']}")


def program(config, traffic, device):
    """(claim, witness, options, fq) of the measured program."""
    from ministark_tpu_torch.air import ProofOptions
    from ministark_tpu_torch.fields.scalar import Fq3
    from ministark_tpu_torch.models.brainfuck import (BrainfuckClaim,
                                                      BrainfuckTrace,
                                                      simulate)

    source = traffic["program"]
    tables, output = simulate(source, _input(traffic))
    _check_rows(tables["processor"].shape[0], traffic)
    return (BrainfuckClaim(source, _input(traffic), output),
            BrainfuckTrace(tables, device=device),
            ProofOptions(**config["options"]), Fq3)


def reference(config, traffic, device, options=None,
              phase_s: dict | None = None) -> bytes:
    """The reference's proof bytes at the configuration's options (or at
    `options`, a dict of them); `phase_s` receives its phases' seconds."""
    from plainstark.air import ProofOptions
    from plainstark.fields.scalar import Fq3
    from plainstark.models.brainfuck import (BrainfuckClaim, BrainfuckTrace,
                                             simulate)

    source = traffic["program"]
    tables, output = simulate(source, _input(traffic))
    _check_rows(tables["processor"].shape[0], traffic)
    opts = ProofOptions(**(options or config["options"]))
    claim = BrainfuckClaim(source, _input(traffic), output)
    return claim.prove(opts, BrainfuckTrace(tables, device),
                       phase_s).to_bytes(Fq3)
