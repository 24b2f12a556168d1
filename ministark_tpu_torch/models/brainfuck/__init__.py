"""BrainSTARK: a brainf**k VM prover (reference: examples/brainfuck/).

Five tables (processor / memory / instruction / input / output) share one
power-of-two trace length; cross-table permutation and evaluation arguments
bind them together (17 base + 9 extension columns over Fp / Fq3)."""

from .air import BrainfuckAirConfig, BrainfuckClaim
from .vm import compile_program, simulate
from .trace import BrainfuckTrace

__all__ = ["BrainfuckAirConfig", "BrainfuckClaim", "BrainfuckTrace",
           "compile_program", "simulate"]
