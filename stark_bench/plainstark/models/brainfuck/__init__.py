"""The BrainSTARK AIR and VM (17 base, 9 Fq3 extension columns)."""

from .air import BrainfuckAirConfig, BrainfuckClaim
from .trace import BrainfuckTrace
from .vm import simulate

__all__ = ["BrainfuckAirConfig", "BrainfuckClaim", "BrainfuckTrace",
           "simulate"]
