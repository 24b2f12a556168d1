"""Rescue-Prime model family: parameter generation (field-generic, incl. the
252-bit StarkWare field) and a hash-chain AIR over Goldilocks
(reference: examples/rescue/ — the reference AIR is an unfinished todo!())."""

from .air import RescueAirConfig, RescueClaim, RescueTrace, chain_digest, gen_trace, goldilocks_params
from .primitive import RescueParams

__all__ = ["RescueAirConfig", "RescueClaim", "RescueTrace", "RescueParams",
           "chain_digest", "gen_trace", "goldilocks_params"]
