"""Top-level `Stark` API (reference: src/stark.rs).

A concrete proof system subclasses `Stark` and provides:
  * ``air_config`` — class with the AirConfig surface (see air.Air docs);
  * ``fp`` / ``fq`` — scalar field classes (Fp, and Fp or Fq3);
  * ``get_public_inputs()``;
  * ``generate_trace(witness) -> Trace``;
  * optionally ``gen_public_coin(air)`` (default: SHA-256 of
    serialize(public_inputs) || trace_len || options, the pattern every
    reference example uses, examples/fib/main.rs:166-172).
"""

from __future__ import annotations

from . import hash as H
from . import serde
from .air import Air, ProofOptions
from .composer import DeepCompositionCoeffs
from .fields.scalar import Fp
from .random import PublicCoin


class Trace:
    """Execution trace: base columns (+ optional extension columns built from
    challenges)  (reference: src/trace.rs:15-36)."""

    def base_columns(self):
        raise NotImplementedError

    def build_extension_columns(self, challenges):
        return None

    def __len__(self):
        return self.base_columns().num_rows


class Stark:
    air_config = None
    fp = Fp
    fq = Fp

    # -- user hooks ----------------------------------------------------------

    def get_public_inputs(self):
        raise NotImplementedError

    def generate_trace(self, witness) -> Trace:
        raise NotImplementedError

    def serialize_public_inputs(self, w: serde.Writer):
        """Override to match the reference's public-input serialization."""
        pi = self.get_public_inputs()
        if hasattr(pi, "to_bytes"):
            w.raw(pi.to_bytes())
        else:
            raise NotImplementedError("serialize_public_inputs")

    def gen_public_coin(self, air: Air) -> PublicCoin:
        w = serde.Writer()
        self.serialize_public_inputs(w)
        w.usize(air.trace_len)
        air.options.serialize(w)
        return PublicCoin(H.sha256(w.bytes()), field=self.fq)

    # -- provided ------------------------------------------------------------

    def gen_deep_coeffs(self, public_coin: PublicCoin, air: Air) -> DeepCompositionCoeffs:
        """One alpha per trace argument + per composition column + the degree
        pair (src/stark.rs:41-53)."""
        num_execution = len(air.trace_arguments())
        num_composition = air.ce_blowup_factor
        return DeepCompositionCoeffs(
            execution_trace=public_coin.draw_multiple(num_execution),
            composition_trace=public_coin.draw_multiple(num_composition),
            degree=(public_coin.draw(), public_coin.draw()),
        )

    def build_air(self, trace_len: int, options: ProofOptions) -> Air:
        return Air(self.air_config, trace_len, self.get_public_inputs(), options)

    def prove(self, options: ProofOptions, witness,
              phase_s: dict | None = None):
        from .prover import default_prove
        return default_prove(self, options, witness, phase_s)
