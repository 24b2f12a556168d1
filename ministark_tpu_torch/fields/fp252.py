"""The 252-bit StarkWare/Cairo prime field (host scalar).

Parity with the reference's second field family (gpu/src/fields.rs:239-268,
gpu/src/metal/felt_u256.h.metal): modulus 2^251 + 17*2^192 + 1, generator 3.
Device (16-bit-limb Montgomery vector) support lives in fields/bigvec.py
(``Fp252Vec``); the protocol layer is field-generic at the scalar level."""

from __future__ import annotations

from .prime import make_prime_field

P252 = 2**251 + 17 * 2**192 + 1
GENERATOR252 = 3
TWO_ADICITY252 = 192
TWO_ADIC_ROOT252 = pow(GENERATOR252, (P252 - 1) >> TWO_ADICITY252, P252)

Fp252 = make_prime_field("Fp252", P252, GENERATOR252, 32)
