"""The 128-bit STARK-Anatomy prime field (host scalar).

Parity with the reference's third field family (gpu/src/metal/felt_u128.h.metal:176-192):
modulus 1 + 407*2^119 = 270497897142230380135924736767050121217, from the
"Anatomy of a STARK" tutorial.  Two-adicity 119; multiplicative generator 3;
the canonical 2^119-th root of unity is 85408008396924667383611388730472331217
(matches the tutorial's primitive root).
"""

from __future__ import annotations

from .prime import make_prime_field

P128 = 1 + 407 * 2**119
GENERATOR128 = 3
TWO_ADICITY128 = 119
TWO_ADIC_ROOT128 = pow(GENERATOR128, (P128 - 1) >> TWO_ADICITY128, P128)

Fp128 = make_prime_field("Fp128", P128, GENERATOR128, 16)
